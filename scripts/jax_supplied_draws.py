"""Chosen uniforms for JAX's fused Pallas kernel in interpret mode, on the CPU.

The Mosaic TPU interpreter of the JAX installed here returns zeros for
`pltpu.prng_random_bits` (tests/test_torch_interpret_draws.py), so the MC
modes of gnina_tpu/ops/pallas_dock.py's kernel see every uniform as 0 and
do no search.  `supplied_draws` swaps the module attribute
`gnina_tpu.ops.pallas_dock.pltpu` for a proxy, for the time of a `with`
block, in this process only:

- every attribute but the two PRNG primitives is the real module's
  (`SMEM`, `VMEM`, `InterpretParams`, ...);
- `prng_random_bits(shape)` is an ordered `io_callback` that returns the
  next (1, LB) slab of uniforms (the next `rows` slabs for a (rows, LB)
  draw) as int32 bits round(u * 2^24) << 8, which
  `pallas_dock.u01_from_bits` turns back into exactly u;
- `prng_seed` seeds nothing: it marks the start of a kernel block (the
  kernel calls it once a block, before any draw), where the feed moves on
  to the next supplied buffer.

The source is either a sequence of float32 buffers (draws, 13, L), one for
each kernel block run in execution order (one MC window of L <= 128 lanes
each), whose slab (d, j) is row j of draw d -- the port's layout of a
window's uniforms, `uniforms[k, 0:12]` for the mutation and `[k, 12]` for
Metropolis (gnina_tpu_torch/ops/fused_dock.py) -- or a numpy Generator,
from which every slab is drawn afresh.  Lanes L..127 of a buffer's block
draw from a generator of their own.  A buffer run past its end raises, as
does a block beyond the last buffer: nothing wraps around.  Draw the
buffers with `uniforms` (values k / 2^24), so that both packages see the
same float32 uniforms.

Build the JAX `FusedBfgs` (or call `DockingEngine.dock_batch`) inside the
block: the kernel reads `pltpu` when it is traced, at its first call.

    with supplied_draws([u0, u1]) as feed:     # u: (draws, 13, 8) float32
        fused = pallas_dock.FusedBfgs(..., mc_steps=8, async_mc=True)
        out = fused.run_mc(...)
    feed.served                                 # slabs served per block

The port never imports this module; it imports JAX and gnina_tpu only.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import io_callback

from gnina_tpu.ops import pallas_dock

ROWS = 13           # uniforms a lane draws per tick (async) or step (lockstep)
SCALE = 1 << 24     # u01_from_bits keeps 24 bits
PAD_SEED = 0        # the generator of lanes L..127 of a buffer's block


def uniforms(rng: np.random.Generator, shape) -> np.ndarray:
    """Seeded uniforms on the kernel's grid: k / 2^24, k uniform in
    [0, 2^24)."""
    return (rng.integers(0, SCALE, size=shape) / SCALE).astype(np.float32)


def to_bits(u: np.ndarray) -> np.ndarray:
    """Uniforms on the grid -> the int32 words `u01_from_bits` maps back
    onto them."""
    k = np.rint(np.asarray(u, np.float64) * SCALE).astype(np.uint32)
    return (k << np.uint32(8)).view(np.int32)


class Feed:
    """The proxy's state: where the next slab comes from."""

    def __init__(self, source: Union[np.random.Generator,
                                     Sequence[np.ndarray]]):
        self.rng = source if isinstance(source, np.random.Generator) else None
        self.buffers = None
        if self.rng is None:
            self.buffers = [np.asarray(b, np.float32) for b in source]
            for b in self.buffers:
                if b.ndim != 3 or b.shape[1] != ROWS \
                        or b.shape[2] > pallas_dock.LB:
                    raise ValueError(f"a buffer is (draws, {ROWS}, L <= "
                                     f"{pallas_dock.LB}), not {b.shape}")
        self.pad = np.random.default_rng(PAD_SEED)
        self.block = -1          # index of the block being fed
        self.pos = 0             # slabs served to it
        self.served = []         # slabs served per block

    def start_block(self):
        self.block += 1
        self.pos = 0
        self.served.append(0)
        if self.buffers is not None and self.block >= len(self.buffers):
            raise RuntimeError(f"kernel block {self.block} has no supplied "
                               f"buffer ({len(self.buffers)} given)")

    def next_bits(self, shape) -> np.ndarray:
        """The next draw of `shape` = (rows, LB): that many slabs, in
        order, as int32 bits."""
        if self.block < 0:
            raise RuntimeError("a draw before prng_seed")
        rows, width = shape
        if width != pallas_dock.LB:
            raise ValueError(f"draws are (rows, {pallas_dock.LB}), not "
                             f"{tuple(shape)}")
        u = uniforms(self.rng if self.rng is not None else self.pad, shape)
        if self.buffers is not None:
            buf = self.buffers[self.block]
            for r in range(rows):
                d, j = divmod(self.pos + r, ROWS)
                if d >= buf.shape[0]:
                    raise RuntimeError(
                        f"block {self.block} drew past the end of its "
                        f"buffer ({buf.shape[0]} draws of {ROWS} uniforms)")
                u[r, :buf.shape[2]] = buf[d, j]
        self.pos += rows
        self.served[-1] += rows
        return to_bits(u)


class _Proxy:
    """`pltpu` with the PRNG primitives replaced."""

    def __init__(self, real, feed: Feed):
        self._real = real
        self._feed = feed

    def __getattr__(self, name):
        return getattr(self._real, name)

    def prng_seed(self, *seeds):
        del seeds

        def mark():
            self._feed.start_block()
            return np.zeros((), np.int32)

        io_callback(mark, jax.ShapeDtypeStruct((), jnp.int32), ordered=True)

    def prng_random_bits(self, shape):
        shape = tuple(int(s) for s in shape)
        return io_callback(lambda: self._feed.next_bits(shape),
                           jax.ShapeDtypeStruct(shape, jnp.int32),
                           ordered=True)


@contextlib.contextmanager
def supplied_draws(source):
    """For the `with` block, JAX's fused kernel draws from `source` (a
    sequence of (draws, 13, L) float32 buffers, one a kernel block, or a
    numpy Generator).  Yields the Feed (its `served` counts slabs per
    block)."""
    feed = Feed(source)
    real = pallas_dock.pltpu
    pallas_dock.pltpu = _Proxy(real, feed)
    try:
        yield feed
    finally:
        pallas_dock.pltpu = real
