"""Primitive-rate probes: what the card does per pair term, per row gather
and per one-hot contraction.

Counterpart of scripts/tpu_pallas_probe.py, whose three Pallas kernels
measure the same rates on a TPU:

  K9  `probe_pairs`        exact vina-style pair-term rate, float32 and
                           bfloat16 (probe_pairs :104, body :48-101)
  K10 `probe_gather_loop`  per-lookup row-gather rate from a resident table
                           (probe_gather_loop :126)
  K11 `probe_mxu`          one-hot bfloat16 contraction rate on the tensor
                           cores (probe_mxu :163)

Each is a hand-written CUDA kernel in csrc/probes.cu and a plain PyTorch
version here that computes the same scalar: the checksum of `reps`
repetitions, which the TPU kernel writes to out_ref[0, 0].  A wrapper takes
the plain version only for CPU tensors; for CUDA tensors it launches the
kernel or raises.  Every kernel launch adds one to its wrapper's `launches`:
one a call, whose block 0 adds the other blocks' sums once they have
landed.  pairs_plan and gather_plan make K9's and K10's launch geometry,
which the wrappers pass to the kernels and the CPU tests check.

    python -m gnina_tpu_torch.probes [--device cpu]

prints the card's name and power limit and one JSON line per probe with
`us_per_eval` and `ns_per_unit`.  Sizes come from the environment, as in the
TPU script: PROBE_L (128 lanes), PROBE_N (32 ligand atoms), PROBE_K (1280
receptor atoms), PROBE_REPS (20), PROBE_WHICH (pairs,pairs16,gather,mxu).
Inputs are made from a seed with numpy.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from typing import Dict

import numpy as np
import torch

from gnina_tpu_torch.device import resolve_device

GATHER_ROWS = 16384   # rows of the gather table (R)
MXU_KDIM = 896        # depth of the one-hot contraction
ROW_WIDTH = 128       # width of a table row and of g
# deepest g K11 takes: a block holds one 64-column half of g in shared
# memory (kdim x 128 B of the card's 227 KB)
MXU_KMAX = 1792
# kernel launches of one probe call (csrc/probes.cu): each block leaves a
# partial sum in its slot and block 0 adds them in a fixed order
LAUNCHES_PER_CALL = 1
# K9's tile (K9_THREADS, K9_LT, K9_KT in csrc/probes.cu, which refuses a
# grid made for another): threads a block, lanes and receptor atoms a
# thread; the ligand atoms split into PAIRS_SPLITS ranges, more where one
# range would overflow the block's 48 KB of shared memory
PAIRS_THREADS, PAIRS_LT, PAIRS_KT, PAIRS_SPLITS = 128, 2, 2, 4
PAIRS_ATOMS_MAX = 1024        # ligand atoms a block stages (48 B each)
# K10_THREADS, K10_UNITS: threads a block, (lookup, rep) units a thread
GATHER_THREADS, GATHER_UNITS = 128, 5


# --------------------------------------------------------------------------
# inputs
# --------------------------------------------------------------------------

def make_inputs(seed: int, lanes: int, n: int, k: int,
                device=None) -> Dict[str, torch.Tensor]:
    """The probes' inputs, with the TPU script's shapes and distributions:
    lig (3N, L), ligp (8, N), rec (K, 4), recp (K, 4); idx (A,), cells
    (R, 128), w (A, 8); tgt (A, 1), g (896, 128) bfloat16; A = N * L."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    a = n * lanes

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(device).contiguous()

    f32 = np.float32
    return {
        "lig": t((rng.standard_normal((3 * n, lanes)) * 5.0).astype(f32)),
        "ligp": t(np.abs(rng.standard_normal((8, n))).astype(f32)),
        "rec": t((rng.standard_normal((k, 4)) * 8.0).astype(f32)),
        "recp": t(np.abs(rng.standard_normal((k, 4))).astype(f32)),
        "idx": t(rng.integers(0, GATHER_ROWS, (a,)).astype(np.int32)),
        "cells": t(rng.standard_normal((GATHER_ROWS, ROW_WIDTH)).astype(f32)),
        "w": t(rng.random((a, 8)).astype(f32)),
        "tgt": t(rng.integers(0, MXU_KDIM - 1, (a, 1)).astype(np.int32)),
        "g": t(rng.standard_normal((MXU_KDIM, ROW_WIDTH)).astype(f32),
               ).to(torch.bfloat16),
    }


# --------------------------------------------------------------------------
# K9's and K10's launch geometry
# --------------------------------------------------------------------------

def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pairs_plan(lanes: int, n: int, k: int) -> Dict[str, object]:
    """K9's grid: x over the receptor (PAIRS_THREADS x PAIRS_KT atoms a
    block), y over the lanes (PAIRS_LT a block), z over the ligand atoms
    (`atoms` a block).  Thread t of block (x, y, z) holds receptor atoms
    (x * PAIRS_KT + j) * PAIRS_THREADS + t, j < PAIRS_KT, against lanes
    y * PAIRS_LT + i, i < PAIRS_LT, for atoms z * atoms + (0, 1, ...);
    receptor atoms and lanes past the ends are padding whose energy is
    exactly 0."""
    if min(lanes, n, k) < 1:
        raise ValueError(f"probe_pairs: empty shape L={lanes} N={n} K={k}")
    splits = max(min(PAIRS_SPLITS, n), _cdiv(n, PAIRS_ATOMS_MAX))
    atoms = _cdiv(n, splits)
    grid = (_cdiv(k, PAIRS_THREADS * PAIRS_KT), _cdiv(lanes, PAIRS_LT),
            _cdiv(n, atoms))
    return {"grid": grid, "threads": PAIRS_THREADS, "atoms": atoms,
            "blocks": grid[0] * grid[1] * grid[2]}


def gather_plan(a: int, reps: int) -> Dict[str, int]:
    """K10's grid: the units u = rep * a + lookup dealt to the grid's
    threads in GATHER_UNITS turns (thread g takes g + k * threads, k <
    GATHER_UNITS), GATHER_THREADS a block; a unit past a * reps loads
    nothing."""
    if a < 1 or reps < 1:
        raise ValueError(f"probe_gather_loop: {a} lookups x {reps} reps")
    units = a * reps
    if units > 2 ** 31 - 1:
        raise ValueError(f"probe_gather_loop: {units} units overflow int32")
    blocks = _cdiv(units, GATHER_THREADS * GATHER_UNITS)
    return {"blocks": blocks, "threads": GATHER_THREADS, "units": units}


# --------------------------------------------------------------------------
# plain PyTorch versions
# --------------------------------------------------------------------------

def pair_energies(lig, ligp, rec, recp, dtype=torch.float32):
    """The probe's pair energies e (N, K, L) in `dtype` (:69-89): two
    gaussians, repulsion, hydrophobic and hydrogen-bond ramps of the surface
    distance, zero beyond 8 A.  Constants are rounded to `dtype` first, as
    the TPU kernel's weakly typed scalars are."""
    n = ligp.shape[1]

    def c(x):
        return torch.tensor(x, dtype=dtype, device=lig.device)

    ax, ay, az = (lig[i * n:(i + 1) * n].to(dtype)[:, None, :]
                  for i in range(3))                       # (N, 1, L)
    recx, recy, recz, recr = (rec[:, i].to(dtype)[None, :, None]
                              for i in range(4))           # (1, K, 1)
    rphi, rdon, racc = (recp[:, i].to(dtype)[None, :, None]
                        for i in range(3))
    lp = [ligp[i].to(dtype)[:, None, None] for i in range(4)]   # (N, 1, 1)
    dx, dy, dz = recx - ax, recy - ay, recz - az
    r2 = dx * dx + dy * dy + dz * dz
    r = torch.sqrt(r2)
    d = r - (recr + lp[0])
    g1 = torch.exp(c(-4.0) * d * d)
    dd = (d - c(3.0)) * c(0.5)
    g2 = torch.exp(-dd * dd)
    zero = c(0.0)
    rep = torch.where(d < zero, d * d, zero)
    hyd = torch.clamp(-d * c(1.4285715) - c(0.5), 0.0, 1.0) * (lp[1] * rphi)
    hb = (torch.clamp(-d * c(1.4285715) - c(0.42857143), 0.0, 1.0)
          * (lp[2] * racc + lp[3] * rdon))
    e = (c(-0.0356) * g1 - c(0.00516) * g2 + c(0.84) * rep
         - c(0.0351) * hyd - c(0.587) * hb)
    return torch.where(r2 < c(64.0), e, zero)


def _carry_sum(eval_once, reps: int, device):
    """carry = 0; carry += eval_once() `reps` times, in float32 (the TPU
    kernels' outer fori_loop)."""
    carry = torch.zeros((), dtype=torch.float32, device=device)
    for _ in range(reps):
        carry = carry + eval_once()
    return carry


def probe_pairs_plain(lig, ligp, rec, recp, reps: int,
                      dtype=torch.float32):
    """K9, plain: for each repetition the sum over N atoms x K receptor
    atoms x L lanes of the pair energy, the arithmetic in `dtype`, the
    energies summed in float32 (as the kernel sums them)."""
    return _carry_sum(
        lambda: pair_energies(lig, ligp, rec, recp, dtype).float().sum(),
        reps, lig.device)


def probe_gather_loop_plain(idx, cells, w, reps: int):
    """K10, plain: A lookups per repetition, each the dot of the first 8
    values of row idx[a] of cells (R, 128) with w[a, :8]."""
    return _carry_sum(lambda: (cells[idx.long(), :8] * w).sum(), reps,
                      cells.device)


def probe_mxu_plain(tgt, g, reps: int):
    """K11, plain: a bfloat16 one-hot (A, 896) of tgt (A, 1) times g
    (896, 128) through torch.matmul, summed in float32."""
    kdim = g.shape[0]

    def once():
        ii = torch.arange(kdim, device=g.device, dtype=torch.int32)[None, :]
        onehot = (ii == tgt).to(torch.bfloat16)
        return torch.matmul(onehot, g).float().sum()

    return _carry_sum(once, reps, g.device)


# --------------------------------------------------------------------------
# CUDA kernels (csrc/probes.cu), bound with ctypes
# --------------------------------------------------------------------------

def _check(t, name, shape, dtype, device):
    if (not torch.is_tensor(t) or t.device != device or t.dtype != dtype
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} tensor of "
                         f"shape {tuple(shape)} on {device}")


def _finish(code: int, name: str, out):
    if code != 0:
        from gnina_tpu_torch.ops import _cuda

        msg = _cuda.probes_lib().gt_probe_error_string(int(code)).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
    return out[0]


def _p(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


_SLOTS: Dict[torch.device, tuple] = {}


def _slots(dev, blocks: int):
    """The device's block slots (int64: a block's partial sum and the number
    of the launch that wrote it), zeroed once, and a new launch number.
    Launches that share the slots run in the order of one stream."""
    buf, epoch = _SLOTS.get(dev, (None, 0))
    if buf is None or buf.numel() < blocks:
        buf = torch.zeros(max(blocks, 1024), dtype=torch.int64, device=dev)
    epoch = epoch % 0xFFFFFFFF + 1
    _SLOTS[dev] = (buf, epoch)
    return buf, epoch


def _launch_pairs(lig, ligp, rec, recp, reps, dtype=torch.float32):
    from gnina_tpu_torch.ops import _cuda

    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"probe_pairs: dtype {dtype}")
    dev = lig.device
    n, k, lanes = ligp.shape[1], rec.shape[0], lig.shape[1]
    _check(lig, "lig", (3 * n, lanes), torch.float32, dev)
    _check(ligp, "ligp", (8, n), torch.float32, dev)
    _check(rec, "rec", (k, 4), torch.float32, dev)
    _check(recp, "recp", (k, 4), torch.float32, dev)
    plan = pairs_plan(lanes, n, k)
    slots, epoch = _slots(dev, plan["blocks"])
    out = torch.empty(1, dtype=torch.float32, device=dev)
    code = _cuda.probes_lib().gt_probe_pairs(
        _p(lig), _p(ligp), _p(rec), _p(recp), lanes, n, k, int(reps),
        int(dtype == torch.bfloat16), *plan["grid"], plan["atoms"],
        _p(slots), epoch, _p(out), _stream())
    return _finish(code, "probe_pairs", out)


def _launch_gather(idx, cells, w, reps):
    from gnina_tpu_torch.ops import _cuda

    dev = cells.device
    a = idx.shape[0]
    _check(idx, "idx", (a,), torch.int32, dev)
    _check(cells, "cells", (cells.shape[0], ROW_WIDTH), torch.float32, dev)
    _check(w, "w", (a, 8), torch.float32, dev)
    plan = gather_plan(a, int(reps))
    slots, epoch = _slots(dev, plan["blocks"])
    out = torch.empty(1, dtype=torch.float32, device=dev)
    code = _cuda.probes_lib().gt_probe_gather(
        _p(idx), _p(cells), _p(w), a, int(reps), plan["blocks"], _p(slots),
        epoch, _p(out), _stream())
    return _finish(code, "probe_gather_loop", out)


def launch_empty(blocks: int, threads: int) -> None:
    """An empty kernel on the current stream, `blocks` x `threads`: the
    floor under K10's time (not a probe; no count)."""
    from gnina_tpu_torch.ops import _cuda

    code = _cuda.probes_lib().gt_probe_empty(int(blocks), int(threads),
                                             _stream())
    _finish(code, "empty kernel", [None])


def _launch_mxu(tgt, g, reps):
    from gnina_tpu_torch.ops import _cuda

    dev = g.device
    a, kdim = tgt.shape[0], g.shape[0]
    if a % 64 or kdim % 16 or not 0 < kdim <= MXU_KMAX or a == 0:
        raise ValueError(f"probe_mxu: {a} rows must be a positive multiple "
                         f"of 64 and depth {kdim} a multiple of 16 in (0, "
                         f"{MXU_KMAX}]")
    _check(tgt, "tgt", (a, 1), torch.int32, dev)
    _check(g, "g", (kdim, ROW_WIDTH), torch.bfloat16, dev)
    # one slot per block: 64 rows and one 64-column half
    slots, epoch = _slots(dev, a // 32)
    out = torch.empty(1, dtype=torch.float32, device=dev)
    code = _cuda.probes_lib().gt_probe_mxu(
        _p(tgt), _p(g), a, kdim, int(reps), _p(slots), epoch, _p(out),
        _stream())
    return _finish(code, "probe_mxu", out)


class _Probe:
    """A probe's entry point: plain version on CPU tensors, the CUDA kernel
    on CUDA tensors.  `launches` counts kernel launches only,
    LAUNCHES_PER_CALL a call; `calls` counts the calls that launched."""

    def __init__(self, name, plain, launch):
        self.name = name
        self.plain = plain
        self._launch = launch
        self.reset()

    def reset(self):
        self.launches = 0
        self.calls = 0

    def __call__(self, first, *args, **kw):
        if first.device.type == "cpu":
            return self.plain(first, *args, **kw)
        if first.device.type != "cuda":
            raise ValueError(f"{self.name}: unsupported device "
                             f"{first.device}")
        out = self._launch(first, *args, **kw)
        self.launches += LAUNCHES_PER_CALL
        self.calls += 1
        return out


# K9: probe_pairs(lig, ligp, rec, recp, reps, dtype=torch.float32)
probe_pairs = _Probe("probe_pairs", probe_pairs_plain, _launch_pairs)
# K10: probe_gather_loop(idx, cells, w, reps)
probe_gather_loop = _Probe("probe_gather_loop", probe_gather_loop_plain,
                           _launch_gather)
# K11: probe_mxu(tgt, g, reps)
probe_mxu = _Probe("probe_mxu", probe_mxu_plain, _launch_mxu)

PROBES = (probe_pairs, probe_gather_loop, probe_mxu)


# --------------------------------------------------------------------------
# the script
# --------------------------------------------------------------------------

def _time_ms(fn, device) -> float:
    """One warm call, then one timed call: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end)
    import time

    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(device=None, out=sys.stdout) -> None:
    device = resolve_device(device)
    lanes = int(os.environ.get("PROBE_L", "128"))
    n = int(os.environ.get("PROBE_N", "32"))
    k = int(os.environ.get("PROBE_K", "1280"))
    reps = int(os.environ.get("PROBE_REPS", "20"))
    which = os.environ.get("PROBE_WHICH", "pairs,pairs16,gather,mxu")
    x = make_inputs(0, lanes, n, k, device)
    a = n * lanes
    print(card_line() if device.type == "cuda" else f"{device} (no card)",
          file=out)

    def bench(name, fn, work_units):
        per = _time_ms(fn, device) * 1e-3 / reps
        print(json.dumps({
            "probe": name, "us_per_eval": round(per * 1e6, 1),
            "ns_per_unit": round(per * 1e9 / work_units, 3),
            "device": str(device)}), file=out)

    pair_args = (x["lig"], x["ligp"], x["rec"], x["recp"], reps)
    if "pairs" in which:
        bench("pairs_f32", lambda: probe_pairs(*pair_args), n * lanes * k)
    if "pairs16" in which:
        bench("pairs_bf16",
              lambda: probe_pairs(*pair_args, dtype=torch.bfloat16),
              n * lanes * k)
    if "gather" in which:
        bench("gather_loop",
              lambda: probe_gather_loop(x["idx"], x["cells"], x["w"], reps),
              a)
    if "mxu" in which:
        bench("mxu_onehot", lambda: probe_mxu(x["tgt"], x["g"], reps), a)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gnina_tpu_torch.probes", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without)")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
