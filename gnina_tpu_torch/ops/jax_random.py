"""A replay of JAX 0.9.0's default random numbers, in numpy and torch.

jax.random's default generator is threefry2x32 (Salmon et al., "Parallel
random numbers: as easy as 1, 2, 3", SC 2011), a counter-based hash: the
numbers are a pure function of the key and the position, so they can be
computed anywhere.  This module computes the few draws the port must match
bit for bit or to the float32 ulp:

- PRNGKey(seed): the key (k0, k1) of `jax.random.PRNGKey(seed)` under
  JAX's default of 32-bit integers: k0 = 0, k1 = the seed's low 32 bits
  (two's complement for a negative seed).  A seed outside the int64 range
  raises, as JAX's does;
- bits(key, shape): `jax.random.bits(key, shape)` (uint32) with JAX's
  partitionable counters (`jax_threefry_partitionable`, on by default
  since JAX 0.5): element i hashes the counter (hi, lo) = (i >> 32,
  i & 0xFFFFFFFF) and returns the xor of the two output words;
- uniform / normal: JAX's float32 maps.  uniform puts the top 23 bits
  into the mantissa of a float in [1, 2), subtracts 1 and scales to
  [lo, hi); normal draws uniform on (nextafter(-1, 0), 1) and returns
  sqrt(2) * erfinv(u), with XLA's float32 erf_inv: M. Giles' polynomial
  ("Approximating the erfinv function", GPU Computing Gems, 2011).
  torch.erfinv is another approximation: 1.96e-5 from JAX over 20,000
  normal draws, where the polynomial keeps within one float32 ulp.

Used by tools/gninagrid.random_rotation, whose JAX counterpart draws
`jax.random.normal(PRNGKey(seed + i), (4,))`.
"""

from __future__ import annotations

import numpy as np
import torch

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def PRNGKey(seed: int) -> np.ndarray:
    """The uint32 key pair of jax.random.PRNGKey(seed) (32-bit mode)."""
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} outside the int64 range")
    # JAX converts the seed to int32 (wrapping a 64-bit value), then takes
    # (seed >> 32 logical, seed & 0xFFFFFFFF): the high word of a 32-bit
    # value is 0
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray):
    """Threefry-2x32 with 20 rounds of (key[0], key[1]) over the counter
    words (x0, x1), elementwise; returns the two output words."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    with np.errstate(over="ignore"):
        for block in range(5):
            for r in _ROT[block % 2]:
                x0 = x0 + x1
                x1 = _rotl(x1, r) ^ x0
            x0 = x0 + ks[(block + 1) % 3]
            x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def bits(key: np.ndarray, shape=()) -> np.ndarray:
    """jax.random.bits(key, shape) as uint32, partitionable counters."""
    shape = tuple(int(s) for s in np.atleast_1d(shape)) if shape != () \
        else ()
    count = int(np.prod(shape, dtype=np.int64)) if shape else 1
    idx = np.arange(count, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    y0, y1 = threefry2x32(key, hi, lo)
    return (y0 ^ y1).reshape(shape)


def uniform(key: np.ndarray, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval)."""
    b = bits(key, shape)
    one = np.array(1.0, np.float32).view(np.uint32)
    f = ((b >> np.uint32(9)) | one).view(np.float32)
    f = torch.from_numpy(np.ascontiguousarray(f)) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    hi = torch.tensor(maxval, dtype=torch.float32)
    return torch.maximum(lo, f * (hi - lo) + lo)


# XLA's ErfInv32 coefficients (xla/hlo/builder/lib/math.cc), highest
# power first, for w = -log1p(-x^2) below 5 (in w - 2.5) and above (in
# sqrt(w) - 3)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GT5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv (Giles' single-precision polynomial)."""
    def horner(coef, t):
        p = torch.full_like(t, coef[0])
        for c in coef[1:]:
            p = p * t + c
        return p

    w = -torch.log1p(-x * x)
    p = torch.where(w < 5.0, horner(_ERFINV_LT5, w - 2.5),
                    horner(_ERFINV_GT5, torch.sqrt(w) - 3.0))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), p * x)


def normal(key: np.ndarray, shape=()) -> torch.Tensor:
    """jax.random.normal(key, shape, float32)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return torch.tensor(np.sqrt(2.0), dtype=torch.float32) * erfinv(u)
