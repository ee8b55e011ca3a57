"""The reference's atom-density voxelizer (libmolgrid's GridMaker), dense:
every atom at every grid point, written from libmolgrid's density so that
the reference imports nothing of the port.

Density (libmolgrid defaults): exp(-2 d^2 / r^2) for d <= r, the C1 tail
(4/e^2)(d/r)^2 - (12/e^2)(d/r) + 9/e^2 for d <= 1.5 r, 0 beyond.  The
squared distance is the sum of squared coordinate differences.  The
channel reduction is a matmul: it runs in full float32 unless the caller
turns TF32 on.
"""

from __future__ import annotations

import numpy as np
import torch

_E2 = float(np.exp(-2.0))
# floats of the (poses, x slabs, n^2, atoms) distance intermediate one slab
# chunk may hold (256 MB)
SLAB_BUDGET = 64 << 20


def grid_points_1d(center, n: int, resolution: float):
    """Grid node coordinates along one axis; origin = center - dim/2 with
    dim = (n-1)*resolution (libmolgrid convention: dimension/res + 1 pts).
    center: a tensor (...,) -> (..., n)."""
    origin = center - resolution * (n - 1) / 2.0
    return origin[..., None] + resolution * torch.arange(
        n, dtype=torch.float32, device=center.device)


def density_at(d2, radius):
    """Gaussian-with-quadratic-tail density as a function of squared dist.
    The tail factors as e^-2 (2 d/r - 3)^2."""
    r2 = radius * radius
    rinv = 1.0 / torch.clamp(radius, min=1e-12)
    d2c = torch.clamp(d2, min=1e-12)
    gauss = torch.exp(d2c * (-2.0 * rinv * rinv))
    t = torch.sqrt(d2c) * (2.0 * rinv) - 3.0
    quad = _E2 * t * t
    return torch.where(d2c <= r2, gauss,
                       torch.where(d2c <= 2.25 * r2, quad, 0.0))


def _dist2(px, yz, coords):
    """Squared distances (..., S, P, A) between the grid points of S x
    slabs (x = px (..., S), with the slab's points yz (..., P, 2)) and
    atoms coords (..., S, A, 3) or (..., A, 3), as the sum of squared
    coordinate differences."""
    if coords.dim() == yz.dim():
        coords = coords.unsqueeze(-3)
    d = px[..., :, None, None] - coords[..., None, :, 0]
    d2 = d * d
    for c in (1, 2):
        d = yz[..., None, :, None, c - 1] - coords[..., None, :, c]
        d2 = torch.addcmul(d2, d, d)
    return d2


def _onehot(channels, mask, num_channels: int):
    """(..., A, C) float one-hot of valid atoms' channels; masked atoms and
    channel -1 give a zero row."""
    valid = mask & (channels >= 0)
    idx = torch.where(valid, channels, num_channels).long()
    return torch.nn.functional.one_hot(idx, num_channels + 1)[
        ..., :num_channels].to(torch.float32)


def voxelize_batch(coords, channels, radii, mask, centers, num_channels: int,
                   npoints: int = 48, resolution: float = 0.5,
                   radius_scale: float = 1.0):
    """Density grids (B, C, n, n, n) of B atom sets, every atom at every
    grid point.

    coords (B, A, 3) or one set (A, 3) for all B grids; channels, radii,
    mask (B, A) or (A,): channel (int, -1 = skip), radius, atom present;
    centers (B, 3).  x slabs are taken as many at a time as keep the (B,
    slabs, n^2, A) intermediate under SLAB_BUDGET floats."""
    b, a = centers.shape[0], coords.shape[-2]
    n = npoints
    r = (radii * radius_scale).expand(b, a)
    onehot = _onehot(channels, mask, num_channels).expand(b, a,
                                                          num_channels)
    xs = grid_points_1d(centers[:, 0], n, resolution)           # (B, n)
    ys = grid_points_1d(centers[:, 1], n, resolution)
    zs = grid_points_1d(centers[:, 2], n, resolution)
    yz = torch.stack([ys[:, :, None].expand(b, n, n),
                      zs[:, None, :].expand(b, n, n)], -1).reshape(b, n * n, 2)
    slab_chunk = max(1, min(n, SLAB_BUDGET // max(b * n * n * a, 1)))
    out = torch.empty((b, n, n * n, num_channels), dtype=torch.float32,
                      device=coords.device)
    for s0 in range(0, n, slab_chunk):
        s1 = min(s0 + slab_chunk, n)
        k = s1 - s0
        d2 = _dist2(xs[:, s0:s1], yz, coords.expand(b, a, 3)).reshape(
            b, k * n * n, a)
        dens = density_at(d2, r[:, None, :])
        g = torch.bmm(dens, onehot)                             # (B, kn^2, C)
        out[:, s0:s1] = g.reshape(b, k, n * n, num_channels)
    return out.reshape(b, n, n, n, num_channels).permute(0, 4, 1, 2, 3)
