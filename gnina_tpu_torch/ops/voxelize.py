"""Atom-density voxelization (libmolgrid GridMaker equivalent) in PyTorch.

Produces the (C, n, n, n) Gaussian atom-density grids consumed by the CNN
scorers (reference: external libmolgrid GridMaker, used via
gninasrc/lib/torch_model.cpp:153-224).  Counterpart of the JAX package's
gnina_tpu/ops/voxelize.py, which is plain XLA (no Pallas kernel): the
point-atom squared distances and the density are elementwise, and the
channel reduction is a (P, A) x (A, C) one-hot matmul, looped over x slabs
to bound memory.

Density model (libmolgrid defaults: binary=False,
gaussian_radius_multiple 1, final_radius_multiple 1.5):
    d <= r   : exp(-2 d^2 / r^2)
    d <= 1.5r: (4/e^2)(d/r)^2 - (12/e^2)(d/r) + 9/e^2   (C1-continuous tail)
    else     : 0

Precision: the JAX voxelizer takes the squared distance by expansion,
|p|^2 + |a|^2 - 2 p.a with the cross term as a matmul, which cancels badly
for coordinates of tens of angstroms: at 40 A each term carries a float32
rounding of ~1e-4 A^2, and two implementations that round differently (a
card's fused multiply-adds against a CPU's, or XLA against PyTorch) land
up to 3e-4 apart in density, past the 1e-4 grid-parity bar.  Here the
squared distance is the sum of squared coordinate differences, exact to
float32 rounding of the distance itself, so the card and the CPU agree to
~1e-6 and what separates the port from the JAX grids is the JAX formula's
own rounding.  The channel reduction is still a matmul and must run in full
float32: the package switches TF32 off at import
(gnina_tpu_torch/__init__.py); do not turn it on.

On a card and outside autograd, the rescore's grids (a receptor sorted by
x and a chunk of ligand poses) come from one CUDA kernel instead,
voxelize_cuda (csrc/voxelize.cu): the same density and rounding rules,
written once as contiguous (B, C, n, n, n) grids.  The plain functions
here stay for the CPU, for rotated grids and for every gradient, and are
the kernel's reference in the card tests.
"""

from __future__ import annotations

import ctypes

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
                   radius_scale: float = 1.0, binary: bool = False):
    """Density grids (B, C, n, n, n) of B atom sets.

    coords (B, A, 3); channels (B, A) int, -1 = skip; radii (B, A); mask
    (B, A) bool; centers (B, 3).  binary=True gives libmolgrid binary
    occupancy: 1 inside the atom radius, 0 outside, capped at 1 under
    overlap.  x slabs are taken as many at a time as keep the (B, slabs,
    n^2, A) intermediate under SLAB_BUDGET floats."""
    b, a = coords.shape[:2]
    n = npoints
    r = radii * radius_scale
    onehot = _onehot(channels, mask, num_channels)              # (B, A, C)
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
        d2 = _dist2(xs[:, s0:s1], yz, coords).reshape(b, k * n * n, a)
        if binary:
            dens = torch.where(d2 <= (r * r)[:, None, :], 1.0, 0.0)
        else:
            dens = density_at(d2, r[:, None, :])
        g = torch.bmm(dens, onehot)                             # (B, kn^2, C)
        if binary:
            g = torch.clamp(g, max=1.0)
        out[:, s0:s1] = g.reshape(b, k, n * n, num_channels)
    return out.reshape(b, n, n, n, num_channels).permute(0, 4, 1, 2, 3)


def voxelize(coords, channels, radii, mask, center, num_channels: int,
             npoints: int = 48, resolution: float = 0.5,
             radius_scale: float = 1.0, binary: bool = False):
    """Density grid (C, n, n, n) for one molecule/complex.

    coords: (A,3); channels: (A,) int, -1 = skip; radii: (A,); mask: (A,)
    bool; center: (3,)."""
    return voxelize_batch(coords[None], channels[None], radii[None],
                          mask[None], center[None], num_channels, npoints,
                          resolution, radius_scale, binary)[0]


def slab_window_size(x_sorted: np.ndarray, max_reach: float,
                     pad_to: int = 128) -> int:
    """Per-slab atom-window width for voxelize_windowed: the largest number
    of atoms whose x lies in ANY closed interval of width 2*max_reach over
    the given sorted x coordinates, padded up to a multiple of pad_to."""
    x = np.asarray(x_sorted, np.float64)
    n = len(x)
    if n == 0:
        return pad_to
    hi = np.searchsorted(x, x + 2.0 * max_reach, side="right")
    w = int((hi - np.arange(n)).max())
    return min(((w + pad_to - 1) // pad_to) * pad_to, n)


def voxelize_windowed(coords, channels, radii, mask, centers,
                      num_channels: int, window: int, npoints: int = 48,
                      resolution: float = 0.5, radius_scale: float = 1.0):
    """Exact voxelize_batch of ONE atom set, PRE-SORTED along x, at B grid
    centers (B, 3), visiting only a `window`-wide slice of atoms per x-slab
    -> (B, C, n, n, n).

    An atom's density support is a ball of radius 1.5*r*scale, so a slab at
    x only sees atoms with |ax - x| inside that reach; for a pocket-sized
    receptor that is several times fewer atoms than the full set.  `window`
    must come from slab_window_size (an under-sized window would silently
    DROP atoms).  Equal to voxelize up to float32 summation order."""
    a = coords.shape[0]
    b = centers.shape[0]
    n = npoints
    window = min(window, a)
    r = radii * radius_scale
    onehot = _onehot(channels, mask, num_channels)              # (A, C)
    xs = grid_points_1d(centers[:, 0], n, resolution)           # (B, n)
    ys = grid_points_1d(centers[:, 1], n, resolution)
    zs = grid_points_1d(centers[:, 2], n, resolution)
    yz = torch.stack([ys[:, :, None].expand(b, n, n),
                      zs[:, None, :].expand(b, n, n)], -1).reshape(b, n * n, 2)
    ax = coords[:, 0].contiguous()
    # conservative reach: padding rows carry radius 0 -> reach 0, real rows
    # bound by the max; +resolution guards the searchsorted edge
    reach = 1.5 * torch.max(r) + resolution
    start = torch.searchsorted(ax, (xs - reach).contiguous(), side="left")
    start = torch.clamp(start, max=a - window)                  # (B, n)
    widx = start[..., None] + torch.arange(window, device=coords.device)
    out = torch.empty((b, n, n * n, num_channels), dtype=torch.float32,
                      device=coords.device)
    # slabs per pass: keep the (B, slabs, n^2, window) intermediate bounded
    chunk = max(1, min(n, SLAB_BUDGET // max(b * n * n * window, 1)))
    for s0 in range(0, n, chunk):
        s1 = min(s0 + chunk, n)
        k = s1 - s0
        wi = widx[:, s0:s1]                                     # (B, k, W)
        d2 = _dist2(xs[:, s0:s1], yz, coords[wi])               # (B,k,n^2,W)
        dens = density_at(d2, r[wi][:, :, None, :])
        out[:, s0:s1] = torch.matmul(dens, onehot[wi])
    return out.reshape(b, n, n, n, num_channels).permute(0, 4, 1, 2, 3)


def on_card(t) -> bool:
    """Whether tensor t lies on a CUDA device."""
    return t.is_cuda


def kernel_applies(t) -> bool:
    """Whether voxelize_cuda takes a job on t's device now: on a card and
    outside autograd (the kernel has no backward)."""
    return on_card(t) and not torch.is_grad_enabled()


def _operand(t, name: str, shape, dtype, device):
    """t as the kernel reads it: contiguous, integer channels as int32."""
    ok = torch.is_tensor(t) and (
        t.dtype == dtype or dtype == torch.int32 and not (
            t.dtype.is_floating_point or t.dtype == torch.bool))
    if not ok or t.device != device or tuple(t.shape) != tuple(shape):
        raise ValueError(f"voxelize_cuda: {name} must be a {dtype} tensor "
                         f"of shape {tuple(shape)} on {device}")
    return t.to(dtype).contiguous()


def voxelize_cuda(rec_coords, rec_channels, rec_radii, rec_mask, centers,
                  num_channels: int, npoints: int = 48,
                  resolution: float = 0.5, radius_scale: float = 1.0,
                  ligand=None):
    """Contiguous density grids (B, C, n, n, n) of one receptor and B
    ligand poses at B centres, in one launch of the CUDA kernel
    (csrc/voxelize.cu); CUDA tensors only.

    rec_coords (K, 3) float32, its present rows sorted by x and its masked
    rows after them (prepare_multi's order); rec_channels (K,) integer,
    -1 = skip; rec_radii (K,) float32; rec_mask (K,) bool.  ligand: None or
    (coords (B, N, 3), channels (B, N), radii (B, N), mask (B, N)) of the
    same types.  Equal to voxelize_windowed(receptor) +
    voxelize_batch(ligand) up to the order of each channel's sum."""
    from gnina_tpu_torch.ops import _cuda

    dev = centers.device
    if not on_card(centers):
        raise ValueError("voxelize_cuda: the kernel runs on CUDA tensors; "
                         "use voxelize_windowed and voxelize_batch")
    b, k = centers.shape[0], rec_coords.shape[0]
    f32, i32 = torch.float32, torch.int32
    centers = _operand(centers, "centers", (b, 3), f32, dev)
    rec = [_operand(rec_coords, "rec_coords", (k, 3), f32, dev),
           _operand(rec_channels, "rec_channels", (k,), i32, dev),
           _operand(rec_radii, "rec_radii", (k,), f32, dev),
           _operand(rec_mask, "rec_mask", (k,), torch.bool, dev)]
    rmax = (rec[2].amax().reshape(1) if k
            else torch.zeros(1, dtype=f32, device=dev))
    nl = 0 if ligand is None else ligand[0].shape[1]
    lig = [None] * 4
    if nl:
        lig = [_operand(t, name, shape, dtype, dev) for t, name, shape, dtype
               in zip(ligand, ("lig_coords", "lig_channels", "lig_radii",
                               "lig_mask"),
                      ((b, nl, 3), (b, nl), (b, nl), (b, nl)),
                      (f32, i32, f32, torch.bool))]
    n = npoints
    out = torch.empty((b, num_channels, n, n, n), dtype=f32, device=dev)
    if b == 0:
        return out

    def p(t):
        return ctypes.c_void_p(t.data_ptr() if t is not None else 0)

    lib = _cuda.voxelize_lib()
    code = lib.gt_voxelize(
        *map(p, rec), p(rmax), k, *map(p, lig), nl, p(centers), b,
        num_channels, n, resolution, resolution * (n - 1) / 2.0,
        radius_scale, p(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if code != 0:
        raise RuntimeError(f"voxelize_cuda: CUDA error {code}: "
                           + lib.gt_voxelize_error_string(code).decode())
    voxelize_cuda.launches += 1
    return out


voxelize_cuda.launches = 0
