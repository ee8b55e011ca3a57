"""AD4 user-grid bias (--user_grid): a .map file adds an interpolated
energy term per movable atom.

reference: gninasrc/lib/grid.h:63 evaluate_user, grid.cpp:47-49 +
evaluate_aux, main.cpp load_ent_values (:413-426) + setup_user_gd
(:635-670) + cache.cpp:177-179 (user values folded into every search-grid
slot) + non_cache.cpp:168-173 (per-atom addition before curl).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gnina_tpu_torch.device import resolve_device


class UserGrid(NamedTuple):
    data: torch.Tensor          # (nx, ny, nz) float32
    init: torch.Tensor          # (3,) grid origin (gd.begin)
    factor: torch.Tensor        # (3,) points-per-Angstrom
    dims_minus_1: torch.Tensor  # (3,) float


def read_ad4_map(path: str, scaling: float = 1.0, device=None
                 ) -> Tuple[UserGrid, np.ndarray, np.ndarray]:
    """Read an AD4 .map -> (UserGrid, box_center, box_size).

    Layout per load_ent_values (main.cpp:413-426): one value per line,
    x fastest.  Box derivation per setup_user_gd (main.cpp:640-670)."""
    device = resolve_device(device)
    with open(path) as f:
        lines = f.read().splitlines()
    spacing = float(lines[3].split()[1])
    nel = [int(v) for v in lines[4].split()[1:4]]
    center = np.array([float(v) for v in lines[5].split()[1:4]], np.float64)

    n = [e + 1 for e in nel]
    vals = np.array([float(v) for v in lines[6:6 + n[0] * n[1] * n[2]]],
                    np.float32) * scaling
    # x fastest -> (z,y,x) order in the stream; store as (x,y,z)
    data = vals.reshape(n[2], n[1], n[0]).transpose(2, 1, 0)

    # setup_user_gd: size = (NELEMENTS+1)*spacing, center += spacing/2,
    # gd.n = ceil(span/granularity), begin = center - n*granularity/2
    size = np.array([(e + 1) * spacing for e in nel], np.float64)
    bcenter = center + 0.5 * spacing
    gd_n = np.ceil(size / spacing)
    begin = bcenter - gd_n * spacing / 2.0
    span = gd_n * spacing

    dims_m1 = np.array([d - 1.0 for d in data.shape], np.float64)
    factor = dims_m1 / span

    def f(a):
        return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                               device=device)

    ug = UserGrid(data=f(data), init=f(begin), factor=f(factor),
                  dims_minus_1=f(dims_m1))
    return ug, bcenter.astype(np.float32), size.astype(np.float32)


def _curl_scalar(e, v=1000.0):
    """curl() capping (curl.h) applied inside evaluate_aux at c=1000."""
    tmp = v / (v + torch.clamp(e, min=0.0))
    return torch.where(e > 0, e * tmp, e)


def _corner_weights(frac):
    """(..., 3) fractions -> (..., 8) trilinear weights, corner (i, j, k) in
    binary order (i the x bit, the most significant)."""
    fx, fy, fz = frac[..., 0], frac[..., 1], frac[..., 2]
    wx = torch.stack([1 - fx, fx], dim=-1)
    wy = torch.stack([1 - fy, fy], dim=-1)
    wz = torch.stack([1 - fz, fz], dim=-1)
    w = (wx[..., :, None, None] * wy[..., None, :, None]
         * wz[..., None, None, :])
    return w.reshape(frac.shape[:-1] + (8,))


def _clamped_cell(pos, dims):
    """Position in grid units -> (integer base corner, differentiable
    fraction): clamped into the grid (gradient 1 inside, 0 where clamped),
    the floor carrying no gradient (grid.cpp evaluate_aux)."""
    sc = torch.minimum(torch.maximum(pos, torch.zeros_like(pos)), dims - 1e-6)
    base_f = torch.minimum(
        torch.maximum(torch.floor(sc.detach()), torch.zeros_like(sc)),
        torch.clamp(dims - 1.0, min=0.0))
    return base_f.long(), sc - base_f


def user_grid_atom_energy(ug: UserGrid, coords, slope):
    """Per-atom evaluate_user values (..., N): trilinear with out-of-box
    slope penalty (grid.cpp evaluate_aux), capped at 1000."""
    pos = (coords - ug.init) * ug.factor
    dims = ug.dims_minus_1
    miss = torch.relu(-pos) + torch.relu(pos - dims)
    # penalty in grid units x factor_inv = Angstroms
    penalty = slope * torch.sum(miss / ug.factor, dim=-1)
    base, frac = _clamped_cell(pos, dims)
    _, ny, nz = ug.data.shape
    flat = ug.data.reshape(-1)
    corners = []
    for i in (0, 1):
        for j in (0, 1):
            for k in (0, 1):
                idx = ((base[..., 0] + i) * ny + base[..., 1] + j) * nz \
                    + base[..., 2] + k
                corners.append(flat[idx])
    val = torch.sum(torch.stack(corners, dim=-1) * _corner_weights(frac),
                    dim=-1)
    return _curl_scalar(val) + penalty


def user_values_on_lattice(ug: UserGrid, lo, granularity: float,
                           npts: Tuple[int, int, int]) -> torch.Tensor:
    """User-grid values at every search-cache lattice point (cache.cpp:
    173-179 folds them into each type slot), (nx, ny, nz) on the grid's
    device; slope 0 like the reference's populate-time evaluation."""
    dev = ug.data.device
    axes = [float(np.asarray(lo)[a]) + granularity
            * torch.arange(npts[a], dtype=torch.float64, device=dev)
            for a in range(3)]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"),
                      dim=-1).reshape(-1, 3).to(torch.float32)
    with torch.no_grad():
        vals = user_grid_atom_energy(ug, pts, 0.0)
    return vals.reshape(npts)
