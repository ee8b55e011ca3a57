"""Per-type energy grids + trilinear evaluation: the `cache` search path.

reference: gninasrc/lib/cache.cpp populate/eval, grid.cpp evaluate_aux.
The reference precomputes, per ligand atom type, a 0.375-A grid of summed
receptor interactions over the search box, then evaluates movable atoms by
trilinear interpolation during the Monte Carlo search (exact pairwise sums
are only used for refinement and final scoring).

- populate: one x-slab of grid points at a time, a (slab points x
  receptor atoms) distance matrix per slab (never the whole box's), the
  term math broadcast over the type slots; amortised over every chain,
  step and ligand that shares the receptor and box.
- evaluate: 8 corner values per atom, stored contiguously per cell
  (_make_cells), and their trilinear weights.

Out-of-box behaviour matches grid.cpp:100-131: clamped interpolation at
the edge cell plus slope * distance penalty; gradients vanish in the
clamped axes (autograd through the clamp reproduces gradient_everywhere).
Charge-dependent scoring functions add a second grid multiplied by the
(signed) ligand charge, exactly like grid::evaluate (grid.cpp:28-45).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gnina_tpu_torch.ops.user_grid import _clamped_cell, _corner_weights
from gnina_tpu_torch.scoring.terms import gather_type_params
from gnina_tpu_torch.scoring.weighted import ScoringFunction, curl

GRANULARITY = 0.375  # main.cpp:622


class CacheGrids(NamedTuple):
    data: torch.Tensor          # (S, nx, ny, nz)
    chargedata: torch.Tensor    # (S, nx, ny, nz) or (S, 1, 1, 1) zeros
    slot_of_type: torch.Tensor  # (28,) int64: smina type -> slot (or 0)
    type_gridded: torch.Tensor  # (28,) bool: type has a valid slot
    origin: torch.Tensor        # (3,)
    dims_minus_1: torch.Tensor  # (3,) float: n points - 1 per axis (actual)
    # cells[c, :] = the 8 corner values of cell c, stored contiguously
    # (S*nx*ny*nz, 8): one row gather per atom instead of 8
    cells: Optional[torch.Tensor] = None
    ccells: Optional[torch.Tensor] = None  # same for chargedata (or (1, 8))


def _make_cells(data: torch.Tensor) -> torch.Tensor:
    """(S,nx,ny,nz) -> (S*nx*ny*nz, 8) corner-interleaved cell rows.

    Row for cell (s,x,y,z) holds data[s, x+i, y+j, z+k] for (i,j,k) in
    binary order.  Edge cells (x=nx-1 etc.) hold wrapped values but are
    never addressed: interpolation bases are clamped to dims-2 points."""
    corners = [torch.roll(data, shifts=(-i, -j, -k), dims=(1, 2, 3))
               for i in (0, 1) for j in (0, 1) for k in (0, 1)]
    return torch.stack(corners, dim=-1).reshape(-1, 8)


def grid_shape_for(lo: np.ndarray, hi: np.ndarray) -> Tuple[int, int, int]:
    """Point counts per axis for a search box, ceil(span / GRANULARITY) + 1
    in float32 (the JAX package's dims_minus_1 + 1; it pads each count to
    a multiple of 8 for static shapes, points that are never read)."""
    span = np.asarray(hi, np.float32) - np.asarray(lo, np.float32)
    return tuple(int(v) + 1 for v in np.ceil(span / np.float32(GRANULARITY)))


def make_populate_fn(sf: ScoringFunction, npts: Tuple[int, int, int],
                     num_slots: int, charge_terms: bool):
    """populate(rec, lo, hi, slot_types, slot_of_type, type_gridded) ->
    CacheGrids, on the receptor's device, npts points from lo (hi is
    the JAX signature's; npts fixes the extent).  The gridded types fill
    the first slots in order; the slots after them are never read and stay 0
    (the JAX package fills them with type 0's grid)."""
    cutoff_sqr = sf.cutoff ** 2
    nx, ny, nz = npts

    def populate(rec, lo, hi, slot_types, slot_of_type, type_gridded):
        dev = rec.coords.device
        lo = torch.tensor(np.asarray(lo, np.float32), device=dev)
        pr = gather_type_params(sf.table, rec.types, dev)
        ns = int(np.asarray(type_gridded).sum())          # slots in use
        pslot = gather_type_params(sf.table, slot_types[:ns], dev)
        pa = {k: v[:, None, None] for k, v in pslot.items()}   # (S', 1, 1)
        pb = {k: v[None, None, :] for k, v in pr.items()}      # (1, 1, K)
        qa0 = torch.zeros((ns, 1, 1), device=dev)
        qb = rec.charges[None, None, :]

        ar = [torch.arange(c, dtype=torch.float32, device=dev)
              for c in npts]
        xs = lo[0] + GRANULARITY * ar[0]
        ys = lo[1] + GRANULARITY * ar[1]
        zs = lo[2] + GRANULARITY * ar[2]
        yz = torch.stack(torch.meshgrid(ys, zs, indexing="ij"),
                         -1).reshape(-1, 2)
        rsq = torch.sum(rec.coords * rec.coords, dim=1)[None, :]
        data = torch.zeros((num_slots, nx, ny * nz), device=dev)
        cdata = torch.zeros_like(data) if charge_terms else None
        for i in range(nx):
            pts = torch.cat([xs[i].expand(yz.shape[0], 1), yz], dim=1)
            r2 = (torch.sum(pts * pts, dim=1)[:, None] + rsq
                  - 2.0 * pts @ rec.coords.T)                     # (P, K)
            r = torch.sqrt(torch.clamp(r2, min=1e-12))
            valid = ((r2 < cutoff_sqr) & rec.mask[None, :])[None]
            rs = r[None].expand(ns, -1, -1)
            # charge-independent accumulation, ligand charge 0; receptor
            # |q| terms fold into the type grid (cache.cpp:152-160)
            e = torch.where(valid, sf.eval_pair(pa, pb, rs, qa=qa0, qb=qb),
                            0.0).sum(dim=2)                      # (S, P)
            data[:ns, i] = e
            if charge_terms:
                # the derivative wrt the ligand charge, around 0
                e_q = torch.where(valid, sf.eval_pair(
                    pa, pb, rs, qa=qa0 + 1.0, qb=qb), 0.0).sum(dim=2)
                cdata[:ns, i] = e_q - e
        data = data.reshape(num_slots, nx, ny, nz)
        if charge_terms:
            cdata = cdata.reshape(num_slots, nx, ny, nz)
            ccells = _make_cells(cdata)
        else:
            cdata = torch.zeros((num_slots, 1, 1, 1), device=dev)
            ccells = torch.zeros((1, 8), device=dev)
        return CacheGrids(
            data=data, chargedata=cdata,
            slot_of_type=torch.as_tensor(slot_of_type, dtype=torch.int64,
                                         device=dev),
            type_gridded=torch.as_tensor(type_gridded, dtype=torch.bool,
                                         device=dev),
            origin=lo, dims_minus_1=torch.tensor(
                [float(c - 1) for c in npts], device=dev),
            cells=_make_cells(data), ccells=ccells)

    return populate


def _trilinear(cells, grid_shape, slot, base_idx, frac):
    """Trilinear interpolation from one contiguous 8-value row per atom.

    cells (S*nx*ny*nz, 8) (_make_cells); slot (...,); base_idx (..., 3);
    frac (..., 3)."""
    _, nx, ny, nz = grid_shape
    cidx = ((slot * nx + base_idx[..., 0]) * ny + base_idx[..., 1]) * nz \
        + base_idx[..., 2]
    return torch.sum(cells[cidx] * _corner_weights(frac), dim=-1)


def cache_inter_energy(grids: CacheGrids, coords, types, charges, heavy_mask,
                       slope, v1):
    """Trilinear grid energy of the movable heavy atoms (cache::eval_deriv),
    summed over the atoms: coords (..., N, 3) -> (...).

    Differentiable in coords; the clamp makes in-cell gradients exact and
    zeroes them outside (grid.cpp:176-181), while the slope penalty keeps
    its +-slope gradient."""
    pos = (coords - grids.origin) * (1.0 / GRANULARITY)   # grid units
    dims = grids.dims_minus_1
    miss = torch.relu(-pos) + torch.relu(pos - dims)
    penalty = slope * torch.sum(miss, dim=-1) * GRANULARITY
    base, frac = _clamped_cell(pos, dims)
    slot = grids.slot_of_type[types]
    f = _trilinear(grids.cells, grids.data.shape, slot, base, frac)
    if grids.chargedata.shape[1] > 1:
        fc = _trilinear(grids.ccells, grids.data.shape, slot, base, frac)
        f = f + charges * fc
    f = curl(f, v1)
    valid = heavy_mask & grids.type_gridded[types]
    return torch.sum(torch.where(valid, f + penalty, 0.0), dim=-1)
