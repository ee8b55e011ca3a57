"""Differentiable docking energy: receptor-ligand + intra-ligand + box penalty.

The plain reference for the fused kernels (reference: gninasrc/lib/
non_cache.cpp eval/eval_deriv, model.cu eval_interacting_pairs/eval_deriv):
one function of the conformation, batched over leading pose dimensions.
The N_lig x K_rec pair energies are evaluated analytically and masked by
the cutoff; gradients come from autograd with respect to a zero DOF
increment, which is mathematically the reference's force/torque reverse
pass.

Energy-capping "v" semantics (model.cu:202-226):
  v[0] -> intra-ligand pairs, v[1] -> rec-lig interactions, v[2] -> other
All capping via curl(); per movable atom for rec-lig, per pair for intra
and other (the flex-involved pairs of LigandData.opair_*).

The ligand's tensors may carry the confs' leading dimensions too
(lane_ligands: one ligand per lane of a batch of ligands), as the general
docking path runs several ligands' chains on one lane axis.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from gnina_tpu_torch.ops import fk
from gnina_tpu_torch.ops.fk import rows
from gnina_tpu_torch.scoring.terms import type_param_tables
from gnina_tpu_torch.scoring.weighted import ScoringFunction, curl
from gnina_tpu_torch.types import Conf, LigandData, ReceptorData


class Box(NamedTuple):
    lo: torch.Tensor  # (3,)
    hi: torch.Tensor  # (3,)


@dataclasses.dataclass(frozen=True)
class EnergyFn:
    """Bound energy evaluator for one scoring function."""

    sf: ScoringFunction
    max_layers: int
    eval_energy: Callable     # (lig, rec, conf, box, slope, v) -> energy
    eval_deriv: Callable      # same args -> (energy, grad (..., 6+T))
    eval_inter: Callable      # (lig, rec, conf, box, slope, v1)
    eval_intra: Callable      # (lig, conf, v0)
    eval_other: Callable      # (lig, conf, v2): flex "other" pairs only
    inter_on_coords: Callable  # (lig, rec, coords, box, slope, v1)
    pairs_on_coords: Callable  # (lig, coords, v0, v2) -> intra + other


def lane_ligands(ligs, lane_lig) -> LigandData:
    """One LigandData whose tensors carry a leading lane dimension: lane i
    holds ligand lane_lig[i] of `ligs` (padded to one shape).  The
    conf-independent inputs are not per lane and are set to 0."""
    out = []
    for field, *vals in zip(LigandData._fields, *ligs):
        if isinstance(vals[0], torch.Tensor):
            out.append(torch.stack(vals)[lane_lig])
        else:
            out.append(0.0)
    return LigandData(*out)


def _gather_pairs(p, idx):
    """Per-atom parameters p (..., N) at pair indices idx (P,) or (..., P)."""
    if idx.dim() == 1:
        return p[..., idx]
    return torch.gather(p, -1, idx)


def make_energy_fn(sf: ScoringFunction, max_layers: int,
                   user_grid=None) -> EnergyFn:
    """Energy/gradient functions taking explicit (lig: LigandData,
    rec: ReceptorData, conf: Conf, box: Box, slope, v: (3,)); confs may
    carry any leading batch shape.

    user_grid: optional ops.user_grid.UserGrid, whose interpolated value is
    added per movable atom BEFORE curl (non_cache.cpp:168-173)."""
    cutoff_sqr = sf.cutoff ** 2
    tables = {}   # the per-type parameter tables, one set a device

    def params_of(types):
        """Per-atom parameters of a type tensor, gathered on its device."""
        tab = tables.get(types.device)
        if tab is None:
            tab = tables[types.device] = type_param_tables(sf.table,
                                                           types.device)
        idx = types.long()
        return {k: v[idx] for k, v in tab.items()}

    def _params(lig: LigandData, rec: ReceptorData):
        return params_of(lig.types), params_of(rec.types)

    def inter_energy(lig, rec, coords, box: Box, slope, v1):
        """Receptor interaction per movable heavy atom + box penalty.

        Mirrors non_cache::eval_deriv (non_cache.cpp:127-180): coords are
        clamped into the box for the pair distances; |overflow|*slope adds
        a linear penalty.  curl() caps the per-atom receptor sum."""
        adj = torch.maximum(torch.minimum(coords, box.hi), box.lo)
        oob = torch.sum(torch.abs(coords - adj), dim=-1)          # (..., N)
        pl, pr = _params(lig, rec)
        diff = adj[..., :, None, :] - rec.coords                  # (..., N, K, 3)
        r2 = torch.sum(diff * diff, dim=-1)
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        pa = {k: v[..., :, None] for k, v in pl.items()}
        pb = {k: v[None, :] for k, v in pr.items()}
        e_pair = sf.eval_pair(pa, pb, r, qa=lig.charges[..., :, None],
                              qb=rec.charges[None, :])
        valid = ((r2 < cutoff_sqr) & rec.mask[None, :]
                 & lig.heavy_mask[..., :, None])
        e_atom = torch.sum(torch.where(valid, e_pair, 0.0), dim=-1)
        if user_grid is not None:
            from gnina_tpu_torch.ops.user_grid import user_grid_atom_energy

            e_atom = e_atom + user_grid_atom_energy(user_grid, adj, 0.0)
        e_atom = curl(e_atom, v1)
        e_atom = torch.where(lig.heavy_mask, e_atom + slope * oob, 0.0)
        return torch.sum(e_atom, dim=-1)

    def _pair_sum(lig, coords, idx_a, idx_b, mask, v):
        """Masked pair-list energy with per-pair curl (model.cu:22-36)."""
        ca = rows(coords, idx_a)
        cb = rows(coords, idx_b)
        r2 = torch.sum((ca - cb) ** 2, dim=-1)
        r = torch.sqrt(torch.clamp(r2, min=1e-12))
        pl = params_of(lig.types)
        pa = {k: _gather_pairs(p, idx_a) for k, p in pl.items()}
        pb = {k: _gather_pairs(p, idx_b) for k, p in pl.items()}
        e = sf.eval_pair(pa, pb, r, qa=_gather_pairs(lig.charges, idx_a),
                         qb=_gather_pairs(lig.charges, idx_b))
        e = curl(e, v)
        valid = (r2 < cutoff_sqr) & mask
        return torch.sum(torch.where(valid, e, 0.0), dim=-1)

    def intra_energy(lig, coords, v0):
        """Intra-ligand 1-4+ pair energy, curl per pair at v[0]."""
        return _pair_sum(lig, coords, lig.pair_a, lig.pair_b, lig.pair_mask,
                         v0)

    def other_energy(lig, coords, v2):
        """Flex-involved "other" pairs at v[2] (model.cu eval_deriv)."""
        return _pair_sum(lig, coords, lig.opair_a, lig.opair_b,
                         lig.opair_mask, v2)

    def total_energy(lig, rec, conf: Conf, box: Box, slope, v):
        coords = fk.fk_coords(lig, conf, max_layers)
        return (inter_energy(lig, rec, coords, box, slope, v[1])
                + intra_energy(lig, coords, v[0])
                + other_energy(lig, coords, v[2]))

    def eval_deriv(lig, rec, conf: Conf, box: Box, slope, v):
        t = conf.torsions.shape[-1]
        eps = torch.zeros(conf.position.shape[:-1] + (6 + t,),
                          dtype=torch.float32, device=conf.position.device,
                          requires_grad=True)
        with torch.enable_grad():
            e = total_energy(lig, rec, fk.conf_with_increment_var(conf, eps),
                             box, slope, v)
            (g,) = torch.autograd.grad(e.sum(), eps)
        return e.detach(), g

    def eval_inter(lig, rec, conf: Conf, box: Box, slope, v1):
        coords = fk.fk_coords(lig, conf, max_layers)
        return inter_energy(lig, rec, coords, box, slope, v1)

    def eval_intra(lig, conf: Conf, v0):
        coords = fk.fk_coords(lig, conf, max_layers)
        return intra_energy(lig, coords, v0)

    def eval_other(lig, conf: Conf, v2):
        coords = fk.fk_coords(lig, conf, max_layers)
        return other_energy(lig, coords, v2)

    def pairs_on_coords(lig, coords, v0, v2):
        return intra_energy(lig, coords, v0) + other_energy(lig, coords, v2)

    return EnergyFn(sf=sf, max_layers=max_layers, eval_energy=total_energy,
                    eval_deriv=eval_deriv, eval_inter=eval_inter,
                    eval_intra=eval_intra, eval_other=eval_other,
                    inter_on_coords=inter_energy,
                    pairs_on_coords=pairs_on_coords)
