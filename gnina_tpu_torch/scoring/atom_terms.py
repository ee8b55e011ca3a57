"""Per-atom interaction term values (--atom_terms / --atom_term_data).

Reference: terms::evale_robust (gninasrc/lib/terms.cpp:208-265) computes,
for every ligand atom, each pair term's sum over the "relevant" atoms
(heavy receptor atoms near the movable-atoms box plus heavy flex atoms),
masked per-TERM cutoff (terms.cpp:176-200 eval_additive_aux); the dump is
WEIGHTED per term (result_info.cpp:46-64 setAtomValues) with the header
row of reference-format term names (result_info.cpp:33-43).

Counterpart of gnina_tpu/scoring/atom_terms.py: one (N_lig, K_other)
distance matrix per call, each term evaluated broadcast over it in
ordinary PyTorch (a report of one pose; no kernel).  device=None means the
card, as everywhere in the port.
"""

from __future__ import annotations

import numpy as np
import torch

from gnina_tpu_torch.constants import IS_HYDROGEN
from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.scoring.terms import describe_term, gather_type_params
from gnina_tpu_torch.scoring.weighted import ScoringFunction


def _params(sf: ScoringFunction, types, device):
    return gather_type_params(sf.table, np.asarray(types), device)


def per_atom_term_values(sf: ScoringFunction, lig_types, lig_coords,
                         lig_charges, other_types, other_coords,
                         other_charges, device=None) -> np.ndarray:
    """(N_lig, n_terms) weighted per-atom term sums.

    other_* : the relevant partner set (receptor atoms; callers may
    pre-filter by distance to the box — values beyond each term's cutoff
    are masked here anyway).  Hydrogen rows/columns contribute zero
    (terms.cpp:229,241 excludes hydrogens from both sides).
    """
    device = resolve_device(device)
    lig_types = np.asarray(lig_types)
    other_types = np.asarray(other_types)
    pa = _params(sf, lig_types, device)
    pb = _params(sf, other_types, device)
    # broadcast params to (N, K)
    pa2 = {k: v[:, None] for k, v in pa.items()}
    pb2 = {k: v[None, :] for k, v in pb.items()}

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    qa = f32(lig_charges)[:, None]
    qb = f32(other_charges)[None, :]
    r = torch.sqrt(torch.clamp(torch.sum(
        (f32(lig_coords)[:, None, :] - f32(other_coords)[None, :, :]) ** 2,
        dim=-1), min=1e-12))
    heavy_pair = torch.as_tensor(~IS_HYDROGEN[lig_types][:, None]
                                 & ~IS_HYDROGEN[other_types][None, :],
                                 device=device)

    cols = []
    for t, w in zip(sf.pair_terms, sf.pair_weights):
        v = t.eval(pa2, pb2, r, qa=qa, qb=qb)
        v = torch.where((r < t.cutoff) & heavy_pair, v, 0.0)
        cols.append(w * torch.sum(v, dim=1))
    return torch.stack(cols, dim=1).cpu().numpy().astype(np.float64)


def atom_terms_table(sf: ScoringFunction, lig, rec, coords=None,
                     device=None) -> str:
    """The --atom_terms table for one pose (result_info::writeAtomValues):
    header `atomid el pos <term names...>`, one row per ligand atom, END.
    """
    if coords is None:
        coords = lig.orig_coords
    coords = np.asarray(coords)
    lig_n = lig.lig_atoms
    # relevant partners: receptor atoms + this complex's flex/inflex atoms
    ot = [np.asarray(rec.types)]
    oc = [np.asarray(rec.coords)]
    oq = [np.asarray(rec.charges)]
    if coords.shape[0] > lig_n:
        ot.append(np.asarray(lig.types[lig_n:]))
        oc.append(coords[lig_n:])
        oq.append(np.asarray(lig.charges[lig_n:]))
    vals = per_atom_term_values(
        sf, lig.types[:lig_n], coords[:lig_n], lig.charges[:lig_n],
        np.concatenate(ot), np.concatenate(oc), np.concatenate(oq),
        device=device)

    names = [describe_term(t) for t in sf.pair_terms]
    out = ["atomid el pos " + " ".join(names)]
    for i in range(lig_n):
        el = ""
        if lig.mol is not None and i < len(lig.mol.atoms):
            el = lig.mol.atoms[i].element_name or ""
        x, y, z = (float(v) for v in coords[i])
        row = (f"{i + 1} {el} ({x:.5f}, {y:.5f}, {z:.5f}) "
               + " ".join(f"{v:g}" for v in vals[i]))
        out.append(row)
    out.append("END")
    return "\n".join(out) + "\n"
