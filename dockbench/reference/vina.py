"""The Vina affinity of a pose, written plainly in PyTorch.

The five Vina terms (gauss 0/0.5, gauss 3/2, repulsion, hydrophobic 0.5/1.5,
non-directional hydrogen bond -0.7/0) over every heavy ligand atom and heavy
receptor atom closer than 8 A, on surface distances from the X-Score radii;
each ligand atom's sum capped by curl at 1000 (gnina's forcecap); atoms
outside the box clamped onto it for their distances and charged 1000
kcal/mol per A outside; the sum divided by 1 + 0.05846 * rotatable bonds
(gnina's num_tors_div).  Weights and forms: gnina's everything.h and
builtinscoring.cpp.  `dtype` sets the arithmetic: float64 for the
reference, bfloat16 for the lower-precision control.
"""

from __future__ import annotations

import numpy as np
import torch

from dockbench.reference import chem

WEIGHTS = (-0.035579, -0.005156, 0.840245, -0.035069, -0.587439)
NUM_TORS_WEIGHT = 0.05846
CUTOFF = 8.0
CAP = 1000.0
BOX_SLOPE = 1000.0


def _slope_step(x_bad, x_good, x):
    return torch.clamp((x - x_bad) / (x_good - x_bad), 0.0, 1.0)


def inter_energy(lig_xyz, lig_types, rec_xyz, rec_types, lo, hi,
                 dtype=torch.float64):
    """(P,) receptor-ligand energies of P poses of one ligand: lig_xyz
    (P, N, 3), lig_types (N,), rec_xyz (K, 3), rec_types (K,); hydrogens
    are skipped."""
    f = dict(dtype=dtype)
    lh = ~chem.IS_H[lig_types]
    rh = ~chem.IS_H[rec_types]
    lx = torch.as_tensor(lig_xyz[:, lh]).to(**f)
    rx = torch.as_tensor(rec_xyz[rh]).to(**f)
    lt, rt = lig_types[lh], rec_types[rh]
    lo_t = torch.as_tensor(np.asarray(lo)).to(**f)
    hi_t = torch.as_tensor(np.asarray(hi)).to(**f)
    adj = torch.maximum(torch.minimum(lx, hi_t), lo_t)
    oob = (lx - adj).abs().sum(-1)                                # (P, N)
    rr = torch.as_tensor(chem.XS_RADIUS[lt][:, None]
                         + chem.XS_RADIUS[rt][None, :]).to(**f)
    hyd = torch.as_tensor(chem.XS_HYDROPHOBE[lt][:, None]
                          & chem.XS_HYDROPHOBE[rt][None, :])
    hb = torch.as_tensor((chem.XS_DONOR[lt][:, None]
                          & chem.XS_ACCEPTOR[rt][None, :])
                         | (chem.XS_ACCEPTOR[lt][:, None]
                            & chem.XS_DONOR[rt][None, :]))
    diff = adj[:, :, None, :] - rx[None, None]                    # (P,N,K,3)
    r2 = (diff * diff).sum(-1)
    r = torch.sqrt(r2)
    d = r - rr
    e = (WEIGHTS[0] * torch.exp(-(d / 0.5) ** 2)
         + WEIGHTS[1] * torch.exp(-((d - 3.0) / 2.0) ** 2)
         + WEIGHTS[2] * torch.where(d < 0, d * d, torch.zeros_like(d))
         + WEIGHTS[3] * torch.where(hyd, _slope_step(1.5, 0.5, d),
                                    torch.zeros_like(d))
         + WEIGHTS[4] * torch.where(hb, _slope_step(0.0, -0.7, d),
                                    torch.zeros_like(d)))
    e = torch.where(r2 < CUTOFF * CUTOFF, e, torch.zeros_like(e)).sum(-1)
    e = torch.where(e > 0, e * (CAP / (CAP + e)), e)              # curl
    return (e + BOX_SLOPE * oob).sum(-1)


def affinity(lig_xyz, lig_types, num_tors, rec_xyz, rec_types, lo, hi,
             dtype=torch.float64, block: int = 16) -> np.ndarray:
    """(P,) Vina affinities (kcal/mol), in blocks of `block` poses."""
    out = []
    for p0 in range(0, len(lig_xyz), block):
        e = inter_energy(lig_xyz[p0:p0 + block], lig_types, rec_xyz,
                         rec_types, lo, hi, dtype)
        out.append((e / (1.0 + NUM_TORS_WEIGHT * num_tors)).double())
    return torch.cat(out).numpy()


def near_receptor(rec_xyz, lig_xyz, reach: float = CUTOFF + 0.5):
    """Receptor rows within `reach` of the poses' bounding box."""
    lo = lig_xyz.reshape(-1, 3).min(0) - reach
    hi = lig_xyz.reshape(-1, 3).max(0) + reach
    return np.all((rec_xyz >= lo) & (rec_xyz <= hi), axis=1)
