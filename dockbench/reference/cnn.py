"""The CNN ensemble's scores of poses, plainly: each pose's receptor and
ligand atoms voxelized on a grid centred on the pose's atoms (hydrogens
included in the centre), each model run from its `.spec.json` and `.npz`,
the pose score (softmax of the first output, unless the model skips it) and
the affinity (second output) averaged over the models.  gnina's
CNNTorchScorer (cnn_torch_scorer.cpp:105-232) with no extra rotations.
The channel maps are gnina's defaults (torch_model.cpp:16-46), typed from
this package's own smina types.  Imports nothing of the port.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np
import torch

from dockbench.reference import chem
from dockbench.reference.runtime import execute, load_spec
from dockbench.reference.voxelize import voxelize_batch

RECMAP = """AliphaticCarbonXSHydrophobe
AliphaticCarbonXSNonHydrophobe
AromaticCarbonXSHydrophobe
AromaticCarbonXSNonHydrophobe
Bromine Iodine Chlorine Fluorine
Nitrogen NitrogenXSAcceptor
NitrogenXSDonor NitrogenXSDonorAcceptor
Oxygen OxygenXSAcceptor
OxygenXSDonorAcceptor OxygenXSDonor
Sulfur SulfurAcceptor
Phosphorus
Calcium
Zinc
GenericMetal Boron Manganese Magnesium Iron
"""
LIGMAP = """AliphaticCarbonXSHydrophobe
AliphaticCarbonXSNonHydrophobe
AromaticCarbonXSHydrophobe
AromaticCarbonXSNonHydrophobe
Bromine Iodine
Chlorine
Fluorine
Nitrogen NitrogenXSAcceptor
NitrogenXSDonor NitrogenXSDonorAcceptor
Oxygen OxygenXSAcceptor
OxygenXSDonorAcceptor OxygenXSDonor
Sulfur SulfurAcceptor
Phosphorus
GenericMetal Boron Manganese Magnesium Zinc Calcium Iron
"""


def channel_table(map_text: str):
    """(smina type -> channel or -1, number of channels)."""
    table = np.full(len(chem.TYPE_NAMES), -1, np.int64)
    rows = [ln.split() for ln in map_text.strip().splitlines() if ln.split()]
    for c, names in enumerate(rows):
        for n in names:
            table[chem.T[n]] = c
    return table, len(rows)


class Model:
    def __init__(self, name: str, models_dir: str, device):
        spec, params = load_spec(os.path.join(models_dir, f"{name}.spec.json"),
                                 os.path.join(models_dir, f"{name}.npz"))
        meta = spec.get("metadata", {}) or {}
        self.name = name
        self.spec = spec
        self.params = {k: torch.tensor(np.asarray(v), device=device)
                       for k, v in params.items()}
        self.rec_table, self.rec_channels = channel_table(
            meta.get("recmap", RECMAP))
        self.lig_table, self.lig_channels = channel_table(
            meta.get("ligmap", LIGMAP))
        self.resolution = float(meta.get("resolution", 0.5))
        self.dimension = float(meta.get("dimension", 23.5))
        self.radius_scale = float(meta.get("radius_scaling", 1.0))
        self.skip_softmax = bool(meta.get("skip_softmax", False))
        self.points = int(round(self.dimension / self.resolution)) + 1

    def grid_key(self):
        return (self.rec_table.tobytes(), self.lig_table.tobytes(),
                self.resolution, self.dimension, self.radius_scale)

    def heads(self, grids):
        out = execute(self.spec, self.params, grids)
        pose = out[0][:, 1] if self.skip_softmax else \
            torch.softmax(out[0], dim=1)[:, 1]
        aff = out[1] if len(out) > 1 else torch.zeros_like(pose)
        return pose, aff.reshape(-1)


def load_models(names: List[str], models_dir: str, device) -> List[Model]:
    return [Model(n, models_dir, device) for n in names]


def _grids(m: Model, rec_xyz, rec_types, lig_xyz, lig_types, device):
    """(P, C, n, n, n) grids of P poses (lig_xyz (P, N, 3))."""
    f32 = dict(dtype=torch.float32, device=device)
    centers = lig_xyz.mean(axis=1)
    margin = m.dimension / 2 + 4.0
    keep = np.all((rec_xyz >= centers.min(0) - margin)
                  & (rec_xyz <= centers.max(0) + margin), axis=1)
    rx = rec_xyz[keep].astype(np.float32)
    rt = rec_types[keep]
    radii = chem.XS_RADIUS.astype(np.float32)
    kw = dict(num_channels=m.rec_channels + m.lig_channels,
              npoints=m.points, resolution=m.resolution,
              radius_scale=m.radius_scale)
    c_t = torch.as_tensor(centers, **f32)
    rec = voxelize_batch(
        torch.as_tensor(rx, **f32),
        torch.as_tensor(m.rec_table[rt], device=device),
        torch.as_tensor(radii[rt], **f32),
        torch.ones(len(rt), dtype=torch.bool, device=device), c_t, **kw)
    p = lig_xyz.shape[0]
    lc = m.lig_table[lig_types]
    lc = np.where(lc >= 0, lc + m.rec_channels, -1)
    lig = voxelize_batch(
        torch.as_tensor(lig_xyz.astype(np.float32), **f32),
        torch.as_tensor(np.broadcast_to(lc, (p, len(lc))).copy(),
                        device=device),
        torch.as_tensor(np.broadcast_to(radii[lig_types],
                                        (p, len(lc))).copy(), **f32),
        torch.ones((p, len(lc)), dtype=torch.bool, device=device), c_t,
        **kw)
    return rec + lig


def score(models: List[Model], rec_xyz, rec_types, lig_xyz, lig_types,
          device, block: int = 32):
    """(score (P,), affinity (P,)) of P poses of one ligand, float64 numpy,
    in blocks of `block` poses."""
    groups: Dict[tuple, List[Model]] = {}
    for m in models:
        groups.setdefault(m.grid_key(), []).append(m)
    scores, affs = [], []
    with torch.no_grad():
        for p0 in range(0, len(lig_xyz), block):
            xyz = lig_xyz[p0:p0 + block]
            s_sum = a_sum = 0.0
            for ms in groups.values():
                g = _grids(ms[0], rec_xyz, rec_types, xyz, lig_types, device)
                for m in ms:
                    s, a = m.heads(g)
                    s_sum = s_sum + s.double()
                    a_sum = a_sum + a.double()
            scores.append((s_sum / len(models)).cpu().numpy())
            affs.append((a_sum / len(models)).cpu().numpy())
    return np.concatenate(scores), np.concatenate(affs)
