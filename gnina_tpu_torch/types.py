"""Device-side data structures (tensor bundles) for docking.

Fixed-shape, padded tensor bundles: where the reference keeps a mutable
`model` object per thread (reference: gninasrc/lib/model.h), the port keeps
padded tensors and a separate conformation bundle that batches over poses
(leading dimensions).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gnina_tpu_torch.constants import IS_HYDROGEN
from gnina_tpu_torch.device import resolve_device


class ReceptorData(NamedTuple):
    """Rigid receptor atoms (padded to a fixed K)."""

    coords: torch.Tensor    # (K,3) float32
    types: torch.Tensor     # (K,) int64
    charges: torch.Tensor   # (K,)
    mask: torch.Tensor      # (K,) bool — real atom & not hydrogen


class LigandData(NamedTuple):
    """One ligand's padded tensors; see chem/tree_build.py for semantics."""

    # per atom (N)
    local_coords: torch.Tensor  # (N,3)
    types: torch.Tensor         # (N,) int64
    charges: torch.Tensor       # (N,)
    node_id: torch.Tensor       # (N,) int64
    atom_mask: torch.Tensor     # (N,) bool
    heavy_mask: torch.Tensor    # (N,) bool (real & heavy & movable)
    movable_mask: torch.Tensor  # (N,) bool (ligand + flex side chains)
    lig_heavy_mask: torch.Tensor  # (N,) bool (ligand block only, heavy)
    # per node (M)
    parent: torch.Tensor        # (M,) int64, -1 root
    rel_axis: torch.Tensor      # (M,3)
    rel_origin: torch.Tensor    # (M,3)
    layer: torch.Tensor         # (M,) int64
    node_mask: torch.Tensor     # (M,) bool
    # intra-ligand pairs (P), capped at v[0]
    pair_a: torch.Tensor        # (P,) int64
    pair_b: torch.Tensor        # (P,) int64
    pair_mask: torch.Tensor     # (P,) bool
    # "other" pairs (Q): flex-involved, capped at v[2]
    opair_a: torch.Tensor       # (Q,) int64
    opair_b: torch.Tensor       # (Q,) int64
    opair_mask: torch.Tensor    # (Q,) bool
    opair_ff: torch.Tensor      # (Q,) bool — both ends flex (flex-flex pairs
                                # belong to the intramolecular sum,
                                # model.cu:385-397)
    # conf-independent inputs (python floats)
    num_tors: float
    num_heavy_atoms: float
    num_hydrophobic_atoms: float
    ligand_length: float

    @property
    def num_torsion_slots(self) -> int:
        return self.parent.shape[-1] - 1


class Conf(NamedTuple):
    """Pose DOF (batchable): ligand rigid transform + torsions.

    Mirrors the reference `conf` (conf.h:361) for a single ligand; leading
    batch dimensions broadcast through all ops.
    """

    position: torch.Tensor     # (...,3)
    orientation: torch.Tensor  # (...,4) quaternion (w, x, y, z)
    torsions: torch.Tensor     # (...,T)


def pad_receptor(coords, types, charges, k_pad: int,
                 device=None) -> ReceptorData:
    device = resolve_device(device)
    k = len(types)
    if k_pad < k:
        raise ValueError(f"receptor has {k} atoms > pad {k_pad}")
    pad = k_pad - k
    mask = ~IS_HYDROGEN[np.asarray(types, np.int64)]

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return ReceptorData(
        coords=t(np.pad(np.asarray(coords, np.float32), ((0, pad), (0, 0))),
                 torch.float32),
        types=t(np.pad(np.asarray(types, np.int64), (0, pad)), torch.int64),
        charges=t(np.pad(np.asarray(charges, np.float32), (0, pad)),
                  torch.float32),
        mask=t(np.pad(mask, (0, pad)), torch.bool),
    )


def pad_ligand(lig, n_pad: int, m_pad: int, p_pad: int, q_pad: int = 0,
               device=None) -> LigandData:
    """LigandStruct (chem/tree_build.py) -> padded LigandData tensors.  The
    "other" pairs pad to q_pad, at least to the next multiple of 32."""
    device = resolve_device(device)
    n, m, p = lig.num_atoms, lig.num_nodes, len(lig.pairs)
    opairs = lig.other_pairs if lig.other_pairs is not None else \
        np.zeros((0, 2), np.int64)
    q = len(opairs)
    q_pad = max(q_pad, ((q + 31) // 32) * 32, 32)
    if n_pad < n or m_pad < m or p_pad < p:
        raise ValueError(f"pad too small: atoms {n}>{n_pad} or nodes {m}>{m_pad} "
                         f"or pairs {p}>{p_pad}")
    an, am, ap, aq = n_pad - n, m_pad - m, p_pad - p, q_pad - q
    hyd = IS_HYDROGEN[lig.types]
    movable = np.zeros(n, bool)
    movable[: lig.movable_atoms] = True
    lig_heavy = np.zeros(n, bool)
    lig_heavy[: lig.lig_atoms] = ~hyd[: lig.lig_atoms]
    # padded nodes parent to the root as layer-1 children and stay inert
    parent = np.pad(lig.parent, (0, am), constant_values=0)
    layer = np.pad(lig.layer, (0, am), constant_values=1)
    rel_axis = np.pad(lig.rel_axis, ((0, am), (0, 0)))
    rel_axis[m:, 0] = 1.0  # unit axis for padding
    pa = lig.pairs[:, 0] if p else np.zeros(0, np.int64)
    pb = lig.pairs[:, 1] if p else np.zeros(0, np.int64)
    qa = opairs[:, 0] if q else np.zeros(0, np.int64)
    qb = opairs[:, 1] if q else np.zeros(0, np.int64)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, bool), device=device)

    return LigandData(
        local_coords=f(np.pad(lig.local_coords, ((0, an), (0, 0)))),
        types=i(np.pad(lig.types, (0, an))),
        charges=f(np.pad(lig.charges, (0, an))),
        node_id=i(np.pad(lig.node_id, (0, an))),
        atom_mask=b(np.pad(np.ones(n, bool), (0, an))),
        heavy_mask=b(np.pad(~hyd & movable, (0, an))),
        movable_mask=b(np.pad(movable, (0, an))),
        lig_heavy_mask=b(np.pad(lig_heavy, (0, an))),
        parent=i(parent),
        rel_axis=f(rel_axis),
        rel_origin=f(np.pad(lig.rel_origin, ((0, am), (0, 0)))),
        layer=i(layer),
        node_mask=b(np.pad(np.ones(m, bool), (0, am))),
        pair_a=i(np.pad(pa, (0, ap))),
        pair_b=i(np.pad(pb, (0, ap))),
        pair_mask=b(np.pad(np.ones(p, bool), (0, ap))),
        opair_a=i(np.pad(qa, (0, aq))),
        opair_b=i(np.pad(qb, (0, aq))),
        opair_mask=b(np.pad(np.ones(q, bool), (0, aq))),
        opair_ff=b(np.pad((qa >= lig.lig_atoms) & (qb >= lig.lig_atoms),
                          (0, aq))),
        num_tors=float(lig.num_tors),
        num_heavy_atoms=float(lig.num_heavy_atoms),
        num_hydrophobic_atoms=float(lig.num_hydrophobic_atoms),
        ligand_length=float(lig.ligand_length),
    )


def initial_conf(lig, t_pad: int, device=None) -> Conf:
    """Null conf: identity orientation, zero torsions, position = root origin
    (model.cpp:741 get_initial_conf)."""
    device = resolve_device(device)
    return Conf(
        position=torch.as_tensor(np.asarray(lig.orig_coords[0], np.float32),
                                 device=device),
        orientation=torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32,
                                 device=device),
        torsions=torch.zeros((t_pad,), dtype=torch.float32, device=device),
    )
