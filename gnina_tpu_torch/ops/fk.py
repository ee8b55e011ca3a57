"""Forward kinematics over the BFS-layered ligand tree.

Replacement for the recursive heterotree FK (reference:
gninasrc/lib/tree.h:322-326 set_conf, and the BFS-flattened GPU version
tree_gpu.cu).  Nodes are updated layer by layer with parent gathers;
masking keeps padded nodes inert.  Differentiating through this function
with respect to a zero rotation-vector increment reproduces the
reference's force->torque reverse pass (tree.h:374-393).
"""

from __future__ import annotations

import torch

from gnina_tpu_torch.ops import quat as Q
from gnina_tpu_torch.types import Conf, LigandData


def rows(x, idx):
    """x (..., R, C) at rows idx: one index vector (R',) for every batch
    entry, or per entry (..., R') when the ligand tensors carry the batch
    dimensions too (ops.energy.lane_ligands)."""
    if idx.dim() == 1:
        return x[..., idx, :]
    idx = idx.expand(x.shape[:-2] + idx.shape[-1:])
    return torch.gather(x, -2, idx[..., None].expand(idx.shape + x.shape[-1:]))


def fk_node_frames(lig: LigandData, conf: Conf, max_layers: int):
    """Per-node (origin (..., M, 3), quaternion (..., M, 4)) for confs with
    any leading batch shape; the ligand's tensors may carry the same
    leading dimensions (one ligand per pose)."""
    m = lig.parent.shape[-1]
    batch = conf.position.shape[:-1]
    dev = conf.position.device
    row0 = torch.arange(m, device=dev) == 0
    origins = torch.where(row0[:, None], conf.position[..., None, :],
                          torch.zeros((), device=dev))
    ident = torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev)
    quats = torch.where(row0[:, None], conf.orientation[..., None, :], ident)
    origins = origins.expand(batch + (m, 3))
    quats = quats.expand(batch + (m, 4))

    # torsion for node i (i>=1) is torsions[i-1]
    torsions = torch.cat([torch.zeros(batch + (1,), device=dev),
                          conf.torsions], dim=-1)
    half = 0.5 * Q.normalize_angle(torsions)
    cos_h = torch.cos(half)[..., None]
    sin_h = torch.sin(half)[..., None]

    parentc = torch.clamp(lig.parent, min=0)
    is_root_child = (lig.parent < 0)[..., None]
    for layer in range(1, max_layers + 1):
        p_origin = torch.where(is_root_child, 0.0, rows(origins, parentc))
        p_quat = torch.where(is_root_child, ident, rows(quats, parentc))
        # qrotate twice with one rotation matrix (the same products)
        p_rot = Q.quaternion_to_matrix(p_quat)
        new_origin = p_origin + (p_rot * lig.rel_origin[..., None, :]).sum(-1)
        axis = (p_rot * lig.rel_axis[..., None, :]).sum(-1)
        # angle_to_quaternion(axis, torsion) with axis unit-length
        tq = torch.cat([cos_h, sin_h * axis], dim=-1)
        new_quat = Q.qnormalize_approx(Q.qmul(tq, p_quat))
        upd = (lig.layer == layer)[..., None]
        origins = torch.where(upd, new_origin, origins)
        quats = torch.where(upd, new_quat, quats)
    return origins, quats


def fk_coords(lig: LigandData, conf: Conf, max_layers: int):
    """Atom lab coordinates (..., N, 3).  Static (inflex) atoms bypass FK:
    their local_coords hold absolute positions."""
    origins, quats = fk_node_frames(lig, conf, max_layers)
    node = lig.node_id
    moved = rows(origins, node) + Q.qrotate(rows(quats, node),
                                            lig.local_coords)
    return torch.where(lig.movable_mask[..., None], moved, lig.local_coords)


def conf_increment(conf: Conf, delta, factor) -> Conf:
    """conf.increment(change, factor) (conf.h:113-118,385-394).

    delta is a (..., 6+T) change vector: [dpos(3), rotvec(3), dtors(T)].
    Torsion increments are angle-normalized before and after adding."""
    factor = torch.as_tensor(factor, dtype=delta.dtype, device=delta.device)
    f = factor[..., None] if factor.dim() else factor
    pos = conf.position + f * delta[..., :3]
    quat = Q.quaternion_increment(conf.orientation, f * delta[..., 3:6])
    tors = Q.normalize_angle(conf.torsions
                             + Q.normalize_angle(f * delta[..., 6:]))
    return Conf(position=pos, orientation=quat, torsions=tors)


def conf_with_increment_var(conf: Conf, eps) -> Conf:
    """Differentiable zero increment for gradient extraction: at eps=0 the
    identity, and d(energy)/d(eps) is the reference's `change` layout
    [force(3), torque(3), dtorsions(T)]."""
    pos = conf.position + eps[..., :3]
    quat = Q.qmul(Q.rotvec_to_quaternion(eps[..., 3:6]), conf.orientation)
    tors = conf.torsions + eps[..., 6:]
    return Conf(position=pos, orientation=quat, torsions=tors)
