"""Quaternion math on (..., 4) tensors (w, x, y, z).

Reproduces the reference quaternion semantics (reference:
gninasrc/lib/quaternion.h, quaternion.cu) — including the approximate
normalization and the rotation-vector increment convention used by the
optimizer — vectorized over arbitrary batch shapes.
"""

from __future__ import annotations

import math

import torch

from gnina_tpu_torch.constants import EPSILON_FL
from gnina_tpu_torch.device import resolve_device


def qmul(q, r):
    """Hamilton product, broadcasting over leading dims."""
    a, b, c, d = q.unbind(-1)
    ar, br, cr, dr = r.unbind(-1)
    return torch.stack([
        a * ar - b * br - c * cr - d * dr,
        a * br + b * ar + c * dr - d * cr,
        a * cr - b * dr + c * ar + d * br,
        a * dr + b * cr - c * br + d * ar,
    ], dim=-1)


def qconj(q):
    """Conjugate (w, -x, -y, -z)."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def qnormalize_approx(q, tolerance=1e-6):
    """Normalize only if norm deviates from 1 (quaternion.h:242-257)."""
    s = torch.sum(q * q, dim=-1)
    needs = torch.abs(s - 1.0) >= tolerance
    scale = torch.where(needs, 1.0 / torch.sqrt(torch.clamp(s, min=EPSILON_FL)),
                        1.0)
    return q * scale[..., None]


def normalize_angle(x):
    """Wrap angle into [-pi, pi] (quaternion.h:259-281)."""
    return x - 2.0 * math.pi * torch.round(x / (2.0 * math.pi))


def rotvec_to_quaternion(rotation):
    """Rotation vector (angle*axis) -> quaternion (quaternion.cu:32-43).

    Taylor-safe sinc form, differentiable at zero rotation — the gradient
    is taken with respect to a zero increment."""
    angle_sq = torch.sum(rotation * rotation, dim=-1)
    angle = torch.sqrt(torch.clamp(angle_sq, min=1e-30))
    small = angle < 1e-6
    half = angle / 2.0
    c = torch.cos(half)
    # sin(angle/2)/angle, series 0.5 - angle^2/48 near zero
    sinc_half = torch.where(small, 0.5 - angle_sq / 48.0, torch.sin(half) / angle)
    return torch.cat([c[..., None], sinc_half[..., None] * rotation], dim=-1)


def quaternion_to_rotvec(q):
    """Quaternion -> rotation vector in (-pi, pi] (quaternion.cu:46-62)."""
    c = torch.clamp(q[..., 0], -1.0, 1.0)
    angle = 2.0 * torch.arccos(c)
    angle = torch.where(angle > math.pi, angle - 2.0 * math.pi, angle)
    s = torch.sin(angle / 2.0)
    safe = torch.abs(s) >= EPSILON_FL
    scale = torch.where(safe, angle / torch.where(safe, s, 1.0), 0.0)
    inrange = (c > -1.0) & (c < 1.0)
    return torch.where(inrange[..., None], scale[..., None] * q[..., 1:], 0.0)


def quaternion_increment(q, rotation):
    """q <- normalize(quat(rotation) * q) (quaternion.cu:99-103)."""
    return qnormalize_approx(qmul(rotvec_to_quaternion(rotation), q))


def quaternion_to_matrix(q):
    """Rotation matrix (..., 3, 3) from quaternion (quaternion.h:326-364)."""
    a, b, c, d = q.unbind(-1)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    ab, ac, ad = a * b, a * c, a * d
    bc, bd, cd = b * c, b * d, c * d
    row0 = torch.stack([aa + bb - cc - dd, 2 * (-ad + bc), 2 * (ac + bd)], -1)
    row1 = torch.stack([2 * (ad + bc), aa - bb + cc - dd, 2 * (-ab + cd)], -1)
    row2 = torch.stack([2 * (-ac + bd), 2 * (ab + cd), aa - bb - cc + dd], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def qrotate(q, v):
    """Rotate vectors v (..., 3) by quaternion q (broadcasting).  Written as
    elementwise products and sums, never a matmul, so TF32 cannot apply."""
    m = quaternion_to_matrix(q)
    return (m * v[..., None, :]).sum(-1)


def random_orientation(shape, generator, device=None):
    """Uniform random unit quaternions (quaternion.cu:83-96)."""
    device = resolve_device(device)
    g = torch.randn(tuple(shape) + (4,), generator=generator,
                    dtype=torch.float32, device=device)
    n = torch.sqrt(torch.clamp(torch.sum(g * g, dim=-1), min=EPSILON_FL))
    return g / n[..., None]
