"""The yardstick of the kernels' rooflines and of the step's share of the
chip's peak: the work the inputs need, whatever implements it.

Operations of one evaluation of a pose: every heavy (ligand atom, receptor
atom) pair closer than the 8 A cutoff, and every intramolecular pair that
can move, each at the Vina terms' operations with or without the
derivative.  A kernel that tests every receptor pair and one that tests
only those inside the cutoff do the same counted work, so a cell list moves
the kernel's share and not the yardstick.  The pairs inside the cutoff are
counted on the batch's written poses, an estimate of those the search
visits.

Bytes of one launch: the receptor atoms within reach of the box and the
ligands' packed atoms and pairs read once, and the lanes' poses (and, for
an MC window, its stream of completed steps) read and written once.

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s in float32 outside the
tensor cores (the port runs with TF32 off) and 3.35 TB/s of HBM3, at the
full 700 W.
"""

from __future__ import annotations

import numpy as np

FP32_PEAK = 67e12
HBM_RATE = 3.35e12
CUTOFF = 8.0
# float32 operations of one pair's five Vina terms with their weights, the
# cutoff and the sum, from the distance on (each exp or sqrt one operation):
# the value alone, and the value with the derivative along the pair
OPS_PAIR_VALUE = 46
OPS_PAIR_DERIV = 72
ATOM_BYTES = 16          # x, y, z and a type, four bytes each
PAIR_BYTES = 8           # two atom indices


def in_cutoff_pairs(lig_heavy_xyz: np.ndarray, rec_heavy_xyz: np.ndarray,
                    cutoff: float = CUTOFF) -> np.ndarray:
    """(P,) heavy pairs closer than the cutoff, for P poses (P, N, 3)."""
    out = np.zeros(len(lig_heavy_xyz), np.int64)
    for p, x in enumerate(lig_heavy_xyz):
        lo, hi = x.min(0) - cutoff, x.max(0) + cutoff
        r = rec_heavy_xyz[np.all((rec_heavy_xyz >= lo)
                                 & (rec_heavy_xyz <= hi), axis=1)]
        d2 = ((x[:, None, :] - r[None]) ** 2).sum(-1)
        out[p] = int((d2 < cutoff * cutoff).sum())
    return out


def eval_ops(pairs, values, derivs) -> float:
    """Operations of `values` value evaluations and `derivs` value and
    derivative evaluations over `pairs` pairs (arrays over lanes)."""
    pairs = np.asarray(pairs, np.float64)
    return float((pairs * (np.asarray(values, np.float64) * OPS_PAIR_VALUE
                           + np.asarray(derivs, np.float64)
                           * OPS_PAIR_DERIV)).sum())


def launch_bytes(rec_atoms: int, lanes: int, lig_atoms: int,
                 intra_pairs: int, torsions: int, stream_rows: int = 0) -> int:
    """Bytes a launch over `lanes` lanes must move at the least."""
    pose = (7 + torsions) * 4
    return (rec_atoms * ATOM_BYTES
            + lanes * (lig_atoms * ATOM_BYTES + intra_pairs * PAIR_BYTES)
            + lanes * 2 * pose + lanes * stream_rows * (pose + 12))


def bound_s(ops: float, nbytes: float) -> float:
    """The least time of `ops` operations moving `nbytes` bytes."""
    return max(ops / FP32_PEAK, nbytes / HBM_RATE)


def model_flops(spec: dict, params: dict, channels: int, points: int) -> float:
    """Floating-point operations of one pose through a converted model
    (convolutions and matrix products, two a multiply-add), counted on
    tensors without storage."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from dockbench.reference.runtime import execute

    meta = {k: torch.empty(tuple(v.shape), device="meta")
            for k, v in params.items()}
    x = torch.empty((1, channels, points, points, points), device="meta")
    with FlopCounterMode(display=False) as fc:
        execute(spec, meta, x)
    return float(fc.get_total_flops())
