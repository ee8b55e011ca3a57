"""The yardstick of the CNN rescore's voxeliser: the least bytes each
scored pose's grids need, whatever implements them (voxelize_roofline).

Bytes: each scored pose's grids written once (channels x points^3 float32
a voxelisation group; the models of one group share their grids), the
receptor's atoms near the box read once a call (the harness's count of the
traced run, ctx.rec_atoms), and each pose's ligand atoms read once.  The
padding poses of a chunk are not counted.

The bytes alone decide the bound.  At gnina's maps a pose's grid is 12.4
MB, 3.7 us at 3.35 TB/s; the density's operations would take under 2.5 us
at the float32 peak even if every atom of the traffic's pocket reached the
whole cube of 1.5 r around it (dockbench/tests/test_dockbench_voxel_work.py
test_the_bytes_decide_the_bound), so they are not counted.

Peaks: dockbench/roofline.py's (3.35 TB/s).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from dockbench import roofline

GRID_VALUE_BYTES = 4
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def grid_groups(model_names: List[str], models_dir: str) -> List[dict]:
    """One entry a voxelisation group of the models: channels, points and
    resolution, from each model's `.spec.json` metadata (gnina's default
    maps where it has none)."""
    from dockbench.reference import cnn

    groups: Dict[tuple, dict] = {}
    for name in model_names:
        with open(os.path.join(models_dir, f"{name}.spec.json")) as f:
            meta = json.load(f).get("metadata", {}) or {}
        rec_table, rec_c = cnn.channel_table(meta.get("recmap", cnn.RECMAP))
        lig_table, lig_c = cnn.channel_table(meta.get("ligmap", cnn.LIGMAP))
        res = float(meta.get("resolution", 0.5))
        dim = float(meta.get("dimension", 23.5))
        scale = float(meta.get("radius_scaling", 1.0))
        key = (rec_table.tobytes(), lig_table.tobytes(), res, dim, scale)
        groups.setdefault(key, dict(
            channels=rec_c + lig_c, points=int(round(dim / res)) + 1,
            resolution=res))
    return list(groups.values())


def grid_bytes(poses: int, group: dict) -> int:
    return poses * group["channels"] * group["points"] ** 3 \
        * GRID_VALUE_BYTES


def bound_s(groups: List[dict], poses: int, calls: int, rec_atoms: int,
            lig_atoms: float) -> float:
    """The least time of voxelising `poses` poses of `lig_atoms` atoms each
    against `rec_atoms` receptor atoms over `calls` calls."""
    nbytes = sum(grid_bytes(poses, g) for g in groups) + roofline.ATOM_BYTES \
        * (calls * rec_atoms + poses * lig_atoms)
    return nbytes / roofline.HBM_RATE


def cell_config(argv) -> Optional[dict]:
    """The configuration of the cell that a run.py command line names
    (`--workload`), or None for any other command line."""
    name = None
    for i, arg in enumerate(argv):
        if arg == "--workload" and i + 1 < len(argv):
            name = argv[i + 1]
        elif arg.startswith("--workload="):
            name = arg.split("=", 1)[1]
    if name is None:
        return None
    from dockbench import lookup

    bench = lookup.benchmark(ROOT)
    try:
        cell = lookup.cell(bench, name)
    except KeyError:
        return None
    return lookup.config(bench, cell["config"], ROOT)


def window_bound_s(ctx, argv) -> Optional[float]:
    """The least time of the voxelising a traced run's window asked for:
    its scored poses (the benchmark's count) at the mean atoms of its
    written ligands, or None without both."""
    poses = sum(getattr(ctx.tracer, "scored", []))
    cfg = cell_config(argv)
    work = getattr(ctx, "ligand_work", None)
    if not poses or not work or cfg is None or not cfg.get("cnn_models"):
        return None
    groups = grid_groups(cfg["cnn_models"],
                         os.path.join(ROOT, cfg["models_dir"]))
    lig_atoms = float(np.mean([w["atoms"] for w in work.values()]))
    return bound_s(groups, poses, len(ctx.calls), ctx.rec_atoms, lig_atoms)
