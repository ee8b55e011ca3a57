"""In-repo docking fixtures shared by the tests and chip_smoke.py (private).

- The ligand: the CHEMBL371307 record of the repo's minout.sdf.
- A synthetic receptor made from a seed: heavy atoms on a jittered cubic
  lattice at protein density (one atom per ~20 A^3, ~2.7 A spacing, far
  enough apart that no bonds are perceived), C/N/O/S at roughly protein
  ratios, filling a cube around the ligand with a spherical cavity carved
  at the ligand's centre.  It is written as PDB text and read back through
  Receptor.from_file, the normal entry point.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

from gnina_tpu_torch.chem import ingest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIGAND_SDF = os.path.join(REPO, "minout.sdf")

# element, fraction (heavy atoms of a typical protein)
_ELEMENTS = (("C", 0.63), ("N", 0.17), ("O", 0.19), ("S", 0.01))


def ligand(path: str = LIGAND_SDF):
    """The first ligand record of `path` as a LigandStruct."""
    return next(ingest.iter_ligands(path))


def receptor_pdb_text(center, seed: int, cube: float = 40.0,
                      spacing: float = 2.7, cavity: float = 7.0,
                      jitter: float = 0.15) -> str:
    """PDB text of the synthetic receptor around `center`."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float64)
    ticks = np.arange(-cube / 2, cube / 2 + 1e-6, spacing)
    grid = np.stack(np.meshgrid(ticks, ticks, ticks, indexing="ij"),
                    -1).reshape(-1, 3)
    grid = grid + rng.uniform(-jitter, jitter, grid.shape)
    grid = grid[np.linalg.norm(grid, axis=1) > cavity] + center
    symbols = np.array([e for e, _ in _ELEMENTS])
    probs = np.array([p for _, p in _ELEMENTS])
    elem = symbols[rng.choice(len(symbols), size=len(grid), p=probs / probs.sum())]
    lines = []
    for i, (xyz, el) in enumerate(zip(grid, elem)):
        serial = i % 100000
        resnum = (i // 8) % 10000
        lines.append(
            f"HETATM{serial:5d} {el:<3s}  UNK A{resnum:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
            f"          {el:>2s}")
    lines.append("END")
    return "\n".join(lines) + "\n"


def receptor(center, seed: int, **kw) -> ingest.Receptor:
    """The synthetic receptor, read through Receptor.from_file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "synthetic_receptor.pdb")
        with open(path, "w") as f:
            f.write(receptor_pdb_text(center, seed, **kw))
        return ingest.Receptor.from_file(path)


def ligand_center(lig) -> np.ndarray:
    from gnina_tpu_torch.constants import IS_HYDROGEN

    heavy = lig.orig_coords[~IS_HYDROGEN[lig.types]]
    return 0.5 * (heavy.min(axis=0) + heavy.max(axis=0))


def packed_poses(rng, n: int, lo, hi, lig, m: int, device, kind: str):
    """Packed (rigid (n, 8), tors (n, m)) poses of `lig` drawn from the
    numpy Generator `rng`: uniform in the box [lo, hi] ("random"), or small
    jitters of the crystal pose ("perturbed")."""
    import torch

    from gnina_tpu_torch.ops.fused_dock import conf_to_packed
    from gnina_tpu_torch.types import Conf

    t = m - 1
    if kind == "random":
        pos = rng.uniform(lo, hi, (n, 3))
        q = rng.normal(size=(n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        tors = rng.uniform(-np.pi, np.pi, (n, t))
    else:
        pos = lig.orig_coords[0][None] + 0.5 * rng.normal(size=(n, 3))
        axis = 0.2 * rng.normal(size=(n, 3))
        ang = np.linalg.norm(axis, axis=1, keepdims=True)
        q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang],
                           axis=1)
        tors = 0.3 * rng.normal(size=(n, t))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return conf_to_packed(Conf(f(pos), f(q), f(tors)), m)


def system(seed: int = 0, box: float = 20.0, **kw):
    """(receptor, ligand, box center, box size): a `box`-A cubic search box
    centred as autobox_ligand centres it (a typical docking box edge is
    20-25 A; pruned at the 8 A cutoff it keeps ~2,000 receptor atoms)."""
    lig = ligand()
    center, _size = ingest.autobox_ligand(LIGAND_SDF)
    rec = receptor(ligand_center(lig), seed, **kw)
    return rec, lig, center, np.full(3, box, np.float32)
