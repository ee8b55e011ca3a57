"""The screen's receptor: a seeded lattice pocket at protein density.

Heavy atoms sit on a jittered cubic lattice (one atom per about 20 A^3 at
2.7 A spacing, far enough apart that no bonds are perceived), C/N/O/S at
protein ratios, filling a cube with a spherical cavity carved at its centre.
It is written as PDB HETATM records.  The pattern is that of the port's test
fixture (`gnina_tpu_torch/_fixtures.py`), rewritten here so that the
benchmark imports nothing of the port.
"""

from __future__ import annotations

import numpy as np

# element, share of the heavy atoms of a typical protein
ELEMENTS = (("C", 0.63), ("N", 0.17), ("O", 0.19), ("S", 0.01))


def lattice(center, seed: int, cube: float, spacing: float, cavity: float,
            jitter: float):
    """(points (R, 3), element symbols (R,))."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float64)
    ticks = np.arange(-cube / 2, cube / 2 + 1e-6, spacing)
    grid = np.stack(np.meshgrid(ticks, ticks, ticks, indexing="ij"),
                    -1).reshape(-1, 3)
    grid = grid + rng.uniform(-jitter, jitter, grid.shape)
    grid = grid[np.linalg.norm(grid, axis=1) > cavity] + center
    symbols = np.array([e for e, _ in ELEMENTS])
    probs = np.array([p for _, p in ELEMENTS])
    elem = symbols[rng.choice(len(symbols), size=len(grid),
                              p=probs / probs.sum())]
    return grid, elem


def pdb_text(points, elems) -> str:
    lines = []
    for i, (xyz, el) in enumerate(zip(points, elems)):
        lines.append(
            f"HETATM{i % 100000:5d} {el:<3s}  UNK A{(i // 8) % 10000:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
            f"          {el:>2s}")
    return "\n".join(lines + ["END"]) + "\n"
