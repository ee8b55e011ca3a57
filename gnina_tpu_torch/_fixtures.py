"""In-repo docking fixtures shared by the tests and chip_smoke.py (private).

- The ligand: the CHEMBL371307 record of the repo's minout.sdf.
- A synthetic receptor made from a seed: heavy atoms on a jittered cubic
  lattice at protein density (one atom per ~20 A^3, ~2.7 A spacing, far
  enough apart that no bonds are perceived), C/N/O/S at roughly protein
  ratios, filling a cube around the ligand with a spherical cavity carved
  at the ligand's centre.  It is written as PDB text and read back through
  Receptor.from_file, the normal entry point.
- A toy CNN made from a seed (toy_cnn): the default typers' 28 channels on
  a 13^3 grid at 1 A, one convolution, relu, a max pool and the pose and
  affinity heads, as a converted model's spec and numpy weights.
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


def _lattice(center, seed: int, cube: float, spacing: float, cavity: float,
             jitter: float):
    """The synthetic receptor's (points (R, 3), element symbols (R,))."""
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
    return grid, elem


def _hetatm_lines(grid, elem, chain: str = "A"):
    lines = []
    for i, (xyz, el) in enumerate(zip(grid, elem)):
        serial = i % 100000
        resnum = (i // 8) % 10000
        lines.append(
            f"HETATM{serial:5d} {el:<3s}  UNK {chain}{resnum:4d}    "
            f"{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}  1.00  0.00"
            f"          {el:>2s}")
    return lines


def receptor_pdb_text(center, seed: int, cube: float = 40.0,
                      spacing: float = 2.7, cavity: float = 7.0,
                      jitter: float = 0.15) -> str:
    """PDB text of the synthetic receptor around `center`."""
    grid, elem = _lattice(center, seed, cube, spacing, cavity, jitter)
    return "\n".join(_hetatm_lines(grid, elem) + ["END"]) + "\n"


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


# -- a receptor with real residues (flex and covalent docking) ---------------
#
# Standard residues built from internal coordinates: bond lengths (A) and
# bond angles (degrees) after Engh & Huber (1991), Acta Cryst. A47, 392.
# Each entry places one atom from three earlier ones (a, b, c): |c-atom| =
# bond, angle b-c-atom, dihedral a-b-c-atom.  Dihedrals are chi angles of
# common rotamers; "chiN+180" keeps the second atom of a branch anti to the
# first.

_BACKBONE = (
    ("O", "O", ("N", "CA", "C"), 1.231, 120.1, 180.0),
    ("CB", "C", ("N", "C", "CA"), 1.530, 110.1, 122.6),
)
_SIDE_CHAINS = {
    "ALA": (),
    "CYS": (("SG", "S", ("N", "CA", "CB"), 1.808, 114.4, -60.0),),
    "SER": (("OG", "O", ("N", "CA", "CB"), 1.417, 111.1, 60.0),),
    "LYS": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, -60.0),
            ("CD", "C", ("CA", "CB", "CG"), 1.520, 111.3, 180.0),
            ("CE", "C", ("CB", "CG", "CD"), 1.520, 111.3, 180.0),
            ("NZ", "N", ("CG", "CD", "CE"), 1.489, 111.9, 180.0)),
    "GLU": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, -60.0),
            ("CD", "C", ("CA", "CB", "CG"), 1.516, 112.6, 180.0),
            ("OE1", "O", ("CB", "CG", "CD"), 1.249, 118.4, 0.0),
            ("OE2", "O", ("CB", "CG", "CD"), 1.249, 118.4, 180.0)),
    "ARG": (("CG", "C", ("N", "CA", "CB"), 1.520, 114.1, -60.0),
            ("CD", "C", ("CA", "CB", "CG"), 1.520, 111.3, 180.0),
            ("NE", "N", ("CB", "CG", "CD"), 1.460, 112.0, 180.0),
            ("CZ", "C", ("CG", "CD", "NE"), 1.329, 124.2, 180.0),
            ("NH1", "N", ("CD", "NE", "CZ"), 1.326, 120.0, 0.0),
            ("NH2", "N", ("CD", "NE", "CZ"), 1.326, 120.0, 180.0)),
    "PHE": (("CG", "C", ("N", "CA", "CB"), 1.502, 113.8, -60.0),
            ("CD1", "C", ("CA", "CB", "CG"), 1.384, 120.7, 90.0),
            ("CD2", "C", ("CA", "CB", "CG"), 1.384, 120.7, -90.0),
            ("CE1", "C", ("CB", "CG", "CD1"), 1.382, 120.7, 180.0),
            ("CE2", "C", ("CB", "CG", "CD2"), 1.382, 120.7, 180.0),
            ("CZ", "C", ("CG", "CD1", "CE1"), 1.382, 120.0, 0.0)),
    "TYR": (("CG", "C", ("N", "CA", "CB"), 1.512, 113.8, -60.0),
            ("CD1", "C", ("CA", "CB", "CG"), 1.389, 120.8, 90.0),
            ("CD2", "C", ("CA", "CB", "CG"), 1.389, 120.8, -90.0),
            ("CE1", "C", ("CB", "CG", "CD1"), 1.382, 121.2, 180.0),
            ("CE2", "C", ("CB", "CG", "CD2"), 1.382, 121.2, 180.0),
            ("CZ", "C", ("CG", "CD1", "CE1"), 1.378, 119.6, 0.0),
            ("OH", "O", ("CD1", "CE1", "CZ"), 1.376, 119.9, 180.0)),
}

# (resname, resid, least distance (A) from any residue atom to the
# ligand): four flexible residues within 3.5 A, ALA within it too (the
# selection skips it: inflexible), three farther out
FLEX_RESIDUES = (
    ("ARG", 11, 4.6), ("LYS", 23, 5.0), ("GLU", 37, 3.1), ("SER", 45, 2.9),
    ("TYR", 52, 4.8), ("PHE", 68, 3.3), ("CYS", 74, 3.0), ("ALA", 89, 3.2),
)
FLEX_CHAIN = "A"
# the residues that --flexdist 3.5 around the fixture's ligand selects,
# closest first
FLEXDIST_35 = ((FLEX_CHAIN, 45, ""), (FLEX_CHAIN, 74, ""),
               (FLEX_CHAIN, 37, ""), (FLEX_CHAIN, 68, ""))

# an acrylamide warhead with a tail (C=C-C(=O)-N-C-C) for covalent docking
# onto the fixture's CYS SG; chem.covalent places it, so its
# drawn coordinates are arbitrary
ACRYLAMIDE_SDF = """warhead
  prog
  comment
  7  6  0  0  0  0  0  0  0  0999 V2000
    8.0000    4.0000    0.0000 C   0  0
    9.3300    4.0000    0.0000 C   0  0
   10.0000    5.2000    0.0000 C   0  0
    9.4000    6.3000    0.0000 O   0  0
   11.3500    5.2000    0.0000 N   0  0
   12.0500    6.4500    0.0000 C   0  0
   13.5500    6.3000    0.0000 C   0  0
  1  2  2  0
  2  3  1  0
  3  4  2  0
  3  5  1  0
  5  6  1  0
  6  7  1  0
M  END
$$$$
"""


def _place(a, b, c, bond: float, angle: float, dihedral: float):
    """The atom bonded to c at `bond`, with angle b-c-x and dihedral
    a-b-c-x (degrees): the natural extension reference frame."""
    bc = (c - b) / np.linalg.norm(c - b)
    n = np.cross(b - a, bc)
    n /= np.linalg.norm(n)
    m = np.cross(n, bc)
    th, ph = np.radians(angle), np.radians(dihedral)
    return (c - bond * np.cos(th) * bc + bond * np.sin(th) * np.cos(ph) * m
            + bond * np.sin(th) * np.sin(ph) * n)


def residue_coords(resname: str):
    """[(atom name, element, xyz)] of one residue in its own frame: N at
    the origin, CA on x, C in the xy plane."""
    n_ca, ca_c, n_ca_c = 1.458, 1.525, np.radians(111.2)
    xyz = {"N": np.zeros(3), "CA": np.array([n_ca, 0.0, 0.0]),
           "C": np.array([n_ca - ca_c * np.cos(n_ca_c),
                          ca_c * np.sin(n_ca_c), 0.0])}
    elem = {"N": "N", "CA": "C", "C": "C"}
    atoms = _BACKBONE if resname != "GLY" else _BACKBONE[:1]
    for name, el, (a, b, c), bond, ang, dih in atoms + _SIDE_CHAINS[resname]:
        xyz[name] = _place(xyz[a], xyz[b], xyz[c], bond, ang, dih)
        elem[name] = el
    return [(k, elem[k], v) for k, v in xyz.items()]


def _placed_residues(lig_coords, center):
    """Each residue of FLEX_RESIDUES on a ray from the cavity centre along
    a cube-corner direction, its side chain pointing at the centre, moved
    along the ray until its least distance to the ligand is the listed one
    (bisection)."""
    from gnina_tpu_torch.chem.covalent import _rotation_between

    corners = np.array([[sx, sy, sz] for sx in (1, -1) for sy in (1, -1)
                        for sz in (1, -1)], np.float64) / np.sqrt(3.0)
    placed = []
    for (resname, resid, dist), u in zip(FLEX_RESIDUES, corners):
        atoms = residue_coords(resname)
        pos = np.array([p for _, _, p in atoms])
        ca = pos[1]
        tip = pos[3:].mean(axis=0) if len(pos) > 4 else pos[-1]
        rot = _rotation_between(tip - ca, -u)
        local = (pos - ca) @ rot.T

        def least(r):
            at = local + center + r * u
            return np.sqrt(((at[:, None] - lig_coords[None]) ** 2)
                           .sum(-1)).min()

        lo, hi = 0.0, 40.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if least(mid) < dist else (lo, mid)
        at = local + center + hi * u
        placed.append((resname, resid, [(n, e, p) for (n, e, _), p
                                        in zip(atoms, at)]))
    return placed


def flex_receptor_pdb_text(lig, seed: int, cube: float = 40.0,
                           spacing: float = 2.7, cavity: float = 7.0,
                           jitter: float = 0.15) -> str:
    """PDB text of the synthetic receptor around `lig` (a LigandStruct)
    whose cavity is lined with the eight standard residues of
    FLEX_RESIDUES (ARG, LYS, GLU, SER, TYR, PHE, CYS, ALA; chain A, ATOM
    records, one residue a cube-corner direction, side chains pointing in).
    Lattice atoms within 3 A of a residue atom are dropped; the lattice
    keeps its HETATM UNK records, in chain Z so that its residue numbers
    never meet the real residues'.  --flexdist 3.5 around `lig` selects
    four residues, SER, CYS, GLU and PHE (FLEXDIST_35, closest first):
    ALA lies within 3.5 A too but is inflexible, and the selection skips
    it; ARG, LYS and TYR lie farther out."""
    center = ligand_center(lig)
    grid, elem = _lattice(center, seed, cube, spacing, cavity, jitter)
    residues = _placed_residues(np.asarray(lig.orig_coords, np.float64),
                                center)
    res_xyz = np.array([p for _, _, atoms in residues for _, _, p in atoms])
    d = np.sqrt(((grid[:, None] - res_xyz[None]) ** 2).sum(-1)).min(axis=1)
    keep = d > 3.0
    lines = []
    serial = 1
    for resname, resid, atoms in residues:
        for name, el, p in atoms:
            nm = f" {name:<3s}" if len(name) < 4 else name
            lines.append(
                f"ATOM  {serial:5d} {nm} {resname} {FLEX_CHAIN}{resid:4d}    "
                f"{p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}  1.00  0.00"
                f"          {el:>2s}")
            serial += 1
    lines += _hetatm_lines(grid[keep], elem[keep], chain="Z")
    return "\n".join(lines + ["END"]) + "\n"


def flex_receptor(lig, seed: int, **kw) -> ingest.Receptor:
    """flex_receptor_pdb_text read through Receptor.from_file."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "flex_receptor.pdb")
        with open(path, "w") as f:
            f.write(flex_receptor_pdb_text(lig, seed, **kw))
        return ingest.Receptor.from_file(path)


def flex_pdbqt_text(rec: ingest.Receptor, keys) -> str:
    """A --flex PDBQT of the residues `keys` of `rec`: per residue a
    BEGIN_RES block whose ROOT is CA and whose BRANCHes follow the side
    chain's rotatable bonds as extract_flex_residue cuts them (the layout
    of a flexible-residue file written by AutoDockTools)."""
    from gnina_tpu_torch.chem import flexinfo
    from gnina_tpu_torch.chem.pdbqt import _format_atom_line
    from gnina_tpu_torch.constants import DEFAULT_TABLE

    out = []
    for key in keys:
        fr = flexinfo.extract_flex_residue(rec, key)
        f_n = len(fr.types)
        types = np.concatenate([fr.types, fr.inflex_types])
        coords = np.concatenate([fr.coords, fr.inflex_coords])
        atoms = fr.atoms_mol.atoms          # movable in node order, inflex
        serial = {}

        def emit(i):
            serial[i] = len(serial) + 1
            out.append(_format_atom_line(serial[i], atoms[i], coords[i],
                                         DEFAULT_TABLE.ad_names[types[i]]))

        def branch(node, anchor):
            ps = serial[anchor]
            out.append(f"BRANCH {ps:3d} {len(serial) + 1:3d}")
            members = [i for i in range(f_n) if fr.node_of_atom[i] == node]
            for i in members:               # the bond atom first
                emit(i)
            for c in np.nonzero(fr.parent == node)[0]:
                branch(int(c), int(fr.parent_anchor_local[c]))
            out.append(f"ENDBRANCH {ps:3d} {serial[members[0]]:3d}")

        out.append(f"BEGIN_RES {fr.resname} {key[0]} {key[1]:3d}")
        out.append("ROOT")
        emit(f_n)                           # CA
        out.append("ENDROOT")
        for root in np.nonzero(fr.parent < 0)[0]:
            branch(int(root), f_n)
        out.append(f"END_RES {fr.resname} {key[0]} {key[1]:3d}")
    return "\n".join(out) + "\n"


def toy_cnn(seed: int = 0, width: int = 4):
    """(spec, params) of a small converted CNN made from `seed`: input
    (B, 28, 13, 13, 13), a 3^3 convolution to `width` channels, relu, a 2^3
    max pool, and the linear pose (log-softmax) and affinity heads, in the
    op-list format of the repository's converted models (metadata:
    resolution 1 A, dimension 12 A, the default typers)."""
    rng = np.random.default_rng(seed)
    flat = width * 6 ** 3
    params = {
        "cw": rng.normal(scale=0.2, size=(width, 28, 3, 3, 3)),
        "cb": rng.normal(scale=0.05, size=(width,)),
        "pw": rng.normal(scale=0.1, size=(2, flat)),
        "pb": np.zeros(2),
        "aw": rng.normal(scale=0.1, size=(1, flat)),
        "ab": np.zeros(1)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}

    def op(kind, out, *args):
        return {"op": kind, "out": out, "in": [list(a) for a in args]}

    ops = [
        op("aten::_convolution", "c", ("ref", "x"), ("param", "cw"),
           ("param", "cb"), ("const", [1, 1, 1]), ("const", [1, 1, 1]),
           ("const", [1, 1, 1])),
        op("aten::relu", "r", ("ref", "c")),
        op("aten::max_pool3d", "m", ("ref", "r"), ("const", [2, 2, 2]),
           ("const", [2, 2, 2]), ("const", [0, 0, 0])),
        op("aten::view", "f", ("ref", "m"), ("const", [-1, flat])),
        op("aten::linear", "p", ("ref", "f"), ("param", "pw"),
           ("param", "pb")),
        op("aten::log_softmax", "pose", ("ref", "p"), ("const", 1)),
        op("aten::linear", "a", ("ref", "f"), ("param", "aw"),
           ("param", "ab")),
        op("aten::squeeze", "aff", ("ref", "a"), ("const", -1))]
    spec = {"input": "x", "ops": ops,
            "output": [["ref", "pose"], ["ref", "aff"]],
            "metadata": {"resolution": 1.0, "dimension": 12.0}}
    return spec, params
