"""Plain chemistry for the reference: V2000 SDF and PDB reading, bond
perception, smina atom typing, rotatable bonds, and the match of a written
pose's atoms to the input ligand's.

Typing follows gnina's obatom_to_smina_type (atom_constants.h:280-349) on
the molecules the traffic makes: aromatic carbons are those of flat five-
or six-membered rings; O is an acceptor, N one unless it is an amide
nitrogen or has four connections, S one only with a double bond; an N, O
or S with a bonded or implicit hydrogen is a donor; a carbon bonded to a
heteroatom is not a hydrophobe.  Imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

TYPE_NAMES = (
    "Hydrogen", "PolarHydrogen", "AliphaticCarbonXSHydrophobe",
    "AliphaticCarbonXSNonHydrophobe", "AromaticCarbonXSHydrophobe",
    "AromaticCarbonXSNonHydrophobe", "Nitrogen", "NitrogenXSDonor",
    "NitrogenXSDonorAcceptor", "NitrogenXSAcceptor", "Oxygen",
    "OxygenXSDonor", "OxygenXSDonorAcceptor", "OxygenXSAcceptor", "Sulfur",
    "SulfurAcceptor", "Phosphorus", "Fluorine", "Chlorine", "Bromine",
    "Iodine", "Magnesium", "Manganese", "Zinc", "Calcium", "Iron",
    "GenericMetal", "Boron")
T = {n: i for i, n in enumerate(TYPE_NAMES)}
# per type: X-Score radius, hydrophobe, donor, acceptor (atom_constants.h)
XS_RADIUS = np.array([0.37, 0.37, 1.9, 1.9, 1.9, 1.9, 1.8, 1.8, 1.8, 1.8,
                      1.7, 1.7, 1.7, 1.7, 2.0, 2.0, 2.1, 1.5, 1.8, 2.0, 2.2,
                      1.2, 1.2, 1.2, 1.2, 1.2, 1.2, 1.92])
XS_HYDROPHOBE = np.zeros(28, bool)
XS_HYDROPHOBE[[2, 4, 17, 18, 19, 20, 27]] = True
XS_DONOR = np.zeros(28, bool)
XS_DONOR[[7, 8, 11, 12, 21, 22, 23, 24, 25, 26]] = True
XS_ACCEPTOR = np.zeros(28, bool)
XS_ACCEPTOR[[8, 9, 12, 13]] = True
IS_H = np.zeros(28, bool)
IS_H[[0, 1]] = True

COVALENT = {"H": 0.37, "C": 0.77, "N": 0.75, "O": 0.73, "S": 1.02,
            "F": 0.71, "Cl": 0.99}
VALENCE = {"C": 4, "N": 3, "O": 2, "S": 2, "F": 1, "Cl": 1}


@dataclasses.dataclass
class Mol:
    name: str
    elems: List[str]
    coords: np.ndarray                       # (N, 3) float64
    bonds: List[Tuple[int, int, int]]        # (a, b, order); 4 = aromatic
    props: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        self.adj = [[] for _ in self.elems]
        for a, b, o in self.bonds:
            self.adj[a].append((b, o))
            self.adj[b].append((a, o))

    @property
    def heavy(self) -> np.ndarray:
        return np.array([e != "H" for e in self.elems])

    def heavy_degree(self, i: int) -> int:
        return sum(1 for j, _ in self.adj[i] if self.elems[j] != "H")


def parse_sdf(text: str) -> List[Mol]:
    out = []
    for block in text.split("$$$$\n"):
        if not block.strip():
            continue
        lines = block.split("\n")
        n, nb = int(lines[3][0:3]), int(lines[3][3:6])
        elems, xyz, bonds = [], [], []
        for ln in lines[4:4 + n]:
            xyz.append([float(ln[0:10]), float(ln[10:20]), float(ln[20:30])])
            elems.append(ln[31:34].strip())
        for ln in lines[4 + n:4 + n + nb]:
            bonds.append((int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])))
        props = {}
        rest = lines[4 + n + nb:]
        for i, ln in enumerate(rest):
            if ln.startswith(">") and "<" in ln and i + 1 < len(rest):
                props[ln[ln.index("<") + 1:ln.rindex(">")]] = rest[i + 1]
        out.append(Mol(lines[0].strip(), elems, np.array(xyz, np.float64),
                       bonds, props))
    return out


def parse_pdb(text: str) -> Mol:
    elems, xyz = [], []
    for ln in text.splitlines():
        if ln[:6] in ("ATOM  ", "HETATM"):
            xyz.append([float(ln[30:38]), float(ln[38:46]), float(ln[46:54])])
            e = ln[76:78].strip()
            elems.append(e[0] + e[1:].lower())
    x = np.array(xyz, np.float64)
    return Mol("receptor", elems, x, perceive_bonds(elems, x))


def perceive_bonds(elems, x, tolerance: float = 0.45):
    """Single bonds between atoms closer than their covalent radii plus the
    tolerance, through a cell grid."""
    r = np.array([COVALENT.get(e, 1.0) for e in elems])
    reach = 2 * r.max() + tolerance
    cell = np.floor(x / reach).astype(np.int64)
    grid: Dict[tuple, List[int]] = {}
    for i, c in enumerate(map(tuple, cell)):
        grid.setdefault(c, []).append(i)
    bonds = []
    for i, c in enumerate(map(tuple, cell)):
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    for j in grid.get((c[0] + dx, c[1] + dy, c[2] + dz), ()):
                        if j > i and np.linalg.norm(x[i] - x[j]) \
                                < r[i] + r[j] + tolerance:
                            bonds.append((i, j, 1))
    return bonds


def rings(mol: Mol, sizes=(5, 6)) -> List[List[int]]:
    """Simple cycles of the given sizes."""
    found = set()
    out = []

    def walk(path):
        for j, _ in mol.adj[path[-1]]:
            if j == path[0] and len(path) in sizes:
                key = frozenset(path)
                if key not in found:
                    found.add(key)
                    out.append(list(path))
            elif j not in path and len(path) < max(sizes):
                walk(path + [j])

    for i in range(len(mol.elems)):
        if mol.elems[i] != "H":
            walk([i])
    return out


def aromatic_atoms(mol: Mol) -> np.ndarray:
    """Atoms of flat (within 0.25 A of their plane) 5- or 6-membered rings
    of C, N, O, S with at most three heavy neighbours each."""
    aro = np.zeros(len(mol.elems), bool)
    for ring in rings(mol):
        if any(mol.elems[i] not in ("C", "N", "O", "S")
               or mol.heavy_degree(i) > 3 for i in ring):
            continue
        p = mol.coords[ring] - mol.coords[ring].mean(axis=0)
        normal = np.linalg.svd(p)[2][2]
        if np.abs(p @ normal).max() <= 0.25:
            aro[ring] = True
    return aro


def _amide_n(mol: Mol, i: int) -> bool:
    for j, _ in mol.adj[i]:
        for k, o in mol.adj[j]:
            if k != i and mol.elems[k] == "O" and o == 2:
                return True
    return False


def smina_types(mol: Mol) -> np.ndarray:
    aro = aromatic_atoms(mol)
    out = np.zeros(len(mol.elems), np.int64)
    for i, e in enumerate(mol.elems):
        nb = mol.adj[i]
        if e == "H":
            out[i] = T["PolarHydrogen"]
            continue
        n_h = sum(1 for j, _ in nb if mol.elems[j] == "H")
        h_bonded = n_h > 0
        if not h_bonded and e in ("N", "O", "S"):
            order = sum(1.5 if (o == 4 or (aro[i] and aro[j])) else o
                        for j, o in nb)
            h_bonded = round(VALENCE[e] - order) > 0
        hetero = any(mol.elems[j] not in ("C", "H") for j, _ in nb)
        if e == "C":
            kind = "Aromatic" if aro[i] else "Aliphatic"
            out[i] = T[f"{kind}CarbonXS{'Non' if hetero else ''}Hydrophobe"]
        elif e == "N":
            acceptor = not (_amide_n(mol, i) or (aro[i] and len(nb) >= 3)
                            or len(nb) >= 4)
            if acceptor:
                out[i] = T["NitrogenXSDonorAcceptor" if h_bonded
                           else "NitrogenXSAcceptor"]
            else:
                out[i] = T["NitrogenXSDonor" if h_bonded else "Nitrogen"]
        elif e == "O":
            out[i] = T["OxygenXSDonorAcceptor" if h_bonded
                       else "OxygenXSAcceptor"]
        elif e == "S":
            out[i] = T["SulfurAcceptor" if any(o == 2 for _, o in nb)
                       else "Sulfur"]
        elif e == "F":
            out[i] = T["Fluorine"]
        elif e == "Cl":
            out[i] = T["Chlorine"]
        else:
            raise ValueError(f"element {e} outside the traffic's chemistry")
    return out


def rotatable_bonds(mol: Mol) -> List[Tuple[int, int]]:
    """Single bonds outside rings and amides between atoms with two or
    more heavy neighbours each."""
    ring_bond = set()
    for ring in rings(mol, sizes=(3, 4, 5, 6, 7, 8)):
        for k in range(len(ring)):
            a, b = ring[k], ring[(k + 1) % len(ring)]
            ring_bond.add((min(a, b), max(a, b)))
    out = []
    for a, b, o in mol.bonds:
        if o != 1 or (min(a, b), max(a, b)) in ring_bond:
            continue
        if "H" in (mol.elems[a], mol.elems[b]):
            continue
        pair = (mol.elems[a], mol.elems[b])
        if set(pair) == {"C", "N"}:
            c = a if pair[0] == "C" else b
            if any(mol.elems[k] == "O" and oo == 2 for k, oo in mol.adj[c]):
                continue
        if mol.heavy_degree(a) >= 2 and mol.heavy_degree(b) >= 2:
            out.append((a, b))
    return out


def atom_classes(mol: Mol, rounds: int = 6) -> List[str]:
    """Each atom's class under refinement of (element, neighbours' classes):
    atoms that a symmetry of the graph exchanges share a class, and in the
    traffic's trees and rings no others do."""
    cls = [e for e in mol.elems]
    for _ in range(rounds):
        cls = [cls[i] + "(" + ",".join(sorted(f"{o}{cls[j]}"
                                              for j, o in mol.adj[i])) + ")"
               for i in range(len(cls))]
        uniq = {c: f"{k}" for k, c in enumerate(sorted(set(cls)))}
        cls = [mol.elems[i] + uniq[c] for i, c in enumerate(cls)]
    return cls


def match_to_input(written: Mol, given: Mol) -> Optional[np.ndarray]:
    """For each written atom an input atom of the same class (None when the
    two graphs differ).  Bond orders are compared as single, double and
    aromatic alike, since the writer marks aromatic bonds."""
    def plain(m: Mol) -> Mol:
        return Mol(m.name, m.elems, m.coords,
                   [(a, b, 1) for a, b, _ in m.bonds])
    cw, cg = atom_classes(plain(written)), atom_classes(plain(given))
    if sorted(cw) != sorted(cg):
        return None
    pool: Dict[str, List[int]] = {}
    for i, c in enumerate(cg):
        pool.setdefault(c, []).append(i)
    return np.array([pool[c].pop() for c in cw])


def intra_pairs(mol: Mol) -> int:
    """Heavy-atom pairs that can move relative to each other: more than
    three bonds apart, in different rigid parts (the parts left when the
    rotatable bonds are cut), and not an end of a rotatable bond with the
    part across it, which turns about that bond's axis."""
    n = len(mol.elems)
    rot = {(min(a, b), max(a, b)) for a, b in rotatable_bonds(mol)}
    part = list(range(n))

    def find(i):
        while part[i] != i:
            part[i] = part[part[i]]
            i = part[i]
        return i

    for a, b, _ in mol.bonds:
        if (min(a, b), max(a, b)) not in rot:
            part[find(a)] = find(b)
    near = [set() for _ in range(n)]
    for i in range(n):
        front = {i}
        seen = {i}
        for _ in range(3):
            front = {j for k in front for j, _ in mol.adj[k]} - seen
            seen |= front
        near[i] = seen
    axis = set()
    for a, b in rot:
        axis.add((a, find(b)))
        axis.add((b, find(a)))
    heavy = [i for i in range(n) if mol.elems[i] != "H"]
    return sum(1 for x, i in enumerate(heavy) for j in heavy[x + 1:]
               if find(i) != find(j) and j not in near[i]
               and (i, find(j)) not in axis and (j, find(i)) not in axis)
