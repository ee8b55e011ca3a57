"""PDBQT reading/writing: rigid receptors, flexible ligands with BRANCH trees.

Replaces the reference's parse_pdbqt.cpp.  A ligand PDBQT encodes the
kinematic tree explicitly (ROOT/BRANCH records); we parse it into a
FragmentTree (see tree_build.py) without re-deriving rotatable bonds.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from gnina_tpu_torch.chem import elements as el
from gnina_tpu_torch.chem.mol import Atom, Bond, Molecule


def _parse_atom_line(line: str) -> Atom:
    # PDBQT fixed columns (same as PDB plus charge + AD type)
    name = line[12:16].strip()
    resname = line[17:20].strip()
    chain = line[21:22].strip()
    try:
        resnum = int(line[22:26])
    except ValueError:
        resnum = 0
    x = float(line[30:38])
    y = float(line[38:46])
    z = float(line[46:54])
    charge = 0.0
    if len(line) >= 76:
        try:
            charge = float(line[70:76])
        except ValueError:
            charge = 0.0
    ad_name = line[77:79].strip() if len(line) >= 78 else ""
    anum = _ad_name_to_anum(ad_name, name)
    return Atom(anum=anum, coords=np.array([x, y, z], np.float32),
                charge=charge, name=name, resname=resname, resnum=resnum,
                chain=chain, ad_name=ad_name,
                element_name=el.ANUM_TO_SYMBOL.get(anum, ""))


def _ad_name_to_anum(ad_name: str, atom_name: str) -> int:
    base = {"HD": 1, "H": 1, "HS": 1, "A": 6, "C": 6, "N": 7, "NA": 7,
            "NS": 7, "O": 8, "OA": 8, "OS": 8, "S": 16, "SA": 16, "P": 15,
            "F": 9, "Cl": 17, "CL": 17, "Br": 35, "BR": 35, "I": 53,
            "Zn": 30, "ZN": 30, "Mn": 25, "MN": 25, "Mg": 12, "MG": 12,
            "Ca": 20, "CA": 20, "Fe": 26, "FE": 26, "B": 5, "Si": 14,
            "SI": 14, "M": 0}
    if ad_name in base:
        return base[ad_name]
    a = el.symbol_to_anum(ad_name) if ad_name else 0
    if a:
        return a
    # fall back to the PDB atom-name leading element
    stripped = atom_name.lstrip("0123456789")
    return el.symbol_to_anum(stripped[:2]) or el.symbol_to_anum(stripped[:1])


@dataclasses.dataclass
class PdbqtBranch:
    """One BRANCH record: rotatable bond (parent_atom -> this_atom), both
    serial numbers in the original file numbering."""

    parent_serial: int
    my_serial: int
    atoms: List[int]          # atom indices (0-based into molecule)
    children: List["PdbqtBranch"]


@dataclasses.dataclass
class PdbqtLigand:
    mol: Molecule
    root_atoms: List[int]
    branches: List[PdbqtBranch]   # top-level branches off the root
    torsdof: int


def parse_pdbqt_ligand(text: str, name: str = "") -> PdbqtLigand:
    """Parse a flexible-ligand PDBQT (ROOT/BRANCH tree).

    reference: gninasrc/lib/parse_pdbqt.cpp (parse_pdbqt_root/branch).
    """
    mol = Molecule(name=name)
    serial_to_idx = {}
    root_atoms: List[int] = []
    stack: List[PdbqtBranch] = []
    top_branches: List[PdbqtBranch] = []
    in_root = False
    torsdof = 0

    for line in text.splitlines():
        rec = line[:7].strip()
        if rec in ("ATOM", "HETATM"):
            atom = _parse_atom_line(line)
            try:
                serial = int(line[6:11])
            except ValueError:
                serial = len(mol.atoms) + 1
            idx = len(mol.atoms)
            mol.atoms.append(atom)
            serial_to_idx[serial] = idx
            if in_root:
                root_atoms.append(idx)
            elif stack:
                stack[-1].atoms.append(idx)
            else:
                root_atoms.append(idx)  # tolerate missing ROOT
        elif line.startswith("ROOT"):
            in_root = True
        elif line.startswith("ENDROOT"):
            in_root = False
        elif line.startswith("BRANCH"):
            parts = line.split()
            br = PdbqtBranch(int(parts[1]), int(parts[2]), [], [])
            if stack:
                stack[-1].children.append(br)
            else:
                top_branches.append(br)
            stack.append(br)
        elif line.startswith("ENDBRANCH"):
            if stack:
                stack.pop()
        elif line.startswith("TORSDOF"):
            try:
                torsdof = int(line.split()[1])
            except (IndexError, ValueError):
                torsdof = 0

    # resolve serials to indices for branch anchors
    def fix(br: PdbqtBranch):
        br.parent_serial = serial_to_idx.get(br.parent_serial, -1)
        br.my_serial = serial_to_idx.get(br.my_serial, -1)
        for c in br.children:
            fix(c)

    for br in top_branches:
        fix(br)

    # connectivity for typing adjustments: perceive within the ligand
    mol.perceive_bonds()
    return PdbqtLigand(mol=mol, root_atoms=root_atoms, branches=top_branches,
                       torsdof=torsdof)


def parse_pdbqt_rigid(text: str, name: str = "") -> Molecule:
    """Parse a rigid receptor PDBQT: just atoms (tree records ignored)."""
    mol = Molecule(name=name)
    for line in text.splitlines():
        rec = line[:7].strip()
        if rec in ("ATOM", "HETATM"):
            mol.atoms.append(_parse_atom_line(line))
    mol.perceive_bonds()
    return mol


def is_pdbqt_ligand(text: str) -> bool:
    return any(line.startswith(("ROOT", "BRANCH")) for line in text.splitlines())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _format_atom_line(i: int, a: Atom, coords, ad_name: str) -> str:
    name = (a.name or ad_name or "X")[:4]
    return (
        f"ATOM  {i:5d} {name:<4s}{(a.resname or 'LIG'):>4s} {a.chain or 'A'}"
        f"{a.resnum or 1:4d}    {coords[0]:8.3f}{coords[1]:8.3f}{coords[2]:8.3f}"
        f"{1.0:6.2f}{0.0:6.2f}    {a.charge:6.3f} {ad_name:<2s}"
    )


def write_pdbqt_rigid(mol: Molecule, coords: Optional[np.ndarray] = None) -> str:
    if coords is None:
        coords = mol.coords()
    lines = []
    for i, a in enumerate(mol.atoms):
        ad = a.ad_name or el.ANUM_TO_SYMBOL.get(a.anum, "C")
        lines.append(_format_atom_line(i + 1, a, coords[i], ad))
    return "\n".join(lines) + "\n"
