"""SDF / MOL (V2000 and V3000) reading and SDF writing.

Replaces the OpenBabel SDF path used by the reference's MolGetter.  Bond
orders and formal charges come from the file; aromaticity is perceived.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np

from gnina_tpu_torch.chem import elements as el
from gnina_tpu_torch.chem.mol import Atom, Bond, Molecule

_CHARGE_CODE = {7: -3, 6: -2, 5: -1, 0: 0, 3: 1, 2: 2, 1: 3}


def parse_sdf_block(block: str) -> Molecule:
    lines = block.splitlines()
    if len(lines) < 4:
        raise ValueError("truncated mol block")
    name = lines[0].strip()
    counts = lines[3]
    if "V3000" in counts:
        return _parse_v3000(lines, name)
    natoms = int(counts[0:3])
    nbonds = int(counts[3:6])
    mol = Molecule(name=name)
    for i in range(natoms):
        ln = lines[4 + i]
        x, y, z = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
        sym = ln[31:34].strip()
        anum = el.symbol_to_anum(sym)
        chg = _CHARGE_CODE.get(int(ln[36:39]) if len(ln) >= 39 and ln[36:39].strip() else 0, 0)
        mol.atoms.append(Atom(anum=anum, coords=np.array([x, y, z], np.float32),
                              formal_charge=chg, element_name=sym))
    for i in range(nbonds):
        ln = lines[4 + natoms + i]
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        order = int(ln[6:9])
        aromatic = order == 4
        mol.bonds.append(Bond(a, b, order=1 if aromatic else min(order, 3),
                              aromatic=aromatic))
    # M  CHG overrides
    for ln in lines[4 + natoms + nbonds:]:
        if ln.startswith("M  CHG"):
            parts = ln.split()
            k = int(parts[2])
            for j in range(k):
                idx = int(parts[3 + 2 * j]) - 1
                mol.atoms[idx].formal_charge = int(parts[4 + 2 * j])
        elif ln.startswith("M  END"):
            break
    _finish(mol)
    return mol


def _parse_v3000(lines: List[str], name: str) -> Molecule:
    mol = Molecule(name=name)
    it = iter(lines)
    in_atoms = in_bonds = False
    idx_map: Dict[int, int] = {}
    for ln in it:
        s = ln.strip()
        if s.startswith("M  V30 BEGIN ATOM"):
            in_atoms = True
        elif s.startswith("M  V30 END ATOM"):
            in_atoms = False
        elif s.startswith("M  V30 BEGIN BOND"):
            in_bonds = True
        elif s.startswith("M  V30 END BOND"):
            in_bonds = False
        elif in_atoms and s.startswith("M  V30"):
            parts = s.split()
            aid = int(parts[2])
            sym = parts[3]
            x, y, z = float(parts[4]), float(parts[5]), float(parts[6])
            chg = 0
            for p in parts[8:]:
                if p.startswith("CHG="):
                    chg = int(p[4:])
            idx_map[aid] = len(mol.atoms)
            mol.atoms.append(Atom(anum=el.symbol_to_anum(sym),
                                  coords=np.array([x, y, z], np.float32),
                                  formal_charge=chg, element_name=sym))
        elif in_bonds and s.startswith("M  V30"):
            parts = s.split()
            order = int(parts[3])
            a, b = idx_map[int(parts[4])], idx_map[int(parts[5])]
            aromatic = order == 4
            mol.bonds.append(Bond(a, b, order=1 if aromatic else min(order, 3),
                                  aromatic=aromatic))
    _finish(mol)
    return mol


def _finish(mol: Molecule):
    mol.invalidate()
    mol.perceive_aromaticity()
    # explicit aromatic flags from order-4 bonds
    for b in mol.bonds:
        if b.aromatic:
            mol.atoms[b.a].aromatic = True
            mol.atoms[b.b].aromatic = True
    mol.mark_amides()


def iter_sdf(path_or_text: str, is_text: bool = False) -> Iterator[Molecule]:
    """Yield molecules from a multi-record SDF file (or raw text)."""
    if is_text:
        text = path_or_text
    else:
        with open(path_or_text) as f:
            text = f.read()
    for chunk in text.split("$$$$"):
        if chunk.strip():
            # drop leading blank lines left by the separator
            lines = chunk.splitlines()
            while lines and not lines[0].strip() and len(lines) > 4:
                lines.pop(0)
            try:
                yield parse_sdf_block("\n".join(lines))
            except (ValueError, IndexError):
                continue


def write_sdf_block(mol: Molecule, coords: Optional[np.ndarray] = None,
                    properties: Optional[Dict[str, str]] = None,
                    name: Optional[str] = None) -> str:
    if coords is None:
        coords = mol.coords()
    out = [name if name is not None else mol.name, "  gnina_tpu", ""]
    out.append(f"{len(mol.atoms):3d}{len(mol.bonds):3d}  0  0  0  0  0  0  0  0999 V2000")
    for i, a in enumerate(mol.atoms):
        sym = a.element_name or el.ANUM_TO_SYMBOL.get(a.anum, "C")
        out.append(f"{coords[i][0]:10.4f}{coords[i][1]:10.4f}{coords[i][2]:10.4f} "
                   f"{sym:<3s} 0  0  0  0  0  0  0  0  0  0  0  0")
    for b in mol.bonds:
        order = 4 if b.aromatic else b.order
        out.append(f"{b.a + 1:3d}{b.b + 1:3d}{order:3d}  0  0  0  0")
    chg = [(i + 1, a.formal_charge) for i, a in enumerate(mol.atoms) if a.formal_charge]
    for i in range(0, len(chg), 8):
        sub = chg[i:i + 8]
        out.append("M  CHG" + f"{len(sub):3d}" + "".join(f"{a:4d}{c:4d}" for a, c in sub))
    out.append("M  END")
    for k, v in (properties or {}).items():
        out.append(f">  <{k}>")
        out.append(str(v))
        out.append("")
    out.append("$$$$")
    return "\n".join(out) + "\n"
