"""PDB receptor parsing with bond perception.

Replaces the reference's OpenBabel PDB reader for receptor construction
(reference: gninasrc/lib/molgetter.cpp:52 create_init_model).  Waters are
dropped; alternate locations keep conformer A; connectivity is perceived
from covalent radii.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gnina_tpu_torch.chem import elements as el
from gnina_tpu_torch.chem.mol import Atom, Molecule

_SKIP_RESIDUES = {"HOH", "WAT", "DOD"}


def _element_from_pdb(line: str) -> int:
    if len(line) >= 78:
        sym = line[76:78].strip()
        if sym:
            a = el.symbol_to_anum(sym)
            if a:
                return a
    name = line[12:16]
    # PDB convention: element is right-justified in cols 13-14 for 1-letter
    stripped = name.strip().lstrip("0123456789")
    if len(name) >= 2 and name[0] != " " and name[:2].strip().capitalize() in el.SYMBOL_TO_ANUM:
        return el.SYMBOL_TO_ANUM[name[:2].strip().capitalize()]
    return el.symbol_to_anum(stripped[:1])


def parse_pdb(text: str, name: str = "", keep_hetero: bool = True,
              strip_water: bool = True) -> Molecule:
    mol = Molecule(name=name)
    for line in text.splitlines():
        rec = line[:6]
        if rec not in ("ATOM  ", "HETATM"):
            if rec.strip() == "ENDMDL":
                break  # first model only
            continue
        if not keep_hetero and rec == "HETATM":
            continue
        resname = line[17:20].strip()
        if strip_water and resname in _SKIP_RESIDUES:
            continue
        altloc = line[16:17]
        if altloc not in (" ", "A", "1"):
            continue
        anum = _element_from_pdb(line)
        if anum == 0:
            continue
        try:
            resnum = int(line[22:26])
        except ValueError:
            resnum = 0
        mol.atoms.append(Atom(
            anum=anum,
            coords=np.array([float(line[30:38]), float(line[38:46]),
                             float(line[46:54])], np.float32),
            name=line[12:16].strip(),
            resname=resname,
            resnum=resnum,
            chain=line[21:22].strip(),
            icode=line[26:27].strip(),
            element_name=el.ANUM_TO_SYMBOL.get(anum, ""),
        ))
    mol.perceive_bonds()
    mol.perceive_aromaticity()
    mol.mark_amides()
    return mol


def load_receptor(path: str) -> Molecule:
    with open(path) as f:
        text = f.read()
    if path.endswith(".pdbqt"):
        from gnina_tpu_torch.chem.pdbqt import parse_pdbqt_rigid

        m = parse_pdbqt_rigid(text, name=path)
        m.perceive_aromaticity()
        m.mark_amides()
        return m
    return parse_pdb(text, name=path)
