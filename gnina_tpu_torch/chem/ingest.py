"""High-level ingestion: files -> padded device arrays + search box.

Replaces the reference's MolGetter + setup_autobox (reference:
gninasrc/lib/molgetter.cpp, box.cpp).
"""

from __future__ import annotations

import dataclasses
import gzip
import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

from gnina_tpu_torch.chem import pdb, pdbqt, sdf
from gnina_tpu_torch.chem.mol import Molecule
from gnina_tpu_torch.chem.tree_build import LigandStruct, build_tree_from_molecule, \
    build_tree_from_pdbqt
from gnina_tpu_torch.constants import IS_HYDROGEN, AtomTypeTable, DEFAULT_TABLE


def _read_text(path: str) -> str:
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            return f.read()
    with open(path) as f:
        return f.read()


@dataclasses.dataclass
class Receptor:
    mol: Molecule
    coords: np.ndarray   # (K,3)
    types: np.ndarray    # (K,)
    charges: np.ndarray  # (K,)

    @classmethod
    def from_file(cls, path: str) -> "Receptor":
        text = _read_text(path)
        base = path[:-3] if path.endswith(".gz") else path
        ext = os.path.splitext(base)[1].lower()
        if ext == ".pdbqt":
            mol = pdbqt.parse_pdbqt_rigid(text, name=path)
            mol.perceive_aromaticity()
            mol.mark_amides()
        elif ext in (".pdb", ".ent"):
            mol = pdb.parse_pdb(text, name=path)
        elif ext == ".xyz":
            mol = parse_xyz(text, name=path)
            mol.perceive_aromaticity()
        else:
            raise ValueError(f"unsupported receptor format: {ext}")
        types = mol.assign_smina_types()
        charges = np.array([a.charge for a in mol.atoms], np.float32)
        return cls(mol=mol, coords=mol.coords(), types=types, charges=charges)

    def pruned(self, center: np.ndarray, half_span: np.ndarray,
               margin: float = 8.0, drop_hydrogens: bool = True) -> "Receptor":
        """Keep atoms within box + cutoff margin (szv_grid-style pruning).

        Hydrogens are dropped by default: every energy path skips them
        (non_cache.cpp:59), so carrying them only inflates the pair tensor.
        """
        # distance-to-box test, not an expanded AABB: atoms in the
        # expanded box's corners are > margin from every in-box ligand
        # atom and contribute nothing (szv_grid.h:53-101 collects
        # possibilities by cutoff_sqr from the covering cells, which
        # excludes those corners too).  ~10% fewer receptor rows on a
        # typical 20 A box -> fewer KB tiles in the fused kernel.
        lo = center - half_span
        hi = center + half_span
        d = (np.maximum(self.coords - hi, 0.0)
             + np.maximum(lo - self.coords, 0.0))
        keep = (d * d).sum(axis=1) <= margin * margin
        if drop_hydrogens:
            keep &= ~IS_HYDROGEN[self.types]
        idx = np.where(keep)[0]
        sub = Molecule(name=self.mol.name)
        sub.atoms = [self.mol.atoms[i] for i in idx]
        return Receptor(mol=sub, coords=self.coords[idx],
                        types=self.types[idx], charges=self.charges[idx])


def parse_xyz(text: str, name: str = ""):
    """Minimal XYZ reader (test fixtures use single/few-atom XYZ files)."""
    from gnina_tpu_torch.chem import elements as el
    from gnina_tpu_torch.chem.mol import Atom, Molecule

    lines = text.splitlines()
    n = int(lines[0].split()[0])
    mol = Molecule(name=name or (lines[1].strip() if len(lines) > 1 else ""))
    for ln in lines[2:2 + n]:
        parts = ln.split()
        anum = el.symbol_to_anum(parts[0])
        mol.atoms.append(Atom(anum=anum, coords=np.array(
            [float(parts[1]), float(parts[2]), float(parts[3])], np.float32),
            element_name=parts[0]))
    mol.perceive_bonds()
    return mol


def iter_ligands(path: str, table: AtomTypeTable = DEFAULT_TABLE,
                 keep_hydrogens: bool = True, strip_h: bool = True,
                 add_h: bool = True,
                 flex_hydrogens: bool = False) -> Iterator[LigandStruct]:
    """Stream ligands from SDF/MOL/PDBQT/PDB/XYZ files (multi-record aware).

    strip_h/add_h: --stripH/--addH (see build_tree_from_molecule).
    flex_hydrogens: --flex_hydrogens — keep hydrogen-only PDBQT branches
    mobile (reference main.cpp:1150; SDF input is force-fixed either way,
    PDBQTUtilities.cpp:460)."""
    text = _read_text(path)
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in (".sdf", ".mol"):
        for i, mol in enumerate(sdf.iter_sdf(text, is_text=True)):
            if not mol.name:
                mol.name = f"{os.path.basename(base)}_{i}"
            yield build_tree_from_molecule(mol, table, strip_h=strip_h,
                                           add_h=add_h)
    elif ext == ".pdbqt":
        # possibly multi-MODEL
        models = _split_models(text)
        for i, mtext in enumerate(models):
            lig = pdbqt.parse_pdbqt_ligand(mtext, name=f"{os.path.basename(base)}_{i}")
            yield build_tree_from_pdbqt(
                lig, table, fix_rotable_hydrogens=not flex_hydrogens)
    elif ext == ".pdb":
        mol = pdb.parse_pdb(text, name=os.path.basename(base))
        yield build_tree_from_molecule(mol, table, strip_h=strip_h,
                                       add_h=add_h)
    elif ext == ".xyz":
        yield build_tree_from_molecule(parse_xyz(text, os.path.basename(base)),
                                       table)
    else:
        raise ValueError(f"unsupported ligand format: {ext}")


def iter_molecules(path: str) -> Iterator[Molecule]:
    """Stream raw Molecules (no tree building) — covalent docking needs the
    unmodified molecule for SMARTS matching before the complex is built."""
    text = _read_text(path)
    base = path[:-3] if path.endswith(".gz") else path
    ext = os.path.splitext(base)[1].lower()
    if ext in (".sdf", ".mol"):
        for i, mol in enumerate(sdf.iter_sdf(text, is_text=True)):
            if not mol.name:
                mol.name = f"{os.path.basename(base)}_{i}"
            yield mol
    elif ext == ".pdbqt":
        for i, mtext in enumerate(_split_models(text)):
            yield pdbqt.parse_pdbqt_ligand(
                mtext, name=f"{os.path.basename(base)}_{i}").mol
    elif ext == ".pdb":
        yield pdb.parse_pdb(text, name=os.path.basename(base))
    elif ext == ".xyz":
        yield parse_xyz(text, os.path.basename(base))
    else:
        raise ValueError(f"unsupported ligand format: {ext}")


def _split_models(text: str) -> List[str]:
    if "MODEL" not in text:
        return [text]
    models = []
    cur: List[str] = []
    for line in text.splitlines():
        if line.startswith("MODEL"):
            cur = []
        elif line.startswith("ENDMDL"):
            models.append("\n".join(cur))
        else:
            cur.append(line)
    if cur and not models:
        models.append("\n".join(cur))
    return models


def autobox_ligand(path: str, autobox_add: float = 4.0) -> Tuple[np.ndarray, np.ndarray]:
    """Search box from a reference ligand's heavy-atom bounding box + margin
    (reference: box.cpp setup_autobox, default autobox_add=4).

    Returns (center, size).
    """
    coords = []
    for lig in iter_ligands(path):
        heavy = ~IS_HYDROGEN[lig.types]
        coords.append(lig.orig_coords[heavy])
        break
    if not coords:
        raise ValueError(f"no ligand found in {path}")
    c = np.concatenate(coords)
    lo, hi = c.min(axis=0), c.max(axis=0)
    center = 0.5 * (lo + hi)
    size = (hi - lo) + 2 * autobox_add
    return center.astype(np.float32), size.astype(np.float32)


def box_from_center_size(center, size) -> Tuple[np.ndarray, np.ndarray]:
    center = np.asarray(center, np.float32)
    size = np.asarray(size, np.float32)
    return center - size / 2, center + size / 2
