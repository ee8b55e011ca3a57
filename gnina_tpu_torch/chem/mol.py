"""Host-side molecule model: atoms, bonds, perception, smina atom typing.

This replaces the reference's dependence on OpenBabel for chemistry
perception (reference: gninasrc/lib/atom_constants.h:315-349
obatom_to_smina_type; gninasrc/lib/GninaConverter.cpp).  It implements:

- connectivity perception from coordinates (covalent radii), for PDB input
- ring perception (smallest rings via BFS)
- aromaticity perception (planar rings of sp2 C/N/O/S, Hueckel-lite)
- hydrogen-bond donor/acceptor flags
- the smina atom typing pipeline (element -> base type -> neighborhood
  adjustment)

Perception heuristics approximate OpenBabel's behavior; they are validated
by regression tests on the reference fixtures rather than by code-level
parity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import numpy as np

from gnina_tpu_torch.chem import elements as el
from gnina_tpu_torch.constants import (NON_AD_METAL_NAMES, SminaType,
                                 adjust_smina_type, string_to_smina_type)


@dataclasses.dataclass
class Atom:
    anum: int
    coords: np.ndarray  # (3,) float
    charge: float = 0.0
    name: str = ""           # pdb atom name if available
    resname: str = ""
    resnum: int = 0
    chain: str = ""
    icode: str = ""
    aromatic: bool = False
    formal_charge: int = 0
    ad_name: str = ""        # autodock type string when read from pdbqt
    element_name: str = ""


@dataclasses.dataclass
class Bond:
    a: int
    b: int
    order: int = 1
    aromatic: bool = False
    in_ring: bool = False
    amide: bool = False


class Molecule:
    """Mutable molecule with perception utilities."""

    def __init__(self, atoms: Optional[List[Atom]] = None,
                 bonds: Optional[List[Bond]] = None, name: str = ""):
        self.atoms: List[Atom] = atoms or []
        self.bonds: List[Bond] = bonds or []
        self.name = name
        self._adj: Optional[List[List[Tuple[int, Bond]]]] = None

    # -- basic accessors ---------------------------------------------------

    def num_atoms(self) -> int:
        return len(self.atoms)

    def coords(self) -> np.ndarray:
        if not self.atoms:
            return np.zeros((0, 3), np.float32)
        return np.stack([a.coords for a in self.atoms]).astype(np.float32)

    def adjacency(self):
        if self._adj is None or len(self._adj) != len(self.atoms):
            adj = [[] for _ in self.atoms]
            for b in self.bonds:
                adj[b.a].append((b.b, b))
                adj[b.b].append((b.a, b))
            self._adj = adj
        return self._adj

    def invalidate(self):
        self._adj = None

    def neighbors(self, i: int):
        return [j for j, _ in self.adjacency()[i]]

    def heavy_degree(self, i: int) -> int:
        return sum(1 for j in self.neighbors(i) if self.atoms[j].anum != 1)

    def degree(self, i: int) -> int:
        return len(self.adjacency()[i])

    def add_bond(self, a: int, b: int, order: int = 1, aromatic: bool = False):
        self.bonds.append(Bond(a, b, order, aromatic))
        self.invalidate()

    # -- perception --------------------------------------------------------

    def perceive_bonds(self, tolerance: float = 0.45):
        """Distance-based connectivity (for PDB/XYZ input).

        Two atoms bond if dist < r_cov(a) + r_cov(b) + tolerance; grid-hashed
        so receptor-scale molecules stay O(N).  Pure Python: this package
        carries no native host extension.
        """
        self.bonds = []
        coords = self.coords()
        n = len(self.atoms)
        if n == 0:
            return
        cell = 2.0 * max(el.COVALENT_RADIUS.values()) + tolerance
        grid = {}
        keys = np.floor(coords / cell).astype(np.int64)
        for i in range(n):
            grid.setdefault(tuple(keys[i]), []).append(i)
        radii = np.array([el.covalent_radius(a.anum) for a in self.atoms])
        seen = set()
        for i in range(n):
            k = keys[i]
            for dx in (-1, 0, 1):
                for dy in (-1, 0, 1):
                    for dz in (-1, 0, 1):
                        cellmates = grid.get((k[0] + dx, k[1] + dy, k[2] + dz))
                        if not cellmates:
                            continue
                        for j in cellmates:
                            if j <= i or (i, j) in seen:
                                continue
                            # metals: coordination handled by typing, skip
                            if self.atoms[i].anum == 1 and self.atoms[j].anum == 1:
                                continue
                            d = math.dist(coords[i], coords[j])
                            if 0.4 < d < radii[i] + radii[j] + tolerance:
                                seen.add((i, j))
                                self.bonds.append(Bond(i, j, 1))
        self.invalidate()

    def rings(self, max_size: int = 8) -> List[List[int]]:
        """Small rings via per-bond shortest-cycle search (SSSR-like)."""
        adj = self.adjacency()
        rings = []
        ring_keys = set()
        for b in self.bonds:
            # shortest path a..b avoiding the direct bond
            src, dst = b.a, b.b
            prev = {src: -1}
            frontier = [src]
            found = False
            depth = 0
            while frontier and not found and depth < max_size - 1:
                nxt = []
                for u in frontier:
                    for v, bond in adj[u]:
                        if u == src and v == dst:
                            continue
                        if v not in prev:
                            prev[v] = u
                            if v == dst:
                                found = True
                                break
                            nxt.append(v)
                    if found:
                        break
                frontier = nxt
                depth += 1
            if found:
                path = [dst]
                while path[-1] != src:
                    path.append(prev[path[-1]])
                if len(path) <= max_size:
                    key = frozenset(path)
                    if key not in ring_keys:
                        ring_keys.add(key)
                        rings.append(path)
        return rings

    def mark_rings(self):
        ring_atoms = set()
        rings = self.rings()
        for r in rings:
            ring_atoms.update(r)
        ring_bonds = set()
        for r in rings:
            rs = set(r)
            for b in self.bonds:
                if b.a in rs and b.b in rs:
                    # both endpoints in the same ring: bond is in that ring if
                    # they are adjacent along the cycle; approximating with
                    # membership is safe for small rings
                    ring_bonds.add((min(b.a, b.b), max(b.a, b.b)))
        for b in self.bonds:
            b.in_ring = (min(b.a, b.b), max(b.a, b.b)) in ring_bonds
        return rings, ring_atoms

    def perceive_aromaticity(self):
        """Flag aromatic atoms/bonds: planar rings of size 5-6 whose members
        are C/N/O/S with <= 3 heavy connections and sp2-consistent geometry."""
        rings, _ = self.mark_rings()
        coords = self.coords()
        for ring in rings:
            if len(ring) not in (5, 6):
                continue
            ok = True
            for i in ring:
                a = self.atoms[i]
                if a.anum not in (6, 7, 8, 16):
                    ok = False
                    break
                if self.heavy_degree(i) > 3:
                    ok = False
                    break
            if not ok:
                continue
            # planarity: max distance from the best-fit plane
            pts = coords[ring]
            centroid = pts.mean(axis=0)
            u, s, vt = np.linalg.svd(pts - centroid)
            dev = np.abs((pts - centroid) @ vt[2])
            if dev.max() > 0.25:
                continue
            # bond-order sanity when orders are known: an aromatic ring of
            # explicit single bonds only (e.g. cyclohexane, which is also
            # non-planar) was already rejected by planarity
            for i in ring:
                self.atoms[i].aromatic = True
            rs = set(ring)
            for b in self.bonds:
                if b.a in rs and b.b in rs:
                    b.aromatic = True

    def mark_amides(self):
        """Flag C-N bonds where the carbon also double-bonds an oxygen."""
        adj = self.adjacency()
        for b in self.bonds:
            if b.order != 1:
                continue
            for c_idx, n_idx in ((b.a, b.b), (b.b, b.a)):
                if self.atoms[c_idx].anum == 6 and self.atoms[n_idx].anum == 7:
                    for j, jb in adj[c_idx]:
                        if self.atoms[j].anum == 8 and jb.order == 2:
                            b.amide = True
                            break
        return None

    # -- hydrogen handling ---------------------------------------------------

    def strip_nonpolar_hydrogens(self):
        """Remove H bonded to carbon (keep polar H), like OpenBabel's
        DeleteNonPolarHydrogens used by the reference before tree building."""
        keep = []
        adj = self.adjacency()
        for i, a in enumerate(self.atoms):
            if a.anum == 1:
                nbrs = [j for j, _ in adj[i]]
                if nbrs and all(self.atoms[j].anum == 6 for j in nbrs):
                    continue
                if not nbrs:
                    continue  # floating H: drop
            keep.append(i)
        self._reindex(keep)

    def _reindex(self, keep: List[int]):
        remap = {old: new for new, old in enumerate(keep)}
        self.atoms = [self.atoms[i] for i in keep]
        new_bonds = []
        for b in self.bonds:
            if b.a in remap and b.b in remap:
                b.a, b.b = remap[b.a], remap[b.b]
                new_bonds.append(b)
        self.bonds = new_bonds
        self.invalidate()

    # -- typing --------------------------------------------------------------

    _DEFAULT_VALENCE = {5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 3, 16: 2,
                        17: 1, 35: 1, 53: 1}

    def implicit_hydrogen_count(self, i: int) -> int:
        """Implicit H from valence deficit (used when explicit H are absent).

        Mirrors the effect of OpenBabel's AddHydrogens before typing
        (GninaConverter.cpp:30): bond orders from the file, +1 allowed
        valence per positive formal charge, -1 per negative.
        """
        a = self.atoms[i]
        base = self._DEFAULT_VALENCE.get(a.anum)
        if base is None:
            return 0
        valence = base + a.formal_charge
        total = 0.0
        for _, b in self.adjacency()[i]:
            total += 1.5 if b.aromatic else b.order
        return max(0, int(round(valence - total)))

    def _is_hbond_acceptor(self, i: int) -> bool:
        """Approximates OpenBabel3's IsHbondAcceptor for N/O/S."""
        a = self.atoms[i]
        adj = self.adjacency()
        heavy_nbrs = [j for j, _ in adj[i] if self.atoms[j].anum != 1]
        n_h = sum(1 for j, _ in adj[i] if self.atoms[j].anum == 1)
        if a.anum == 8:
            return True
        if a.anum == 7:
            if a.formal_charge > 0:
                return False
            # amide/sulfonamide N is not an acceptor
            for j in heavy_nbrs:
                for k, kb in adj[j]:
                    if k != i and self.atoms[k].anum == 8 and kb.order == 2:
                        return False
            # aromatic N with 3 connections (pyrrole-type) is not an acceptor
            if a.aromatic and (len(heavy_nbrs) + n_h) >= 3:
                return False
            # quaternary / fully substituted
            if len(heavy_nbrs) + n_h >= 4:
                return False
            return True
        if a.anum == 16:
            # thiocarbonyl S and anionic S are acceptors
            for _, bb in adj[i]:
                if bb.order == 2:
                    return True
            return a.formal_charge < 0
        return False

    def assign_smina_types(self, add_h: bool = True) -> np.ndarray:
        """Full typing pipeline -> int array of SminaType.

        Follows obatom_to_smina_type (atom_constants.h:315-349): pick the AD
        element name, then adjust by bonded-H / bonded-heteroatom.

        add_h=False reproduces the reference's --addH off (main.cpp:1051,
        GninaConverter.cpp:84 skips OBMol::AddHydrogens): atoms are typed
        as drawn, without implicit-hydrogen completion of the valence, so
        under-protonated N/O/S lose their donor flags.
        """
        from gnina_tpu_torch.chem.protein import is_standard_residue, protein_atom_flags

        n = len(self.atoms)
        types = np.zeros(n, np.int32)
        adj = self.adjacency()
        for i, a in enumerate(self.atoms):
            template = (not a.ad_name and a.resname and a.name
                        and is_standard_residue(a.resname))
            tmpl_donor = tmpl_acceptor = tmpl_aromatic = False
            if template:
                tmpl_donor, tmpl_acceptor, tmpl_aromatic = protein_atom_flags(
                    a.resname, a.name, a.anum)
            if a.ad_name:
                t = string_to_smina_type(a.ad_name)
                if t is None:
                    t = SminaType.GenericMetal
            elif a.anum == 0:
                # No-element atoms (SDF "*" / R-group dummies): the reference
                # blanks the non-alphanumeric symbol and maps the empty name
                # to NumTypes, then downgrades to Hydrogen ("ignore",
                # PDBQTUtilities.cpp:402-427).  Typed Hydrogen, the atom is
                # excluded from every scoring term, num_tors, and pair lists,
                # and (because covalent_radius(H)=0.37) the reference's
                # distance-based assign_bonds never bonds it to its
                # neighbours either -- see the anum==0 skip in the
                # hetero_bonded loop below.
                types[i] = int(SminaType.Hydrogen)
                continue
            else:
                aromatic = a.aromatic or tmpl_aromatic
                acceptor = tmpl_acceptor if template else self._is_hbond_acceptor(i)
                sym = el.ANUM_TO_SYMBOL.get(a.anum, "M")
                if a.anum == 1:
                    ename = "HD"
                elif a.anum == 6 and aromatic:
                    ename = "A"
                elif a.anum == 8:
                    ename = "OA"
                elif a.anum == 7 and acceptor:
                    ename = "NA"
                elif a.anum == 16 and acceptor:
                    ename = "SA"
                else:
                    ename = sym if sym not in NON_AD_METAL_NAMES else "M"
                t = string_to_smina_type(ename)
                if t is None:
                    t = SminaType.GenericMetal
            h_bonded = tmpl_donor
            hetero_bonded = False
            for j, _ in adj[i]:
                nb = self.atoms[j]
                if nb.anum == 1:
                    h_bonded = True
                elif nb.anum != 6 and nb.anum != 0:
                    # anum==0 neighbours are typed Hydrogen ("ignored",
                    # PDBQTUtilities.cpp:423-427) and never get a model bond
                    # in the reference (H covalent radius), so they must not
                    # demote carbons to NonHydrophobe.
                    hetero_bonded = True
            if add_h and not template and not h_bonded and a.anum in (7, 8, 16):
                h_bonded = self.implicit_hydrogen_count(i) > 0
            types[i] = int(adjust_smina_type(t, h_bonded, hetero_bonded))
        return types

    def perceive_all(self, bonds_from_distance: bool = False):
        if bonds_from_distance or not self.bonds:
            self.perceive_bonds()
        self.perceive_aromaticity()
        self.mark_amides()
