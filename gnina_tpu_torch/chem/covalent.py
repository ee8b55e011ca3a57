"""Covalent docking: bond a ligand atom to a receptor atom and dock the
complex as a flexible residue.

TPU-native equivalent of the reference CovInfo + MolGetter covalent path
(reference: gninasrc/lib/covinfo.h:18-60, covinfo.cpp:23-174,
molgetter.cpp:105-385 createCovalentMoleculeInModel):

1. locate the receptor atom (chain:resnum[icode]:[resname:]atomname or
   x,y,z within sqrt(0.05) A, covinfo.cpp:64-88),
2. carve its residue out of the rigid receptor (the "covres"),
3. SMARTS-match the ligand attachment atom (one covalent complex per
   unique match, molgetter.cpp:246-266),
4. place the ligand so the attachment atom sits at the ideal bond position
   off the receptor atom (OBBuilder::Connect equivalent; optional user
   position, covinfo.cpp:142-163),
5. build a torsion-only kinematic tree: covres atoms static (inflex),
   ligand rooted at the new bond (first_segment about the ratom->latom
   axis) — the norotate/fixres construction of molgetter.cpp:358-372.

The resulting LigandStruct has has_rigid_dof=False: the pose has no global
translation/rotation, only torsions, exactly like the reference model
whose `ligands` list is empty and whose flex tree carries all the DOF.
"""

from __future__ import annotations

import copy
import dataclasses
import re
from typing import List, Optional, Tuple

import numpy as np

from gnina_tpu_torch.chem.ingest import Receptor
from gnina_tpu_torch.chem.mol import Atom, Bond, Molecule
from gnina_tpu_torch.chem.smarts import SmartsPattern
from gnina_tpu_torch.chem.tree_build import LigandStruct, is_rotatable_bond
from gnina_tpu_torch.constants import IS_HYDROGEN, DEFAULT_TABLE

# single-bond covalent radii (pm -> A), standard table; carbon adjusted by
# hybridization like covinfo.cpp:133-141
_COVALENT_RADIUS = {
    1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11,
    15: 1.07, 16: 1.05, 17: 1.02, 26: 1.32, 29: 1.32, 30: 1.22, 34: 1.20,
    35: 1.20, 53: 1.39, 12: 1.41, 20: 1.76, 25: 1.39,
}


def _cov_rad(mol: Molecule, i: int) -> float:
    a = mol.atoms[i]
    if a.anum == 6:
        # hybridization from explicit bond orders
        orders = [b.order for b in mol.bonds if i in (b.a, b.b)]
        if 3 in orders:
            return 0.69
        if 2 in orders:
            return 0.73
    return _COVALENT_RADIUS.get(a.anum, 1.5)


@dataclasses.dataclass
class CovOptions:
    covalent_rec_atom: str = ""
    covalent_lig_atom_pattern: str = ""
    covalent_lig_atom_position: str = ""
    covalent_fix_lig_atom_position: bool = False
    covalent_bond_order: int = 1
    covalent_optimize_lig: bool = False
    dont_move_ligand: bool = False  # score_only / minimize


def _parse_xyz(s: str) -> Optional[np.ndarray]:
    toks = s.split(",")
    if len(toks) != 3:
        return None
    try:
        return np.array([float(t) for t in toks], np.float32)
    except ValueError:
        return None


class CovInfo:
    """Parsed covalent options (covinfo.cpp:14-61)."""

    def __init__(self, opts: CovOptions, log=print):
        self.opts = opts
        self.log = log
        self.initialized = bool(opts.covalent_rec_atom)
        if not self.initialized:
            return
        self.ratom_xyz = _parse_xyz(opts.covalent_rec_atom)
        self.ratom_chain = self.ratom_icode = self.ratom_res = ""
        self.ratom_num = 0
        self.ratom_name = ""
        if self.ratom_xyz is None:
            m = re.search(r"([^:]+):(-?\d+)(\w?):([^:]+)(?::([^:]+))?",
                          opts.covalent_rec_atom)
            if not m:
                raise ValueError("Could not parse covalent_rec_atom: "
                                 + opts.covalent_rec_atom)
            if len(m.group(1)) > 1:
                raise ValueError("multi-character chain ids unsupported in "
                                 "covalent_rec_atom")
            self.ratom_chain = m.group(1)
            self.ratom_num = int(m.group(2))
            self.ratom_icode = m.group(3) or ""
            if m.group(5):
                self.ratom_res = m.group(4)
                self.ratom_name = m.group(5)
            else:
                self.ratom_name = m.group(4)
        if not opts.covalent_lig_atom_pattern:
            raise ValueError("covalent docking requires "
                             "--covalent_lig_atom_pattern")
        self.pattern = SmartsPattern(opts.covalent_lig_atom_pattern)
        self.latom_pos = _parse_xyz(opts.covalent_lig_atom_position) \
            if opts.covalent_lig_atom_position else None
        if opts.covalent_fix_lig_atom_position and self.latom_pos is None:
            log("WARNING: covalent_fix_lig_atom_position set without "
                "covalent_lig_atom_position. Ignoring")

    def has_content(self) -> bool:
        return self.initialized

    def is_rec_atom(self, a: Atom) -> bool:
        if not self.initialized:
            return False
        if self.ratom_name:
            if a.resnum != self.ratom_num or a.chain != self.ratom_chain:
                return False
            if self.ratom_res and a.resname.strip() != self.ratom_res:
                return False
            if a.name.strip() != self.ratom_name:
                return False
            if self.ratom_icode and (a.icode or "") != self.ratom_icode:
                return False
            return True
        d2 = float(((np.asarray(a.coords) - self.ratom_xyz) ** 2).sum())
        return d2 < 0.05

    def find_rec_atom(self, mol: Molecule) -> Optional[int]:
        for i, a in enumerate(mol.atoms):
            if self.is_rec_atom(a):
                return i
        return None

    def rec_atom_string(self) -> str:
        return self.opts.covalent_rec_atom


def _new_bond_direction(mol: Molecule, i: int,
                        fallback_coords: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Ideal direction for a new bond at atom i: the negated mean of unit
    vectors toward bonded neighbors (OBAtom::GetNewBondVector essence); if
    the atom has no usable neighbors, negate the average direction of
    nearby atoms (heuristic_position, molgetter.cpp:215-243)."""
    c = np.asarray(mol.atoms[i].coords, np.float64)
    s = np.zeros(3)
    for j in mol.neighbors(i):
        d = np.asarray(mol.atoms[j].coords, np.float64) - c
        n = np.linalg.norm(d)
        if n > 1e-6:
            s += d / n
    if np.linalg.norm(s) < 1e-3 and fallback_coords is not None:
        near = fallback_coords[
            ((fallback_coords - c) ** 2).sum(axis=1) < 2.5 ** 2]
        s = -(c - near).sum(axis=0) if len(near) else s
    n = np.linalg.norm(s)
    if n < 1e-3:
        rng = np.random.RandomState(0)
        v = rng.randn(3)
        return v / np.linalg.norm(v)
    return -s / n


def _rotation_between(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """3x3 rotation taking unit u onto unit v."""
    u = u / max(np.linalg.norm(u), 1e-12)
    v = v / max(np.linalg.norm(v), 1e-12)
    c = float(np.dot(u, v))
    if c > 1 - 1e-9:
        return np.eye(3)
    if c < -1 + 1e-9:
        # 180 degrees: rotate about any perpendicular axis
        p = np.array([1.0, 0, 0]) if abs(u[0]) < 0.9 else np.array([0, 1.0, 0])
        axis = np.cross(u, p)
        axis /= np.linalg.norm(axis)
        return 2 * np.outer(axis, axis) - np.eye(3)
    axis = np.cross(u, v)
    s = np.linalg.norm(axis)
    kmat = np.array([[0, -axis[2], axis[1]],
                     [axis[2], 0, -axis[0]],
                     [-axis[1], axis[0], 0]])
    return np.eye(3) + kmat + kmat @ kmat * ((1 - c) / (s * s))


def extract_covres(rec: Receptor, cinfo: CovInfo
                   ) -> Tuple[Receptor, Molecule, int]:
    """Remove the covalent residue from the rigid receptor.

    Returns (receptor without covres, covres molecule with perceived bonds,
    index of the covalent atom within covres).  Mirrors
    FlexInfo::extract_residue usage at molgetter.cpp:120-129."""
    gi = cinfo.find_rec_atom(rec.mol)
    if gi is None:
        raise ValueError("Could not find receptor atom "
                         + cinfo.rec_atom_string())
    ra = rec.mol.atoms[gi]
    key = (ra.chain, ra.resnum, ra.icode)
    keep, res_idx = [], []
    for i, a in enumerate(rec.mol.atoms):
        if (a.chain, a.resnum, a.icode) == key:
            res_idx.append(i)
        else:
            keep.append(i)

    covres = Molecule(name=f"covres_{ra.resname}{ra.resnum}")
    covres.atoms = [copy.copy(rec.mol.atoms[i]) for i in res_idx]
    covres.perceive_bonds()
    covres.perceive_all()
    latom_local = res_idx.index(gi)

    rigid = Molecule(name=rec.mol.name)
    rigid.atoms = [rec.mol.atoms[i] for i in keep]
    new_rec = Receptor(mol=rigid, coords=rec.coords[keep],
                       types=rec.types[keep], charges=rec.charges[keep])
    return new_rec, covres, latom_local


def place_ligand(covres: Molecule, ratom: int, lig: Molecule, latom: int,
                 cinfo: CovInfo, rec_coords: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """Return transformed ligand coordinates with the attachment atom at
    the covalent-bond position (OBBuilder::Connect equivalent,
    molgetter.cpp:292-322)."""
    coords = np.array([a.coords for a in lig.atoms], np.float64)
    if cinfo.opts.dont_move_ligand:
        return coords.astype(np.float32)

    rpos = np.asarray(covres.atoms[ratom].coords, np.float64)
    cdist = _cov_rad(covres, ratom) + _cov_rad(lig, latom)
    if cinfo.latom_pos is not None:
        pos = np.asarray(cinfo.latom_pos, np.float64)
        if np.linalg.norm(pos - rpos) > 1.5 * cdist:
            cinfo.log("WARNING: Large covalent bond distance using "
                      "specified covalent_lig_atom_position: "
                      f"{np.linalg.norm(pos - rpos):.2f}")
    else:
        d = _new_bond_direction(covres, ratom, rec_coords)
        pos = rpos + cdist * d

    # orient: the ligand atom's own ideal-new-bond direction should point
    # back at the receptor atom
    d_l = _new_bond_direction(lig, latom)
    target = rpos - pos
    tn = np.linalg.norm(target)
    target = target / tn if tn > 1e-9 else np.array([1.0, 0, 0])
    rot = _rotation_between(d_l, target)
    lpos = coords[latom]
    coords = (coords - lpos) @ rot.T + pos

    # crude clash relief replacing the reference's optional UFF pass
    # (molgetter.cpp:327-350): spin the ligand about the new bond axis to
    # the angle minimizing receptor clashes
    if rec_coords is not None and len(rec_coords):
        axis = target
        best, best_pen = coords, np.inf
        rel = coords - pos
        near = rec_coords[((rec_coords - pos) ** 2).sum(axis=1) < 15.0 ** 2]
        if len(near):
            for ang in np.linspace(0, 2 * np.pi, 24, endpoint=False):
                c_, s_ = np.cos(ang), np.sin(ang)
                k = axis
                rotv = (rel * c_ + np.cross(k, rel) * s_
                        + np.outer(rel @ k, k) * (1 - c_))
                cand = rotv + pos
                d2 = ((cand[:, None, :] - near[None, :, :]) ** 2).sum(-1)
                pen = np.sum(np.maximum(0.0, 3.0 - np.sqrt(d2)) ** 2)
                if pen < best_pen:
                    best_pen, best = pen, cand
            coords = best
    return coords.astype(np.float32)


def build_covalent_complex(rec: Receptor, lig_mol: Molecule,
                           cinfo: CovInfo, table=DEFAULT_TABLE
                           ) -> Tuple[Receptor, List[LigandStruct]]:
    """Full covalent pipeline: returns the covres-free receptor and one
    torsion-only LigandStruct per unique SMARTS match."""
    new_rec, covres, ratom = extract_covres(rec, cinfo)
    out = covalent_complexes_for_mol(covres, ratom, lig_mol, cinfo,
                                     rec_coords=new_rec.coords, table=table)
    return new_rec, out


def covalent_complexes_for_mol(covres: Molecule, ratom: int,
                               lig_mol: Molecule, cinfo: CovInfo,
                               rec_coords=None, table=DEFAULT_TABLE
                               ) -> List[LigandStruct]:
    """One covalent LigandStruct per unique SMARTS match (the reference
    docks each match as a separate orientation, molgetter.cpp:246-266)."""
    if len(covres.atoms) < 2 or not covres.neighbors(ratom):
        raise ValueError("Invalid solitary receptor atom "
                         + cinfo.rec_atom_string() + ". Check bond lengths.")

    work = copy.deepcopy(lig_mol)
    work.perceive_all()
    work.strip_nonpolar_hydrogens()
    work.perceive_all()
    matches = cinfo.pattern.match_unique(work)
    out = []
    for match in matches:
        latom = match[0]
        coords = place_ligand(covres, ratom, work, latom, cinfo,
                              rec_coords=rec_coords)
        out.append(_build_complex_struct(covres, ratom, work, latom, coords,
                                         cinfo, table))
    return out


def _build_complex_struct(covres: Molecule, ratom: int, lig: Molecule,
                          latom: int, lig_coords: np.ndarray, cinfo: CovInfo,
                          table) -> LigandStruct:
    """Torsion-only tree: node 0 = empty virtual root (the pose's unused
    rigid-body DOF), node 1 = first_segment about the covalent bond, child
    nodes = ligand fragments; covres atoms are static inflex."""
    nl = lig.num_atoms()

    # merged molecule for pair exclusions: [ligand | covres] + covalent bond
    merged = Molecule(name=lig.name)
    merged.atoms = [copy.copy(a) for a in lig.atoms]
    for i, a in enumerate(merged.atoms):
        a.coords = lig_coords[i]
    merged.atoms += [copy.copy(a) for a in covres.atoms]
    for b in lig.bonds:
        merged.bonds.append(Bond(b.a, b.b, b.order, b.aromatic, b.in_ring,
                                 b.amide))
    for b in covres.bonds:
        merged.bonds.append(Bond(b.a + nl, b.b + nl, b.order, b.aromatic,
                                 b.in_ring, b.amide))
    merged.bonds.append(Bond(latom, ratom + nl,
                             cinfo.opts.covalent_bond_order))
    merged.invalidate()
    merged.mark_rings()
    merged.mark_amides()

    # fragment the LIGAND by its rotatable bonds; root = latom's fragment
    adj = lig.adjacency()
    cut = set()
    rot_bonds = []
    for b in lig.bonds:
        if is_rotatable_bond(lig, b.a, b.b, b.order, b.in_ring, b.amide):
            key = (min(b.a, b.b), max(b.a, b.b))
            cut.add(key)
            rot_bonds.append(key)
    seen = [False] * nl
    frags: List[List[int]] = []
    for s0 in range(nl):
        if seen[s0]:
            continue
        comp, stack = [s0], [s0]
        seen[s0] = True
        while stack:
            u = stack.pop()
            for v, _b in adj[u]:
                if seen[v] or (min(u, v), max(u, v)) in cut:
                    continue
                seen[v] = True
                comp.append(v)
                stack.append(v)
        frags.append(comp)
    frag_of = {}
    for fi, fr in enumerate(frags):
        for a in fr:
            frag_of[a] = fi
    root_frag = frag_of[latom]

    # BFS over fragments from the root fragment
    adj_frags = {fi: [] for fi in range(len(frags))}
    for (a, b) in rot_bonds:
        adj_frags[frag_of[a]].append((frag_of[b], a, b))
        adj_frags[frag_of[b]].append((frag_of[a], b, a))
    order = [root_frag]
    parent_frag = {root_frag: (-1, -1, -1)}
    qi = 0
    while qi < len(order):
        f = order[qi]
        qi += 1
        for (g, pa, ca) in adj_frags[f]:
            if g not in parent_frag:
                parent_frag[g] = (f, pa, ca)
                order.append(g)

    # atom order: node-contiguous ligand (latom first), then covres inflex
    frag_rank = {f: i for i, f in enumerate(order)}
    new_order: List[int] = []
    node_of: List[int] = []
    for node_idx, f in enumerate(order):
        atoms = list(frags[f])
        if node_idx == 0 and latom in atoms:
            atoms.remove(latom)
            atoms.insert(0, latom)
        for a in atoms:
            new_order.append(a)
            node_of.append(node_idx + 1)   # node 0 is the virtual root
    remap = {old: new for new, old in enumerate(new_order)}

    types_l = lig.assign_smina_types()[new_order]
    charges_l = np.array([lig.atoms[i].charge for i in new_order], np.float32)
    coords_l = lig_coords[new_order]
    types_r = covres.assign_smina_types()
    charges_r = np.array([a.charge for a in covres.atoms], np.float32)
    coords_r = np.array([a.coords for a in covres.atoms], np.float32)

    m = len(order) + 1  # + virtual root
    parent = np.full(m, -1, np.int32)
    rel_axis = np.zeros((m, 3), np.float32)
    rel_axis[:, 0] = 1.0
    rel_origin = np.zeros((m, 3), np.float32)
    layer = np.zeros(m, np.int32)
    parent_anchor = np.full(m, -1, np.int32)
    node_origin = np.zeros((m, 3), np.float32)

    # node 1: first_segment about ratom->latom (absolute frame, parent -1)
    rpos = coords_r[ratom]
    lpos = coords_l[0]
    axis = lpos - rpos
    axis = axis / max(np.linalg.norm(axis), 1e-9)
    layer[1] = 1
    rel_axis[1] = axis
    rel_origin[1] = lpos
    node_origin[1] = lpos
    parent_anchor[1] = nl + ratom  # covres block index (for exclusions only)

    for node_idx, f in enumerate(order):
        node = node_idx + 1
        if node == 1:
            continue
        pf, pa_old, ca_old = parent_frag[f]
        p_node = frag_rank[pf] + 1
        parent[node] = p_node
        layer[node] = layer[p_node] + 1
        pa, ca = remap[pa_old], remap[ca_old]
        parent_anchor[node] = pa
        origin = coords_l[ca]
        node_origin[node] = origin
        ax = origin - coords_l[pa]
        nrm = np.linalg.norm(ax)
        if nrm < 1e-6:
            raise ValueError(f"degenerate rotatable bond axis in {lig.name}")
        rel_axis[node] = ax / nrm
        rel_origin[node] = origin - node_origin[p_node]

    all_coords = np.concatenate([coords_l, coords_r]).astype(np.float32)
    all_types = np.concatenate([types_l, types_r]).astype(np.int32)
    all_charges = np.concatenate([charges_l, charges_r]).astype(np.float32)
    node_id = np.concatenate([np.array(node_of, np.int32),
                              np.zeros(len(types_r), np.int32)])
    local = all_coords.copy()
    local[:nl] = coords_l - node_origin[node_id[:nl]]

    # pairs over the merged graph (ligand indices remapped)
    merged_remap = {**remap, **{nl + i: nl + i for i in range(len(types_r))}}
    other = _covalent_pairs(merged, merged_remap, nl, all_types, node_id,
                            parent_anchor)

    ci = _cov_conf_independent(lig, types_l, rot_bonds, remap, table)
    new_mol = Molecule(name=lig.name)
    new_mol.atoms = [copy.copy(lig.atoms[i]) for i in new_order]
    for i, a in enumerate(new_mol.atoms):
        a.coords = coords_l[i]
    for b in lig.bonds:
        nb = copy.copy(b)
        nb.a, nb.b = remap[b.a], remap[b.b]
        new_mol.bonds.append(nb)
    new_mol.invalidate()

    return LigandStruct(
        name=lig.name,
        local_coords=local.astype(np.float32),
        orig_coords=all_coords,
        types=all_types,
        charges=all_charges,
        node_id=node_id.astype(np.int32),
        parent=parent,
        rel_axis=rel_axis,
        rel_origin=rel_origin,
        layer=layer,
        parent_anchor=parent_anchor,
        pairs=np.zeros((0, 2), np.int32),
        num_tors=ci["num_tors"],
        num_heavy_atoms=ci["num_heavy_atoms"],
        num_hydrophobic_atoms=ci["num_hydrophobic_atoms"],
        ligand_length=ci["ligand_length"],
        torsdof=len(rot_bonds) + 1,
        mol=new_mol,
        num_lig_atoms=nl,
        num_movable_atoms=nl,
        other_pairs=other,
        flex_meta=[("covalent", covres.name, 0, nl, None)],
        has_rigid_dof=False,
    )


def _covalent_pairs(merged: Molecule, remap, nl: int, types, node_id,
                    parent_anchor) -> np.ndarray:
    """1-4+ pairs involving at least one movable (ligand) atom, evaluated
    at v[2] like flex other_pairs (model.cu eval_deriv)."""
    n = merged.num_atoms()
    # merged graph uses OLD ligand indices; build adjacency in NEW indices
    adj = [[] for _ in range(n)]
    inv = {}
    for old, new in remap.items():
        inv[old] = new
    for b in merged.bonds:
        a2, b2 = inv[b.a], inv[b.b]
        adj[a2].append(b2)
        adj[b2].append(a2)

    within3 = []
    for i in range(n):
        seen = {i}
        frontier = [i]
        for _ in range(3):
            nxt = []
            for u in frontier:
                for v in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        within3.append(seen)

    anchors_of_node = {}
    for node, pa in enumerate(parent_anchor):
        if pa >= 0:
            anchors_of_node[node] = int(pa)

    hyd = IS_HYDROGEN[types]
    pairs = []
    for i in range(n):
        if hyd[i]:
            continue
        for j in range(max(i + 1, nl), n) if i < nl else range(i + 1, n):
            # at least one ligand (movable) atom
            if i >= nl and j >= nl:
                continue
            if hyd[j]:
                continue
            if node_id[i] == node_id[j] and i < nl and j < nl:
                continue
            if i >= nl or j >= nl:
                pass  # inflex node_id is 0 but they never move together
            if anchors_of_node.get(int(node_id[j])) == i:
                continue
            if anchors_of_node.get(int(node_id[i])) == j:
                continue
            if j in within3[i]:
                continue
            pairs.append((i, j))
    # also ligand-ligand cross-node pairs (the merged loop above skips
    # i<nl, j<nl only when same node)
    return np.array(pairs, np.int32).reshape(-1, 2)


def _cov_conf_independent(lig: Molecule, types, rot_bonds, remap, table):
    hyd = IS_HYDROGEN[types]
    heavy_deg = [lig.heavy_degree(i) for i in range(lig.num_atoms())]
    rot_new = {(min(remap[a], remap[b]), max(remap[a], remap[b]))
               for (a, b) in rot_bonds}
    inv = {v: k for k, v in remap.items()}
    num_tors = 0.0
    for i_new in range(len(types)):
        if hyd[i_new]:
            continue
        i = inv[i_new]
        ar = 0
        for j in lig.neighbors(i):
            j_new = remap[j]
            key = (min(i_new, j_new), max(i_new, j_new))
            if key in rot_new and not hyd[j_new] and heavy_deg[j] > 1 \
                    and heavy_deg[i] > 1:
                ar += 1
        num_tors += 0.5 * ar
    num_heavy = int((~hyd).sum())
    num_hydrophobic = int(np.sum(table.xs_hydrophobe[types] & ~hyd))
    return {"num_tors": num_tors, "num_heavy_atoms": num_heavy,
            "num_hydrophobic_atoms": num_hydrophobic,
            "ligand_length": 0.0}
