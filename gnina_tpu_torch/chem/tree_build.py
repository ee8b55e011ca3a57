"""Kinematic tree construction: molecule -> flat BFS-layered arrays.

Replaces the reference's parsing_struct/heterotree pipeline (reference:
gninasrc/lib/parse_pdbqt.cpp postprocess_ligand, PDBQTUtilities.cpp
FindFragments/ConstructTree, tree.h) with a TPU-friendly representation:
every ligand becomes a set of padded arrays — per-atom local coordinates +
node assignment, per-node parent/axis tables ordered so that forward
kinematics is a scan over BFS layers.

Conventions matching the reference:
- root node origin = coordinates of the FIRST root atom
  (parse_pdbqt.cpp:388 postprocess_ligand)
- segment origin = coordinates of the branch's anchor atom on the child
  side; axis = normalize(child_anchor - parent_anchor) (tree.h:180-187)
- atom local coords = lab coords - owning node's initial origin
  (parsing.h:155), valid because initial orientations are identity
- rotatable bond (SDF path): single, non-amide, non-ring bond whose both
  ends have >=2 heavy neighbors (PDBQTUtilities.cpp IsRotBond_PDBQT)
- root choice: atom minimizing the largest remaining fragment
  (PDBQTUtilities.cpp FindFragments)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gnina_tpu_torch.chem.mol import Molecule
from gnina_tpu_torch.chem.pdbqt import PdbqtBranch, PdbqtLigand
from gnina_tpu_torch.constants import IS_HYDROGEN, AtomTypeTable, DEFAULT_TABLE


@dataclasses.dataclass
class LigandStruct:
    """Host-side (numpy, unpadded) ligand ready for device conversion."""

    name: str
    # per atom, in node-contiguous order
    local_coords: np.ndarray   # (N,3) relative to owning node origin
    orig_coords: np.ndarray    # (N,3) lab coords as read
    types: np.ndarray          # (N,) smina type ids
    charges: np.ndarray        # (N,)
    node_id: np.ndarray        # (N,)
    # per node; node 0 = root rigid body
    parent: np.ndarray         # (M,) int, -1 for root
    rel_axis: np.ndarray       # (M,3) axis in parent initial frame (junk for root)
    rel_origin: np.ndarray     # (M,3) origin - parent origin (initial)
    layer: np.ndarray          # (M,) BFS depth (root=0)
    parent_anchor: np.ndarray  # (M,) atom index of parent-side bond atom, -1 for root
    # intra-ligand interacting pairs (>3 bonds apart, mobile rel. each other)
    pairs: np.ndarray          # (P,2) int
    # conf-independent inputs
    num_tors: float
    num_heavy_atoms: int
    num_hydrophobic_atoms: int
    ligand_length: float
    torsdof: int
    # molecule (new atom order) for output writing
    mol: Molecule = None
    # flexible-residue extension (attach_flex): atoms beyond num_lig_atoms
    # are flex-movable, then static inflex anchors
    num_lig_atoms: int = -1            # -1 -> all atoms are ligand
    num_movable_atoms: int = -1        # -1 -> all atoms movable
    other_pairs: np.ndarray = None     # (Q,2) pairs evaluated at v[2]
    flex_meta: list = None             # [(key, resname, start, end), ...]
    # covalent complexes have no rigid-body DOF: position/orientation are
    # frozen and mutations draw torsions only (chem/covalent.py)
    has_rigid_dof: bool = True

    @property
    def num_atoms(self) -> int:
        return len(self.types)

    @property
    def lig_atoms(self) -> int:
        return self.num_lig_atoms if self.num_lig_atoms >= 0 else len(self.types)

    @property
    def movable_atoms(self) -> int:
        return (self.num_movable_atoms if self.num_movable_atoms >= 0
                else len(self.types))

    @property
    def num_nodes(self) -> int:
        return len(self.parent)

    @property
    def num_torsions(self) -> int:
        return len(self.parent) - 1

    def gyration_radius(self) -> float:
        """Heavy-atom RMS distance from root origin (model.cpp:1002-1013)."""
        heavy = ~IS_HYDROGEN[self.types]
        if not heavy.any():
            return 0.0
        root_origin = self.orig_coords[self.node_id == 0][0:1]
        # reference uses node origin = first root atom's coords
        d2 = ((self.orig_coords[heavy] - self._root_origin()) ** 2).sum(axis=1)
        return float(np.sqrt(d2.mean()))

    def _root_origin(self) -> np.ndarray:
        # first atom of node 0 (atom order is node-contiguous, root first)
        return self.orig_coords[0]

    def max_span(self) -> float:
        heavy = self.orig_coords[~IS_HYDROGEN[self.types]]
        if len(heavy) < 2:
            return 0.0
        d2 = ((heavy[:, None, :] - heavy[None, :, :]) ** 2).sum(-1)
        return float(np.sqrt(d2.max()))


def is_rotatable_bond(mol: Molecule, a: int, b: int, order: int,
                      in_ring: bool, amide: bool) -> bool:
    if order != 1 or amide or in_ring:
        return False
    if mol.heavy_degree(a) < 2 or mol.heavy_degree(b) < 2:
        return False
    return True


def _fragments_and_root(mol: Molecule) -> Tuple[List[List[int]], List[Tuple[int, int]], int]:
    """Rigid fragments after cutting rotatable bonds + best root atom."""
    n = mol.num_atoms()
    adj = mol.adjacency()

    # best root: minimize the largest connected component after removing atom
    def components(skip_atom: Optional[int], cut_bonds: set) -> List[List[int]]:
        seen = [False] * n
        comps = []
        for s in range(n):
            if seen[s] or s == skip_atom:
                continue
            comp = [s]
            seen[s] = True
            stack = [s]
            while stack:
                u = stack.pop()
                for v, bond in adj[u]:
                    if v == skip_atom or seen[v]:
                        continue
                    key = (min(u, v), max(u, v))
                    if key in cut_bonds:
                        continue
                    seen[v] = True
                    comp.append(v)
                    stack.append(v)
            comps.append(comp)
        return comps

    best_root, best_size = 0, n + 1
    for i in range(n):
        comps = components(i, set())
        largest = max((len(c) for c in comps), default=0)
        if largest < best_size:
            best_size = largest
            best_root = i

    cut = set()
    rot_bonds = []
    for bond in mol.bonds:
        if is_rotatable_bond(mol, bond.a, bond.b, bond.order, bond.in_ring, bond.amide):
            key = (min(bond.a, bond.b), max(bond.a, bond.b))
            cut.add(key)
            rot_bonds.append(key)
    frags = components(None, cut)
    return frags, rot_bonds, best_root


def build_tree_from_molecule(mol: Molecule, table: AtomTypeTable = DEFAULT_TABLE,
                             root_atom: Optional[int] = None,
                             strip_h: bool = True,
                             add_h: bool = True) -> LigandStruct:
    """SDF/arbitrary-format path: perceive rotors, fragment, build the tree.

    strip_h: drop nonpolar explicit hydrogens before tree build (reference
      --stripH, main.cpp:1052 / model::strip_hydrogens — typing is
      H-count-equivalent either way, stripping shrinks the kernels; our
      CLI defaults this ON as a TPU-first efficiency choice).
    add_h: implicit-H valence completion during typing (--addH,
      GninaConverter.cpp:84); off types atoms as drawn.
    """
    work = mol
    work.perceive_all()
    if strip_h:
        work.strip_nonpolar_hydrogens()
        work.perceive_all()  # refresh ring/amide flags on the reduced graph

    frags, rot_bonds, best_root = _fragments_and_root(work)
    if root_atom is not None:
        best_root = root_atom

    frag_of_atom = {}
    for fi, frag in enumerate(frags):
        for a in frag:
            frag_of_atom[a] = fi
    root_frag = frag_of_atom[best_root]

    # build node tree over fragments connected by rotatable bonds
    children: Dict[int, List[Tuple[int, int, int]]] = {fi: [] for fi in range(len(frags))}
    adj_frags: Dict[int, List[Tuple[int, int, int]]] = {fi: [] for fi in range(len(frags))}
    for (a, b) in rot_bonds:
        fa, fb = frag_of_atom[a], frag_of_atom[b]
        adj_frags[fa].append((fb, a, b))
        adj_frags[fb].append((fa, b, a))

    # BFS from root fragment
    order = [root_frag]
    parent_frag = {root_frag: (-1, -1, -1)}  # frag -> (parent frag, parent_anchor_atom, child_anchor_atom)
    qi = 0
    while qi < len(order):
        f = order[qi]
        qi += 1
        for (g, pa, ca) in adj_frags[f]:
            if g not in parent_frag:
                parent_frag[g] = (f, pa, ca)
                order.append(g)

    return _assemble(work, table, frags, order, parent_frag, frag_of_atom,
                     root_first_atom=best_root, torsdof=len(rot_bonds),
                     name=mol.name, add_h=add_h)


def build_tree_from_pdbqt(lig: PdbqtLigand, table: AtomTypeTable = DEFAULT_TABLE,
                          fix_rotable_hydrogens: bool = True) -> LigandStruct:
    """PDBQT path: the BRANCH records already define the tree.

    fix_rotable_hydrogens=False is the reference's --flex_hydrogens
    (main.cpp:1003,1150 -> set_fixed_rotable_hydrogens): hydrogen-only
    leaf branches stay mobile (parsing.h:214 mobile_hydrogens_only) and
    terminal polar-H rotors count toward num_tors (terms.cpp:63).  The
    flag only applies to PDBQT ligands: the SDF/OB path force-fixes
    (PDBQTUtilities.cpp:460 OutputTree)."""
    mol = lig.mol
    frags: List[List[int]] = [list(lig.root_atoms)]
    parent_frag: Dict[int, Tuple[int, int, int]] = {0: (-1, -1, -1)}
    order = [0]

    def walk(br: PdbqtBranch, parent_idx: int):
        # freeze branches whose MOBILE atoms are all hydrogens (e.g. -OH:
        # the branch-anchor O sits on the axis and is immobile, so it is
        # exempt from the check — parsing.h:214-224 mobile_hydrogens_only)
        mobile = [i for i in br.atoms if i != br.my_serial]
        all_h = bool(mobile) and all(mol.atoms[i].anum == 1 for i in mobile)
        if all_h and fix_rotable_hydrogens and not br.children:
            frags[parent_idx].extend(br.atoms)
            return
        fi = len(frags)
        frags.append(list(br.atoms))
        parent_frag[fi] = (parent_idx, br.parent_serial, br.my_serial)
        order.append(fi)
        for c in br.children:
            walk(c, fi)

    for br in lig.branches:
        walk(br, 0)

    frag_of_atom = {}
    for fi, frag in enumerate(frags):
        for a in frag:
            frag_of_atom[a] = fi

    root_first = lig.root_atoms[0] if lig.root_atoms else 0
    return _assemble(mol, table, frags, order, parent_frag, frag_of_atom,
                     root_first_atom=root_first, torsdof=lig.torsdof,
                     name=mol.name,
                     fixed_rotable_hydrogens=fix_rotable_hydrogens)


def _assemble(mol: Molecule, table: AtomTypeTable, frags, order, parent_frag,
              frag_of_atom, root_first_atom: int, torsdof: int,
              name: str, add_h: bool = True,
              fixed_rotable_hydrogens: bool = True) -> LigandStruct:
    types_all = mol.assign_smina_types(add_h=add_h)
    coords_all = mol.coords()
    charges_all = np.array([a.charge for a in mol.atoms], np.float32)

    # new atom order: node-contiguous, nodes in BFS order, root-first atom
    # leading (it defines the root origin, matching postprocess_ligand)
    frag_rank = {f: i for i, f in enumerate(order)}
    new_order: List[int] = []
    node_of_new: List[int] = []
    for node_idx, f in enumerate(order):
        atoms = list(frags[f])
        if node_idx == 0 and root_first_atom in atoms:
            atoms.remove(root_first_atom)
            atoms.insert(0, root_first_atom)
        for a in atoms:
            new_order.append(a)
            node_of_new.append(node_idx)
    remap = {old: new for new, old in enumerate(new_order)}

    n = len(new_order)
    m = len(order)
    coords = coords_all[new_order]
    types = types_all[new_order]
    charges = charges_all[new_order]
    node_id = np.array(node_of_new, np.int32)

    # node tables
    parent = np.full(m, -1, np.int32)
    rel_axis = np.zeros((m, 3), np.float32)
    rel_origin = np.zeros((m, 3), np.float32)
    layer = np.zeros(m, np.int32)
    parent_anchor = np.full(m, -1, np.int32)
    node_origin = np.zeros((m, 3), np.float32)
    node_origin[0] = coords[0]

    for node_idx, f in enumerate(order):
        if node_idx == 0:
            continue
        pf, pa_old, ca_old = parent_frag[f]
        p_node = frag_rank[pf]
        parent[node_idx] = p_node
        layer[node_idx] = layer[p_node] + 1
        pa, ca = remap[pa_old], remap[ca_old]
        parent_anchor[node_idx] = pa
        origin = coords[ca]
        node_origin[node_idx] = origin
        axis = origin - coords[pa]
        nrm = np.linalg.norm(axis)
        if nrm < 1e-6:
            raise ValueError(f"degenerate rotatable bond axis in {name}")
        rel_axis[node_idx] = axis / nrm
        rel_origin[node_idx] = origin - node_origin[p_node]

    local_coords = coords - node_origin[node_id]

    # remap bonds; mark rotatable bonds (anchor pairs)
    rot_pairs = set()
    for node_idx, f in enumerate(order):
        if node_idx == 0:
            continue
        pf, pa_old, ca_old = parent_frag[f]
        rot_pairs.add((min(remap[pa_old], remap[ca_old]),
                       max(remap[pa_old], remap[ca_old])))
    new_mol = Molecule(name=name)
    new_mol.atoms = [mol.atoms[i] for i in new_order]
    for b in mol.bonds:
        if b.a in remap and b.b in remap:
            import copy

            nb = copy.copy(b)
            nb.a, nb.b = remap[b.a], remap[b.b]
            new_mol.bonds.append(nb)
    new_mol.invalidate()

    pairs = _interacting_pairs(new_mol, types, node_id, parent_anchor)
    ci = _conf_independent_inputs(new_mol, types, rot_pairs, table, order,
                                  parent_frag, frag_rank,
                                  fixed_rotable_hydrogens)

    return LigandStruct(
        name=name,
        local_coords=local_coords.astype(np.float32),
        orig_coords=coords.astype(np.float32),
        types=types.astype(np.int32),
        charges=charges,
        node_id=node_id,
        parent=parent,
        rel_axis=rel_axis,
        rel_origin=rel_origin,
        layer=layer,
        parent_anchor=parent_anchor,
        pairs=pairs,
        num_tors=ci["num_tors"],
        num_heavy_atoms=ci["num_heavy_atoms"],
        num_hydrophobic_atoms=ci["num_hydrophobic_atoms"],
        ligand_length=ci["ligand_length"],
        torsdof=torsdof,
        mol=new_mol,
    )


def empty_ligand_struct(name: str = "no_lig") -> LigandStruct:
    """A zero-atom ligand for --no_lig runs (main.cpp no-ligand branch):
    flex residues attach to it and carry every DOF."""
    return LigandStruct(
        name=name,
        local_coords=np.zeros((0, 3), np.float32),
        orig_coords=np.zeros((0, 3), np.float32),
        types=np.zeros(0, np.int32),
        charges=np.zeros(0, np.float32),
        node_id=np.zeros(0, np.int32),
        parent=np.array([-1], np.int32),
        rel_axis=np.array([[1.0, 0, 0]], np.float32),
        rel_origin=np.zeros((1, 3), np.float32),
        layer=np.zeros(1, np.int32),
        parent_anchor=np.array([-1], np.int32),
        pairs=np.zeros((0, 2), np.int32),
        num_tors=0.0, num_heavy_atoms=0, num_hydrophobic_atoms=0,
        ligand_length=0.0, torsdof=0, mol=Molecule(name=name),
        has_rigid_dof=False,
    )


def attach_flex(lig: LigandStruct, flexres: Sequence) -> LigandStruct:
    """Append flexible side chains to a ligand's DOF/atom arrays.

    Produces the combined movable system (reference: model::append merging
    ligand + flex, model.cpp:174): atom order is [ligand | flex movable...
    | inflex anchors], node order is [ligand nodes | flex nodes], flex root
    segments keep parent = -1 (virtual identity frame — exactly the
    first_segment semantics of tree.h:266-291).
    """
    if not flexres:
        return lig
    hyd_all = IS_HYDROGEN

    coords = [lig.orig_coords]
    local = [lig.local_coords]
    types = [lig.types]
    charges = [lig.charges]
    node_id = [lig.node_id]
    parents = [lig.parent]
    axes = [lig.rel_axis]
    origins = [lig.rel_origin]
    layers = [lig.layer]
    anchors = [lig.parent_anchor]

    n0 = lig.num_atoms
    m0 = lig.num_nodes
    atom_off = n0
    node_off = m0
    groups = [(0, n0)]          # movable atom ranges per group (ligand first)
    res_pairs = []              # remapped within-residue pairs
    inflex_blocks = []
    flex_meta = []

    for fr in flexres:
        f_n = len(fr.types)
        coords.append(fr.coords)
        local.append(fr.coords - _node_origins_of(fr)[fr.node_of_atom])
        types.append(fr.types)
        charges.append(fr.charges)
        node_id.append(fr.node_of_atom + node_off)
        parents.append(np.where(fr.parent >= 0, fr.parent + node_off,
                                -1).astype(np.int32))
        axes.append(fr.rel_axis)
        origins.append(fr.rel_origin)
        layers.append(fr.layer)
        anchors.append(np.where(fr.parent_anchor_local >= 0,
                                fr.parent_anchor_local + atom_off,
                                -1).astype(np.int32))
        groups.append((atom_off, atom_off + f_n))
        res_pairs.append((fr.pairs, atom_off, f_n))
        inflex_blocks.append(fr)
        flex_meta.append((fr.key, fr.resname, atom_off, atom_off + f_n, fr))
        atom_off += f_n
        node_off += len(fr.parent)

    num_movable = atom_off
    # inflex anchors appended as static atoms (node 0, overridden by
    # movable_mask in FK)
    inflex_start = atom_off
    inflex_of_res = []
    for fr in inflex_blocks:
        k = len(fr.inflex_types)
        coords.append(fr.inflex_coords)
        local.append(fr.inflex_coords)  # absolute; FK bypasses static atoms
        types.append(fr.inflex_types)
        charges.append(fr.inflex_charges)
        node_id.append(np.zeros(k, np.int32))
        inflex_of_res.append((inflex_start, inflex_start + k))
        inflex_start += k

    all_coords = np.concatenate(coords).astype(np.float32)
    all_types = np.concatenate(types).astype(np.int32)
    n_total = len(all_types)
    heavy = ~IS_HYDROGEN[all_types]

    # other_pairs (v[2]): within-residue pairs + all heavy cross-group pairs
    other = []
    for ri, (prs, off, f_n) in enumerate(res_pairs):
        istart, iend = inflex_of_res[ri]
        for (a, b) in prs:
            ga = off + a if a < f_n else istart + (a - f_n)
            gb = off + b if b < f_n else istart + (b - f_n)
            other.append((ga, gb))
    # cross-group: ligand x flex, flex x flex (different residues),
    # movable x other residues' inflex, ligand x inflex
    blocks = groups + inflex_of_res
    kinds = (["mov"] * len(groups)) + (["inflex"] * len(inflex_of_res))
    for bi in range(len(blocks)):
        for bj in range(bi + 1, len(blocks)):
            if kinds[bi] == "inflex" and kinds[bj] == "inflex":
                continue
            # same residue movable x inflex already covered by fr.pairs
            if kinds[bi] == "mov" and kinds[bj] == "inflex" \
                    and bi >= 1 and bj - len(groups) == bi - 1:
                continue
            (s1, e1), (s2, e2) = blocks[bi], blocks[bj]
            for a in range(s1, e1):
                if not heavy[a]:
                    continue
                for b in range(s2, e2):
                    if heavy[b]:
                        other.append((a, b))

    return dataclasses.replace(
        lig,
        local_coords=np.concatenate(local).astype(np.float32),
        orig_coords=all_coords,
        types=all_types,
        charges=np.concatenate(charges).astype(np.float32),
        node_id=np.concatenate(node_id).astype(np.int32),
        parent=np.concatenate(parents).astype(np.int32),
        rel_axis=np.concatenate(axes).astype(np.float32),
        rel_origin=np.concatenate(origins).astype(np.float32),
        layer=np.concatenate(layers).astype(np.int32),
        parent_anchor=np.concatenate(anchors).astype(np.int32),
        num_lig_atoms=n0,
        num_movable_atoms=num_movable,
        other_pairs=np.array(other, np.int32).reshape(-1, 2),
        flex_meta=flex_meta,
    )


def _node_origins_of(fr) -> np.ndarray:
    """Reconstruct per-node absolute origins of a FlexResidue."""
    mf = len(fr.parent)
    out = np.zeros((mf, 3), np.float32)
    for i in range(mf):
        if fr.parent[i] < 0:
            out[i] = fr.rel_origin[i]
        else:
            out[i] = out[fr.parent[i]] + fr.rel_origin[i]
    return out


def _interacting_pairs(mol: Molecule, types, node_id, parent_anchor) -> np.ndarray:
    """1-4+ pairs that can move relative to each other (model.cpp:682-703).

    Excluded: hydrogen pairs, atoms within 3 bonds, same rigid node, and
    node-vs-its-parent-anchor (distances preserved by axis rotation).
    """
    n = len(types)
    adj = mol.adjacency()

    # atoms within 3 bonds of each atom
    within3: List[set] = []
    for i in range(n):
        seen = {i}
        frontier = [i]
        for _ in range(3):
            nxt = []
            for u in frontier:
                for v, _b in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        within3.append(seen)

    anchors_of_node: Dict[int, int] = {}
    for node, pa in enumerate(parent_anchor):
        if pa >= 0:
            anchors_of_node[node] = int(pa)

    pairs = []
    hyd = IS_HYDROGEN[types]
    for i in range(n):
        if hyd[i]:
            continue
        for j in range(i + 1, n):
            if hyd[j]:
                continue
            if node_id[i] == node_id[j]:
                continue
            if anchors_of_node.get(int(node_id[j])) == i:
                continue
            if anchors_of_node.get(int(node_id[i])) == j:
                continue
            if j in within3[i]:
                continue
            pairs.append((i, j))
    return np.array(pairs, np.int32).reshape(-1, 2)


def _conf_independent_inputs(mol: Molecule, types, rot_pairs, table,
                             order, parent_frag, frag_rank,
                             fixed_rotable_hydrogens: bool = True) -> dict:
    """num_tors / heavy counts / branch metrics (terms.cpp:74-106,
    model.cpp:435-462)."""
    hyd = IS_HYDROGEN[types]
    # degree over non-hydrogen-TYPED neighbours: the reference counts via
    # model bonds where is_hydrogen(type) excludes the atom
    # (terms.cpp:39-48 num_bonded_heavy_atoms); atoms typed Hydrogen by the
    # "ignore" rule (e.g. SDF "*" dummies) must not count as heavy here.
    heavy_deg = [sum(1 for j in mol.neighbors(i) if not hyd[j])
                 for i in range(len(types))]

    num_tors = 0.0
    for i in range(len(types)):
        if hyd[i]:
            continue
        ar = 0
        for j in mol.neighbors(i):
            key = (min(i, j), max(i, j))
            # terms.cpp:60-66 atom_rotors: the far end must be a heavy
            # rotor hub; the near end's heavy-degree test is waived under
            # --flex_hydrogens (!get_fixed_rotable_hydrogens, terms.cpp:63)
            if (key in rot_pairs and not hyd[j] and heavy_deg[j] > 1
                    and (heavy_deg[i] > 1 or not fixed_rotable_hydrogens)):
                ar += 1
        num_tors += 0.5 * ar

    num_heavy = int((~hyd).sum())
    num_hydrophobic = int(np.sum(table.xs_hydrophobe[types] & ~hyd))

    # branch metrics over the node tree (model.cpp get_branch_metrics)
    children: Dict[int, List[int]] = {i: [] for i in range(len(order))}
    for node_idx in range(1, len(order)):
        pf = parent_frag[order[node_idx]][0]
        children[frag_rank[pf]].append(node_idx)

    def metrics(node) -> Tuple[int, int]:
        if not children[node]:
            return 0, 0
        lengths = []
        c2c_max = 0
        for c in children[node]:
            length, c2c = metrics(c)
            c2c_max = max(c2c_max, c2c)
            lengths.append(length + 1)
        lengths.sort()
        length = lengths[-1]
        c2c = length + (lengths[-2] if len(lengths) >= 2 else 0)
        return length, max(c2c, c2c_max)

    _, lig_len = metrics(0)
    return {
        "num_tors": num_tors,
        "num_heavy_atoms": num_heavy,
        "num_hydrophobic_atoms": num_hydrophobic,
        "ligand_length": float(lig_len),
    }
