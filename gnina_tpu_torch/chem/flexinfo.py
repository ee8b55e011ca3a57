"""Flexible side-chain selection and extraction (FlexInfo equivalent).

reference: gninasrc/lib/flexinfo.cpp.  Residues are chosen explicitly
("chain:resid[:icode]" specs) or by distance to a reference ligand
(--flexdist/--flexdist_ligand); their side chains (CB onward, rooted at CA)
become movable trees appended to the ligand's DOF vector, while CA/C stay
as static "inflex" atoms and the rest of the backbone remains in the rigid
receptor.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from gnina_tpu_torch.chem.ingest import Receptor
from gnina_tpu_torch.chem.mol import Molecule
from gnina_tpu_torch.constants import IS_HYDROGEN

# reference: flexinfo.cpp:80-82
INFLEXIBLE_RESIDUES = {"ALA", "GLY", "PRO"}

# sanity bound on residue size (flexinfo.cpp:16-21)
NUM_HEAVY_ATOMS_PER_RESIDUE = {
    "ARG": 12, "HIS": 11, "LYS": 10, "ASP": 9, "GLU": 10, "SER": 7,
    "THR": 8, "ASN": 9, "GLN": 9, "CYS": 7, "SEC": 7, "GLY": 5,
    "PRO": 8, "ALA": 6, "VAL": 8, "ILE": 9, "LEU": 9, "MET": 9,
    "PHE": 12, "TYR": 13, "TRP": 15,
}

BACKBONE_RIGID = {"N", "O", "H", "HN", "OXT", "H1", "H2", "H3"}


@dataclasses.dataclass
class FlexResidue:
    """One extracted flexible side chain, host-side."""

    key: Tuple[str, int, str]          # (chain, resnum, icode)
    resname: str
    # movable atoms in node-contiguous order
    coords: np.ndarray                 # (F,3)
    types: np.ndarray                  # (F,)
    charges: np.ndarray                # (F,)
    node_of_atom: np.ndarray           # (F,) local node ids (0..num_nodes-1)
    # node tables; node 0 is the first_segment (CA->CB rotation)
    parent: np.ndarray                 # (Mf,) local; -1 for the root segment
    rel_axis: np.ndarray               # (Mf,3); absolute for the root
    rel_origin: np.ndarray             # (Mf,3); absolute for the root
    layer: np.ndarray                  # (Mf,) 1-based depth within the residue
    parent_anchor_local: np.ndarray    # (Mf,) local atom idx of parent-side
                                       #   bond atom; -1 root (anchor = CA)
    # static anchor atoms (CA, C): interact but never move
    inflex_coords: np.ndarray          # (I,3)
    inflex_types: np.ndarray
    inflex_charges: np.ndarray
    # pairs within the residue (local indices; movable block then inflex)
    pairs: np.ndarray                  # (Pf,2)
    atoms_mol: Molecule = None

    @property
    def num_torsions(self) -> int:
        return len(self.parent)


def parse_flexres_spec(spec: str) -> Set[Tuple[str, int, str]]:
    """Parse "A:123,B:45:C" style --flexres specs (flexinfo.cpp:30-70)."""
    out = set()
    for tok in spec.split(","):
        tok = tok.strip()
        if not tok:
            continue
        parts = tok.split(":")
        if len(parts) == 1:
            out.add(("", int(parts[0]), ""))
        elif len(parts) == 2:
            out.add((parts[0], int(parts[1]), ""))
        elif len(parts) == 3:
            out.add((parts[0], int(parts[1]), parts[2]))
    return out


def select_flex_residues(rec: Receptor,
                         flexres: Optional[str] = None,
                         flexdist: float = -1.0,
                         flexdist_coords: Optional[np.ndarray] = None,
                         flex_limit: int = -1,
                         flex_max: int = -1) -> List[Tuple[str, int, str]]:
    """Residue keys to make flexible, by spec and/or distance."""
    keys: List[Tuple[str, int, str]] = []
    wanted = parse_flexres_spec(flexres) if flexres else set()

    residues: Dict[Tuple[str, int, str], List[int]] = {}
    names: Dict[Tuple[str, int, str], str] = {}
    for i, a in enumerate(rec.mol.atoms):
        k = (a.chain, a.resnum, a.icode)
        residues.setdefault(k, []).append(i)
        names[k] = a.resname

    dists: Dict[Tuple[str, int, str], float] = {}
    for k, idxs in residues.items():
        resname = names[k]
        if resname in INFLEXIBLE_RESIDUES:
            continue
        if resname not in NUM_HEAVY_ATOMS_PER_RESIDUE:
            continue  # hetero groups are not side-chain flexible
        matched = (k in wanted or ("", k[1], "") in wanted
                   or (k[0], k[1], "") in wanted)
        if matched:
            keys.append(k)
            continue
        if flexdist > 0 and flexdist_coords is not None:
            c = rec.coords[idxs]
            d = np.sqrt(((c[:, None, :] - flexdist_coords[None]) ** 2)
                        .sum(-1)).min()
            if d <= flexdist:
                dists[k] = float(d)
    if dists:
        ordered = sorted(dists, key=dists.get)
        if flex_limit > 0 and len(ordered) > flex_limit:
            raise RuntimeError(
                f"Flexible residues ({len(ordered)}) exceed --flex_limit "
                f"({flex_limit})")
        if flex_max > 0:
            ordered = ordered[:flex_max]
        keys.extend(ordered)
    return keys


def extract_flex_residue(rec: Receptor, key: Tuple[str, int, str]
                         ) -> Optional[FlexResidue]:
    """Build the side-chain tree for one residue (flexinfo.cpp
    extract_residue + the PDBQT round trip, collapsed)."""
    idxs = [i for i, a in enumerate(rec.mol.atoms)
            if (a.chain, a.resnum, a.icode) == key]
    if not idxs:
        return None
    resname = rec.mol.atoms[idxs[0]].resname
    byname = {}
    for i in idxs:
        byname.setdefault(rec.mol.atoms[i].name, i)
    if "CA" not in byname or "CB" not in byname:
        return None

    ca, cb = byname["CA"], byname["CB"]
    # movable = residue atoms minus backbone-rigid minus CA/C
    movable = [i for i in idxs
               if rec.mol.atoms[i].name not in BACKBONE_RIGID
               and rec.mol.atoms[i].name not in ("CA", "C")]
    inflex = [i for i in (byname.get("CA"), byname.get("C")) if i is not None]
    if not movable:
        return None

    # side-chain subgraph over movable+CA; rotatable bonds by the standard
    # rule computed with degrees on the FULL residue graph
    adj = rec.mol.adjacency()
    movset = set(movable)

    def heavy_deg(i):
        return sum(1 for j, _ in adj[i] if rec.mol.atoms[j].anum != 1)

    # fragment movable atoms by cutting rotatable side-chain bonds
    cut = set()
    for i in movable:
        for j, b in adj[i]:
            if j in movset and j > i:
                if (b.order == 1 and not b.in_ring and not b.amide
                        and heavy_deg(i) >= 2 and heavy_deg(j) >= 2
                        and rec.mol.atoms[i].anum != 1
                        and rec.mol.atoms[j].anum != 1):
                    cut.add((i, j))

    def components():
        seen, comps = set(), []
        for s in movable:
            if s in seen:
                continue
            comp, stack = [s], [s]
            seen.add(s)
            while stack:
                u = stack.pop()
                for v, _b in adj[u]:
                    if v in movset and v not in seen \
                            and (min(u, v), max(u, v)) not in cut:
                        seen.add(v)
                        comp.append(v)
                        stack.append(v)
            comps.append(comp)
        return comps

    frags = components()
    frag_of = {}
    for fi, f in enumerate(frags):
        for a in f:
            frag_of[a] = fi

    # the root fragment contains CB; its anchor bond is CA->CB
    root_frag = frag_of[cb]
    # BFS over fragments through cut bonds
    frag_children: Dict[int, List[Tuple[int, int, int]]] = \
        {i: [] for i in range(len(frags))}
    for (i, j) in cut:
        fi, fj = frag_of[i], frag_of[j]
        frag_children[fi].append((fj, i, j))
        frag_children[fj].append((fi, j, i))
    order = [root_frag]
    parent_frag = {root_frag: (-1, ca, cb)}
    qi = 0
    while qi < len(order):
        f = order[qi]
        qi += 1
        for (g, pa, caa) in frag_children[f]:
            if g not in parent_frag:
                parent_frag[g] = (f, pa, caa)
                order.append(g)

    # assemble local arrays, node-contiguous
    new_order: List[int] = []
    node_of: List[int] = []
    for node_idx, f in enumerate(order):
        atoms = list(frags[f])
        anchor = parent_frag[f][2]
        if anchor in atoms:
            atoms.remove(anchor)
            atoms.insert(0, anchor)
        for a in atoms:
            new_order.append(a)
            node_of.append(node_idx)
    remap = {g: l for l, g in enumerate(new_order)}

    coords = rec.coords[new_order]
    types = rec.types[new_order]
    charges = rec.charges[new_order]

    mf = len(order)
    parent = np.full(mf, -1, np.int32)
    rel_axis = np.zeros((mf, 3), np.float32)
    rel_origin = np.zeros((mf, 3), np.float32)
    layer = np.zeros(mf, np.int32)
    anchor_local = np.full(mf, -1, np.int32)
    node_origin = np.zeros((mf, 3), np.float32)

    frag_rank = {f: i for i, f in enumerate(order)}
    for node_idx, f in enumerate(order):
        pf, pa, caa = parent_frag[f]
        origin = rec.coords[caa]
        node_origin[node_idx] = origin
        axis = origin - rec.coords[pa]
        nrm = np.linalg.norm(axis)
        if nrm < 1e-6:
            return None
        if node_idx == 0:
            # first_segment: absolute frame, parent = identity
            parent[0] = -1
            layer[0] = 1
            rel_axis[0] = axis / nrm
            rel_origin[0] = origin
            anchor_local[0] = -1  # anchor is CA (inflex)
        else:
            p_node = frag_rank[pf]
            parent[node_idx] = p_node
            layer[node_idx] = layer[p_node] + 1
            rel_axis[node_idx] = axis / nrm
            rel_origin[node_idx] = origin - node_origin[p_node]
            anchor_local[node_idx] = remap[pa]

    local_coords = coords - node_origin[np.array(node_of)]

    # intra-residue pairs: movable x movable across nodes, and movable x
    # inflex — excluding <=3-bond neighbors and node-anchor relations
    f_n = len(new_order)
    within3: List[Set[int]] = []
    for gi in new_order + inflex:
        seen = {gi}
        frontier = [gi]
        for _ in range(3):
            nxt = []
            for u in frontier:
                for v, _b in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        within3.append(seen)
    glob_all = new_order + inflex
    hyd = IS_HYDROGEN[rec.types]
    pairs = []
    for li in range(len(glob_all)):
        gi = glob_all[li]
        if hyd[gi]:
            continue
        for lj in range(li + 1, len(glob_all)):
            gj = glob_all[lj]
            if hyd[gj]:
                continue
            if li >= f_n and lj >= f_n:
                continue  # inflex-inflex excluded
            ni = node_of[li] if li < f_n else -1
            nj = node_of[lj] if lj < f_n else -1
            if ni == nj and ni >= 0:
                continue
            # anchor relations: parent-side bond atom is distance-fixed
            if nj >= 0 and anchor_local[nj] == li:
                continue
            if ni >= 0 and anchor_local[ni] == lj:
                continue
            # CA (inflex 0) is on the axis of the root node
            if ni == 0 and lj == f_n:
                continue
            if nj == 0 and li == f_n:
                continue
            if gj in within3[li]:
                continue
            pairs.append((li, lj))

    return FlexResidue(
        key=key, resname=resname,
        coords=coords.astype(np.float32),
        types=types.astype(np.int32),
        charges=charges.astype(np.float32),
        node_of_atom=np.array(node_of, np.int32),
        parent=parent, rel_axis=rel_axis, rel_origin=rel_origin,
        layer=layer, parent_anchor_local=anchor_local,
        inflex_coords=rec.coords[inflex].astype(np.float32),
        inflex_types=rec.types[inflex].astype(np.int32),
        inflex_charges=rec.charges[inflex].astype(np.float32),
        pairs=np.array(pairs, np.int32).reshape(-1, 2),
        atoms_mol=_flex_atoms_mol(rec.mol, new_order + inflex, key, resname),
    )


def _flex_atoms_mol(mol: Molecule, idxs, key, resname) -> Molecule:
    """Atom metadata (names/residue ids) for --out_flex writing: movable
    atoms in node order, then inflex anchors."""
    import copy as _copy

    out = Molecule(name=f"{resname}_{key[0]}{key[1]}{key[2]}")
    out.atoms = [_copy.copy(mol.atoms[i]) for i in idxs]
    return out


def flex_from_pdbqt(text: str, rec: Optional[Receptor] = None
                    ) -> List[FlexResidue]:
    """Parse a user-supplied flex PDBQT (-flex) into FlexResidues.

    reference: parse_pdbqt.cpp parse_pdbqt_flex/parse_pdbqt_residue +
    postprocess_residue (parse_pdbqt.cpp:393-420): per BEGIN_RES block the
    ROOT atoms become static inflex anchors, and every BRANCH off a root
    atom becomes a first_segment rotating about (root atom -> branch
    anchor); nested BRANCHes become child segments.
    """
    from gnina_tpu_torch.chem.pdbqt import parse_pdbqt_ligand

    residues: List[FlexResidue] = []
    lines = text.splitlines()
    block: List[str] = []
    header = None
    for line in lines:
        if line.startswith("BEGIN_RES"):
            header = line.split()
            block = []
        elif line.startswith("END_RES"):
            if header is not None:
                fr = _flex_residue_from_block("\n".join(block), header)
                if fr is not None:
                    residues.append(fr)
            header = None
        elif header is not None:
            block.append(line)
    return residues


def _flex_residue_from_block(block: str, header: List[str]
                             ) -> Optional[FlexResidue]:
    from gnina_tpu_torch.chem.pdbqt import PdbqtBranch, parse_pdbqt_ligand

    resname = header[1] if len(header) > 1 else "UNK"
    chain = header[2] if len(header) > 2 else ""
    try:
        resnum = int(header[3]) if len(header) > 3 else 0
    except ValueError:
        resnum = 0
    key = (chain, resnum, "")

    lig = parse_pdbqt_ligand(block, name=resname)
    mol = lig.mol
    if not lig.branches or not lig.root_atoms:
        return None
    mol.perceive_all()
    types_all = mol.assign_smina_types()
    coords_all = mol.coords()
    charges_all = np.array([a.charge for a in mol.atoms], np.float32)

    # collect nodes: BFS over branches; each top-level branch off a root
    # atom is a first_segment
    nodes: List[Tuple[PdbqtBranch, int]] = []   # (branch, parent_node)

    def walk(br: PdbqtBranch, parent_node: int):
        nodes.append((br, parent_node))
        my_node = len(nodes) - 1
        for c in br.children:
            walk(c, my_node)

    for br in lig.branches:
        walk(br, -1)

    new_order: List[int] = []
    node_of: List[int] = []
    for ni, (br, _pn) in enumerate(nodes):
        atoms = list(br.atoms)
        if br.my_serial in atoms:
            atoms.remove(br.my_serial)
            atoms.insert(0, br.my_serial)
        for a in atoms:
            new_order.append(a)
            node_of.append(ni)
    remap = {g: l for l, g in enumerate(new_order)}

    mf = len(nodes)
    parent = np.full(mf, -1, np.int32)
    rel_axis = np.zeros((mf, 3), np.float32)
    rel_origin = np.zeros((mf, 3), np.float32)
    layer = np.zeros(mf, np.int32)
    anchor_local = np.full(mf, -1, np.int32)
    node_origin = np.zeros((mf, 3), np.float32)

    for ni, (br, pn) in enumerate(nodes):
        origin = coords_all[br.my_serial]
        node_origin[ni] = origin
        axis = origin - coords_all[br.parent_serial]
        nrm = np.linalg.norm(axis)
        if nrm < 1e-6:
            return None
        if pn < 0:
            parent[ni] = -1
            layer[ni] = 1
            rel_axis[ni] = axis / nrm
            rel_origin[ni] = origin
            anchor_local[ni] = -1
        else:
            parent[ni] = pn
            layer[ni] = layer[pn] + 1
            rel_axis[ni] = axis / nrm
            rel_origin[ni] = origin - node_origin[pn]
            anchor_local[ni] = remap.get(br.parent_serial, -1)

    inflex = list(lig.root_atoms)
    coords = coords_all[new_order]
    f_n = len(new_order)

    # pairs with the same exclusion rules as extract_flex_residue
    adj = mol.adjacency()
    glob_all = new_order + inflex
    within3: List[Set[int]] = []
    for gi in glob_all:
        seen = {gi}
        frontier = [gi]
        for _ in range(3):
            nxt = []
            for u in frontier:
                for v, _b in adj[u]:
                    if v not in seen:
                        seen.add(v)
                        nxt.append(v)
            frontier = nxt
        within3.append(seen)
    hyd = IS_HYDROGEN[types_all]
    pairs = []
    for li in range(len(glob_all)):
        gi = glob_all[li]
        if hyd[gi]:
            continue
        for lj in range(li + 1, len(glob_all)):
            gj = glob_all[lj]
            if hyd[gj]:
                continue
            if li >= f_n and lj >= f_n:
                continue
            ni = node_of[li] if li < f_n else -1
            nj = node_of[lj] if lj < f_n else -1
            if ni == nj and ni >= 0:
                continue
            if nj >= 0 and anchor_local[nj] == li:
                continue
            if ni >= 0 and anchor_local[ni] == lj:
                continue
            # root-segment anchor atom (in inflex) is on the axis
            if ni >= 0 and parent[ni] == -1 and lj >= f_n \
                    and glob_all[lj] == nodes[ni][0].parent_serial:
                continue
            if nj >= 0 and parent[nj] == -1 and li >= f_n \
                    and glob_all[li] == nodes[nj][0].parent_serial:
                continue
            if gj in within3[li]:
                continue
            pairs.append((li, lj))

    return FlexResidue(
        key=key, resname=resname,
        coords=coords.astype(np.float32),
        types=types_all[new_order].astype(np.int32),
        charges=charges_all[new_order].astype(np.float32),
        node_of_atom=np.array(node_of, np.int32),
        parent=parent, rel_axis=rel_axis, rel_origin=rel_origin,
        layer=layer, parent_anchor_local=anchor_local,
        inflex_coords=coords_all[inflex].astype(np.float32),
        inflex_types=types_all[inflex].astype(np.int32),
        inflex_charges=charges_all[inflex].astype(np.float32),
        pairs=np.array(pairs, np.int32).reshape(-1, 2),
        atoms_mol=_flex_atoms_mol(mol, new_order + inflex, key, resname),
    )


def strip_flex_from_receptor(rec: Receptor, flexres: Sequence[FlexResidue]
                             ) -> Receptor:
    """Remove the movable + inflex atoms of flex residues from the rigid
    receptor (they are re-modeled as flex; backbone N/O stay rigid)."""
    drop: Set[int] = set()
    keys = {fr.key for fr in flexres}
    for i, a in enumerate(rec.mol.atoms):
        if (a.chain, a.resnum, a.icode) in keys:
            if a.name not in BACKBONE_RIGID:
                drop.add(i)
    keep = [i for i in range(len(rec.types)) if i not in drop]
    sub = Molecule(name=rec.mol.name)
    sub.atoms = [rec.mol.atoms[i] for i in keep]
    return Receptor(mol=sub, coords=rec.coords[keep],
                    types=rec.types[keep], charges=rec.charges[keep])
