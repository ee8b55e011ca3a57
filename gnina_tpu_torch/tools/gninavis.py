"""CNN attribution by masking (gninavis equivalent).

reference: gninasrc/gninavis/cnn_visualization.cpp — per-atom and
per-fragment masking: remove atoms, re-score with the CNN, and report the
score drop as that atom's contribution.  Unlike the reference, all masked
variants are scored in ONE batched CNN forward instead of sequential
re-scoring.

Outputs a PDB whose B-factor column carries the per-atom scores (the
reference writes "colored" PDBs the same way).

Counterpart of the JAX package's gnina_tpu/tools/gninavis.py over the
port's models/scorer.CNNScorer, on the torch device that --device names
(default: the card; --device cpu asks for the CPU).
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

import numpy as np

from gnina_tpu_torch.chem import ingest
from gnina_tpu_torch.constants import IS_HYDROGEN


def atom_masking_scores(cnn, rec, lig, coords: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """Per-ligand-atom attribution: base_score - score(without atom).

    Hydrogens get the score of their heavy neighbor region (0 here).
    """
    if coords is None:
        coords = lig.orig_coords
    n = lig.num_atoms
    heavy_ids = [i for i in range(n) if not IS_HYDROGEN[lig.types[i]]]

    base, _aff, _var = cnn.score_pose(rec, lig, coords)

    # batched masked variants: move the masked atom far outside the grid
    # (equivalent to removing it from the coordinate set)
    batch = np.tile(coords[None], (len(heavy_ids), 1, 1))
    for row, i in enumerate(heavy_ids):
        batch[row, i] = coords[i] + 1e4
    scores, _affs, _loss, _vars = cnn.score_poses(rec, lig, batch)

    out = np.zeros(n, np.float32)
    for row, i in enumerate(heavy_ids):
        out[i] = base - float(scores[row])
    return out


def fragment_masking_scores(cnn, rec, lig, fragments: List[List[int]],
                            coords: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-fragment attribution: score drop when a whole fragment is
    removed; returned per atom (each atom gets its fragment's score)."""
    if coords is None:
        coords = lig.orig_coords
    base, _aff, _var = cnn.score_pose(rec, lig, coords)
    batch = np.tile(coords[None], (len(fragments), 1, 1))
    for row, frag in enumerate(fragments):
        for i in frag:
            batch[row, i] = coords[i] + 1e4
    scores, _affs, _loss, _vars = cnn.score_poses(rec, lig, batch)
    out = np.zeros(lig.num_atoms, np.float32)
    for row, frag in enumerate(fragments):
        for i in frag:
            out[i] = base - float(scores[row])
    return out


def node_fragments(lig) -> List[List[int]]:
    """Rigid-fragment partition from the kinematic tree nodes."""
    frags = {}
    for i in range(lig.num_atoms):
        frags.setdefault(int(lig.node_id[i]), []).append(i)
    return list(frags.values())


def bond_subgraph_fragments(lig, max_bonds: int = 6) -> List[List[int]]:
    """Chemically meaningful fragments: every connected bond-subgraph of
    the heavy-atom graph with 1..max_bonds bonds, plus hydrogens adjacent
    to its atoms (reference cnn_visualization.cpp:789-870:
    findAllSubgraphsOfLengthsMtoN(mol, 1, 6) + add_adjacent_hydrogens)."""
    hyd = IS_HYDROGEN[lig.types]
    bonds = [(b.a, b.b) for b in lig.mol.bonds
             if not hyd[b.a] and not hyd[b.b]]
    nb = len(bonds)
    # bond adjacency (bonds sharing an atom)
    adj: List[List[int]] = [[] for _ in range(nb)]
    for i in range(nb):
        for j in range(i + 1, nb):
            if set(bonds[i]) & set(bonds[j]):
                adj[i].append(j)
                adj[j].append(i)

    subgraphs = set()

    def grow(current: frozenset, frontier):
        if len(current) >= max_bonds:
            return
        for e in frontier:
            nxt = current | {e}
            if nxt not in subgraphs:
                subgraphs.add(nxt)
                new_frontier = [x for x in set(frontier) | set(adj[e])
                                if x not in nxt]
                grow(nxt, new_frontier)

    for b in range(nb):
        s = frozenset([b])
        if s not in subgraphs:
            subgraphs.add(s)
            grow(s, [x for x in adj[b] if x != b])

    # adjacency for hydrogen attachment
    h_of = {}
    for b in lig.mol.bonds:
        if hyd[b.a] and not hyd[b.b]:
            h_of.setdefault(b.b, []).append(b.a)
        elif hyd[b.b] and not hyd[b.a]:
            h_of.setdefault(b.a, []).append(b.b)

    frags = []
    for sg in sorted(subgraphs, key=lambda s: (len(s), sorted(s))):
        atoms = set()
        for e in sg:
            atoms.update(bonds[e])
        for a in list(atoms):
            atoms.update(h_of.get(a, []))
        frags.append(sorted(atoms))
    return frags


def averaged_fragment_scores(cnn, rec, lig, fragments: List[List[int]],
                             coords: Optional[np.ndarray] = None,
                             chunk: int = 128) -> np.ndarray:
    """Per-atom attribution averaged over every fragment containing the
    atom (reference remove_fragments score_diffs/score_counts), scored in
    batched CNN forwards of `chunk` masked variants at a time."""
    if coords is None:
        coords = lig.orig_coords
    base, _aff, _var = cnn.score_pose(rec, lig, coords)
    diffs = np.zeros(lig.num_atoms, np.float64)
    counts = np.zeros(lig.num_atoms, np.float64)
    for lo in range(0, len(fragments), chunk):
        part = fragments[lo:lo + chunk]
        batch = np.tile(coords[None], (len(part), 1, 1))
        for row, frag in enumerate(part):
            for i in frag:
                batch[row, i] = coords[i] + 1e4
        scores, _a, _l, _v = cnn.score_poses(rec, lig, batch)
        for row, frag in enumerate(part):
            d = base - float(scores[row])
            for i in frag:
                diffs[i] += d
                counts[i] += 1
    return (diffs / np.maximum(counts, 1)).astype(np.float32)


def write_colored_pdb(lig, scores: np.ndarray, path: str):
    from gnina_tpu_torch.chem import elements as el

    with open(path, "w") as f:
        for i in range(lig.num_atoms):
            a = lig.mol.atoms[i]
            sym = el.ANUM_TO_SYMBOL.get(a.anum, "C")
            x, y, z = lig.orig_coords[i]
            f.write(f"HETATM{i + 1:5d} {sym:<4s}LIG A   1    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{scores[i]:6.2f}"
                    f"          {sym:>2s}\n")
        f.write("END\n")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gninavis")
    p.add_argument("-r", "--receptor", required=True)
    p.add_argument("-l", "--ligand", required=True)
    p.add_argument("--cnn", action="append", default=[])
    p.add_argument("--atoms_only", action="store_true")
    p.add_argument("--frags_only", action="store_true")
    p.add_argument("--frag_bonds", type=int, default=6,
                   help="max bonds per fragment subgraph (reference "
                        "remove_fragments(6)); 0 = rigid tree nodes")
    p.add_argument("-o", "--out", default="gninavis")
    p.add_argument("--device", default=None,
                   help="torch device of the CNN (default: the card; 'cpu' "
                        "for the CPU)")
    args = p.parse_args(argv)

    from gnina_tpu_torch.device import device_from_flag
    from gnina_tpu_torch.models.scorer import CNNScorer

    dev = device_from_flag(args.device)
    rec = ingest.Receptor.from_file(args.receptor)
    cnn = CNNScorer(model_names=args.cnn or None, device=dev)
    for idx, lig in enumerate(ingest.iter_ligands(args.ligand)):
        if not args.frags_only:
            s = atom_masking_scores(cnn, rec, lig)
            write_colored_pdb(lig, s, f"{args.out}_{idx}_atoms.pdb")
        if not args.atoms_only:
            if args.frag_bonds > 0:
                frags = bond_subgraph_fragments(lig, args.frag_bonds)
                s = averaged_fragment_scores(cnn, rec, lig, frags)
            else:
                s = fragment_masking_scores(cnn, rec, lig,
                                            node_fragments(lig))
            write_colored_pdb(lig, s, f"{args.out}_{idx}_frags.pdb")
    return 0


if __name__ == "__main__":
    sys.exit(main())
