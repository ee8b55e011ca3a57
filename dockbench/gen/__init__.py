"""The one generator of the benchmark's traffic: a receptor, a box and a
stream of ligand files, made from a traffic file's parameters and a seed.

The library of each size class is drawn once from the traffic's
`library_seed`: `rounds_in_pool` slices of `ligands_per_call` ligands,
each drawn in the class's ranges of atoms and torsions, and one slice more
for the warm-up.  A run's k-th call docks the slice of its round (k over
the number of classes), so no molecule comes twice in a run's first
`rounds_in_pool` rounds, and the warm-up's molecules never come in the
window.  A slice is the same molecules, in the same order, for every seed:
every seed gets the same work and the same chemistry.  A run's seed draws,
for each call, each ligand's input pose (a random rotation, centred
`input_offset` A from the box's centre in a random direction, so outside
the box) and the search's seed.  The pools are cached in `cache_dir`,
keyed by the parameters and this package's sources, because drawing them
takes about two minutes.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import List, Tuple

import numpy as np

from dockbench.gen import library, receptor

_HERE = os.path.dirname(os.path.abspath(__file__))


def _pool_key(traffic: dict) -> str:
    h = hashlib.sha1(json.dumps(
        {k: traffic[k] for k in ("classes", "library_seed", "min_nonbonded",
                                 "max_span", "ligands_per_call",
                                 "rounds_in_pool")},
        sort_keys=True).encode())
    for name in ("library.py", "__init__.py"):
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _draw(traffic: dict, cls: str, part: int) -> List[library.Ligand]:
    """One slice of the class: part 0 is the warm-up's, part s + 1 the
    s-th round's.  Every ligand has a random stream of its own."""
    p = traffic["classes"][cls]
    ci = sorted(traffic["classes"]).index(cls)
    tag = "w" if part == 0 else str(part - 1)
    return [library.make_ligand(
        np.random.default_rng([traffic["library_seed"], ci, part, i]), p,
        traffic["min_nonbonded"], traffic["max_span"], p["atoms"],
        p["torsions"], f"{cls}{tag}_{i:02d}")
        for i in range(traffic["ligands_per_call"])]


def draw_pool(traffic: dict, cls: str) -> List[List[library.Ligand]]:
    """The class's warm-up slice, then one slice per round."""
    return [_draw(traffic, cls, part)
            for part in range(traffic["rounds_in_pool"] + 1)]


def _to_json(lig: library.Ligand) -> dict:
    return dict(name=lig.name, elems=lig.elems, bonds=lig.bonds,
                ring=lig.ring, coords=np.round(lig.coords, 6).tolist())


def _from_json(d: dict) -> library.Ligand:
    lig = library.Ligand(name=d["name"], elems=[], bonds=[], ring=[])
    for e, r in zip(d["elems"], d["ring"]):
        lig.elems.append(e)
        lig.ring.append(r)
        lig.adj.append([])
        lig.hdeg.append(0)
    for a, b, o in d["bonds"]:
        lig.bond(a, b, o)
    lig.coords = np.array(d["coords"], np.float64)
    return lig


class Screen:
    """The traffic of one traffic file: its receptor, box and calls."""

    def __init__(self, traffic: dict, cache_dir: str):
        self.t = traffic
        self.pools = {}
        key = _pool_key(traffic)
        path = os.path.join(cache_dir, f"pools_{key}.json")
        if os.path.exists(path):
            with open(path) as f:
                raw = json.load(f)
            self.pools = {c: [[_from_json(d) for d in sl] for sl in v]
                          for c, v in raw.items()}
        else:
            self.pools = {c: draw_pool(traffic, c) for c in traffic["classes"]}
            os.makedirs(cache_dir, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump({c: [[_to_json(l) for l in sl] for sl in v]
                           for c, v in self.pools.items()}, f)
            os.replace(tmp, path)

    @property
    def center(self) -> np.ndarray:
        return np.asarray(self.t["receptor"]["center"], np.float64)

    @property
    def cavity(self) -> float:
        """The cavity's radius: the widest ligand's span halved, plus the
        margin."""
        return self.t["max_span"] / 2 + self.t["receptor"]["cavity_margin"]

    def receptor(self) -> Tuple[np.ndarray, np.ndarray]:
        r = self.t["receptor"]
        return receptor.lattice(self.center, r["seed"], r["cube"],
                                r["spacing"], self.cavity, r["jitter"])

    def receptor_pdb(self) -> str:
        return receptor.pdb_text(*self.receptor())

    def box(self) -> Tuple[np.ndarray, np.ndarray]:
        return self.center, np.full(3, float(self.t["box_size"]))

    def call_class(self, k: int) -> str:
        classes = self.t["call_classes"]
        return classes[k % len(classes)]

    def call_round(self, k: int) -> int:
        return k // len(self.t["call_classes"])

    def call(self, seed: int, k: int):
        """The k-th call of a run: (class, ligands with their input
        coordinates, the search's seed)."""
        cls = self.call_class(k)
        pool = self.pools[cls]
        ligs = pool[1 + self.call_round(k) % (len(pool) - 1)]
        rng = np.random.default_rng([int(seed) % (1 << 63), k])
        out = []
        for lig in ligs:
            rot = library.random_rotation(rng)
            d = rng.normal(size=3)
            at = self.center + self.t["input_offset"] * d / np.linalg.norm(d)
            out.append((lig, lig.coords @ rot.T + at))
        return cls, out, int(rng.integers(0, 1 << 31))

    def warmup(self, cls: str):
        """The class's warm-up slice at its pool coordinates, outside the
        box."""
        at = self.center + [self.t["input_offset"], 0.0, 0.0]
        return [(lig, lig.coords + at) for lig in self.pools[cls][0]]


def sdf_text(ligands) -> str:
    return "".join(library.sdf_block(lig, x) for lig, x in ligands)
