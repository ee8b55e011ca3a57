"""The comparison that decides `correct`: every pose the window wrote,
judged against the reference on the inputs the harness made.

For each ligand of each call, the output must hold 1 to `num_modes` poses
of that ligand, in input order, sorted by the configuration's order, no two
within `min_rmsd` of each other (heavy atoms), and its atoms must be the
input's (`structure_faults` counts each breach; an exact check, limit 0).
For each pose:

- `pose_gap` (A): the largest change of a bond length or a bond angle's
  1-3 distance from the input ligand's, and of a heavy atom's distance
  outside the box: docking moves only the rigid pose and the torsions (the
  forward kinematics of K2, K3 and the writer);
- `affinity_gap` (kcal/mol): |written minimizedAffinity - the Vina
  affinity recomputed on the written coordinates| (K1's exact rescore, the
  finish stages, the scoring terms);
- `cnnscore_gap`, `cnnaffinity_gap`, where the configuration rescores:
  |written CNNscore / CNNaffinity - the ensemble's, recomputed on the
  written coordinates| (the voxelizer, the forward and the averaging).

The control (the reference in the program's place, one precision lower)
reads the same numbers from its own values: coordinates held in bfloat16,
the affinity computed in bfloat16, the CNN with TF32 on.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from dockbench.reference import chem, cnn, vina

NUMBERS = ("pose_gap", "affinity_gap", "cnnscore_gap", "cnnaffinity_gap",
           "structure_faults")


@dataclasses.dataclass
class Given:
    """One input ligand as the reference sees it."""
    mol: chem.Mol
    types: np.ndarray
    num_tors: int
    classes: List[str]
    geometry: Dict[tuple, np.ndarray]


def _geometry(mol: chem.Mol, classes: List[str]) -> Dict[tuple, np.ndarray]:
    """Sorted bond lengths and 1-3 distances, keyed by the atoms' classes."""
    out: Dict[tuple, list] = {}
    x = mol.coords
    for a, b, _ in mol.bonds:
        key = ("b",) + tuple(sorted((classes[a], classes[b])))
        out.setdefault(key, []).append(np.linalg.norm(x[a] - x[b]))
    for c in range(len(mol.elems)):
        nb = [j for j, _ in mol.adj[c]]
        for i in range(len(nb)):
            for j in range(i + 1, len(nb)):
                a, b = nb[i], nb[j]
                key = ("a", classes[c]) + tuple(sorted((classes[a],
                                                        classes[b])))
                out.setdefault(key, []).append(np.linalg.norm(x[a] - x[b]))
    return {k: np.sort(np.array(v)) for k, v in out.items()}


def given(mol: chem.Mol) -> Given:
    classes = chem.atom_classes(chem.Mol(mol.name, mol.elems, mol.coords,
                                         [(a, b, 1) for a, b, _ in
                                          mol.bonds]))
    return Given(mol, chem.smina_types(mol), len(chem.rotatable_bonds(mol)),
                 classes, _geometry(mol, classes))


class Receptor:
    def __init__(self, pdb_text: str):
        mol = chem.parse_pdb(pdb_text)
        self.xyz = mol.coords
        self.types = chem.smina_types(mol)


def _pose_gap(g: Given, written: chem.Mol, xyz: np.ndarray, lo, hi) -> float:
    m = chem.Mol(written.name, written.elems, xyz, written.bonds)
    classes = [g.classes[i] for i in written.match]
    geo = _geometry(m, classes)
    gap = 0.0
    for k, v in g.geometry.items():
        w = geo.get(k)
        if w is None or len(w) != len(v):
            return float("inf")
        gap = max(gap, float(np.abs(w - v).max()))
    heavy = m.heavy
    out = np.maximum(xyz[heavy] - hi, 0) + np.maximum(lo - xyz[heavy], 0)
    return max(gap, float(out.max()) if out.size else 0.0)


def judge(calls, rec: Receptor, box, settings: dict, models=None,
          device="cpu", control: bool = False) -> dict:
    """Readings of the numbers over every written pose of `calls`, a list of
    (inputs: list of Given in input order, written SDF text).  control:
    read the control's values in the program's place."""
    lo = np.asarray(box[0]) - np.asarray(box[1]) / 2
    hi = np.asarray(box[0]) + np.asarray(box[1]) / 2
    r = {k: 0.0 for k in NUMBERS}
    r["structure_faults"] = 0
    if models is None:
        r.pop("cnnscore_gap")
        r.pop("cnnaffinity_gap")
    faults = []
    poses = 0
    for inputs, text in calls:
        written = chem.parse_sdf(text)
        by_name: Dict[str, List[chem.Mol]] = {}
        names_in_order = []
        for w in written:
            if w.name not in by_name:
                names_in_order.append(w.name)
            by_name.setdefault(w.name, []).append(w)
        if names_in_order != [g.mol.name for g in inputs
                              if g.mol.name in by_name]:
            faults.append("output order")
        for g in inputs:
            ws = by_name.get(g.mol.name, [])
            if not 1 <= len(ws) <= settings["num_modes"]:
                faults.append(f"{g.mol.name}: {len(ws)} poses")
                if not ws:
                    continue
            ok = True
            for w in ws:
                w.match = chem.match_to_input(w, g.mol)
                if w.match is None:
                    faults.append(f"{g.mol.name}: atoms differ from the input")
                    ok = False
            if not ok:
                continue
            xyz = np.stack([w.coords for w in ws])
            poses += len(ws)
            types = g.types[ws[0].match]
            key = settings["sort_key"]
            vals = np.array([float(w.props[key]) for w in ws])
            step = np.diff(vals) * (1 if settings["sort_ascending"] else -1)
            if np.any(step < 0):
                faults.append(f"{g.mol.name}: poses out of {key} order")
            heavy = ws[0].heavy
            for i in range(len(ws)):
                for j in range(i):
                    d = xyz[i, heavy] - xyz[j, heavy]
                    if np.sqrt((d * d).sum(-1).mean()) \
                            <= settings["min_rmsd"] - 1e-3:
                        faults.append(f"{g.mol.name}: poses {j} and {i} "
                                      "within min_rmsd")
            if control:
                xyz_c = torch.as_tensor(xyz).to(torch.bfloat16).double().numpy()
            else:
                xyz_c = xyz
            for w, x in zip(ws, xyz_c):
                r["pose_gap"] = max(r["pose_gap"],
                                    _pose_gap(g, w, x, lo, hi))
            near = vina.near_receptor(rec.xyz, np.clip(xyz, lo, hi))
            ref = vina.affinity(xyz, types, g.num_tors, rec.xyz[near],
                                rec.types[near], lo, hi)
            if control:
                got = vina.affinity(xyz, types, g.num_tors, rec.xyz[near],
                                    rec.types[near], lo, hi,
                                    dtype=torch.bfloat16)
            else:
                got = np.array([float(w.props["minimizedAffinity"])
                                for w in ws])
            r["affinity_gap"] = max(r["affinity_gap"],
                                    float(np.abs(got - ref).max()))
            if models is not None:
                tf32 = torch.backends.cudnn.allow_tf32, \
                    torch.backends.cuda.matmul.allow_tf32
                torch.backends.cudnn.allow_tf32 = False
                torch.backends.cuda.matmul.allow_tf32 = False
                try:
                    s_ref, a_ref = cnn.score(models, rec.xyz, rec.types, xyz,
                                             types, device)
                    if control:
                        torch.backends.cudnn.allow_tf32 = True
                        torch.backends.cuda.matmul.allow_tf32 = True
                        s_got, a_got = cnn.score(models, rec.xyz, rec.types,
                                                 xyz, types, device)
                    else:
                        s_got = np.array([float(w.props["CNNscore"])
                                          for w in ws])
                        a_got = np.array([float(w.props["CNNaffinity"])
                                          for w in ws])
                finally:
                    (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32) = tf32
                r["cnnscore_gap"] = max(r["cnnscore_gap"],
                                        float(np.abs(s_got - s_ref).max()))
                r["cnnaffinity_gap"] = max(r["cnnaffinity_gap"],
                                           float(np.abs(a_got - a_ref).max()))
    r["structure_faults"] = len(faults)
    return dict(readings=r, faults=faults[:20], poses=poses)


def verdict(readings: dict, limits: dict):
    """(correct, [[name, reading, limit], ...]) with every number of
    `readings` held to its limit."""
    rows = [[k, readings[k], limits[k]] for k in NUMBERS if k in readings]
    return all(v <= lim for _, v, lim in rows), rows
