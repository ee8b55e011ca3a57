"""Seeded drug-like ligands for the screen traffic, written as V2000 SDF.

A ligand is a tree of chains and at most two benzene rings, of C, N, O, S,
F and Cl, with the polar hydrogens a prepared library carries (on N and O)
and no hydrogens on carbon.  Its graph is grown at random from a class's
parameters to a drawn atom count (heavy atoms plus polar hydrogens, as the
port counts them) and a drawn number of rotatable bonds, and kept when both
fall in the class's ranges.  Coordinates come from internal coordinates:
standard bond lengths, tetrahedral or trigonal angles, flat rings, and
seeded torsions that are drawn again while a pair of heavy atoms three or
more bonds apart lies under `min_nonbonded` (1.7 A for a pair with a
hydrogen) or the heavy atoms span more than `max_span`.

A rotatable bond here is the port's and gnina's: a single bond outside a
ring and outside an amide, between two atoms that each have at least two
heavy neighbours.  The number of tree nodes is the rotatable bonds plus one.

Nothing here imports the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

VALENCE = {"C": 4, "N": 3, "O": 2, "S": 2, "F": 1, "Cl": 1, "H": 1}
RING_BOND = 1.39
MAX_RING_SUBSTITUENTS = 3


@dataclasses.dataclass
class Ligand:
    name: str
    elems: List[str]
    bonds: List[Tuple[int, int, int]]        # (a, b, order)
    ring: List[int]                          # ring index, -1 outside rings
    coords: np.ndarray = None                # (N, 3)
    adj: List[List[Tuple[int, int]]] = dataclasses.field(default_factory=list)
    hdeg: List[int] = dataclasses.field(default_factory=list)

    @property
    def num_atoms(self) -> int:
        return len(self.elems)

    def neighbours(self, i: int) -> List[Tuple[int, int]]:
        return self.adj[i]

    def bond(self, a: int, b: int, order: int) -> None:
        self.bonds.append((a, b, order))
        self.adj[a].append((b, order))
        self.adj[b].append((a, order))
        self.hdeg[a] += self.elems[b] != "H"
        self.hdeg[b] += self.elems[a] != "H"

    def heavy_degree(self, i: int) -> int:
        return self.hdeg[i]


def _in_ring(lig: Ligand, a: int, b: int) -> bool:
    return lig.ring[a] >= 0 and lig.ring[a] == lig.ring[b]


def _carbonyl(lig: Ligand, c: int) -> bool:
    return lig.elems[c] == "C" and any(
        lig.elems[j] == "O" and o == 2 for j, o in lig.neighbours(c))


def rotatable_bonds(lig: Ligand) -> List[Tuple[int, int]]:
    out = []
    for a, b, o in lig.bonds:
        if o != 1 or _in_ring(lig, a, b):
            continue
        if "H" in (lig.elems[a], lig.elems[b]):
            continue
        if {lig.elems[a], lig.elems[b]} == {"C", "N"}:
            c = a if lig.elems[a] == "C" else b
            if _carbonyl(lig, c):
                continue                      # amide
        if lig.heavy_degree(a) >= 2 and lig.heavy_degree(b) >= 2:
            out.append((a, b))
    return out


# --- the graph ---------------------------------------------------------------

def _free(lig: Ligand, i: int) -> int:
    if lig.ring[i] >= 0:                      # ring carbon: one H or a group
        return 3 - lig.heavy_degree(i)
    return VALENCE[lig.elems[i]] - sum(o for _, o in lig.neighbours(i))


def _add(lig: Ligand, host: int, elem: str, order: int = 1) -> int:
    lig.elems.append(elem)
    lig.ring.append(-1)
    lig.adj.append([])
    lig.hdeg.append(0)
    k = len(lig.elems) - 1
    if host >= 0:
        lig.bond(host, k, order)
    return k


def _add_ring(lig: Ligand, host: int) -> None:
    rid = max(lig.ring, default=-1) + 1
    first = len(lig.elems)
    for k in range(6):
        lig.elems.append("C")
        lig.ring.append(rid)
        lig.adj.append([])
        lig.hdeg.append(0)
    for k in range(6):
        lig.bond(first + k, first + (k + 1) % 6, 2 if k % 2 == 0 else 1)
    if host >= 0:
        lig.bond(host, first, 1)


def _undo_to(lig: Ligand, n_atoms: int, n_bonds: int) -> None:
    for a, b, _ in lig.bonds[n_bonds:]:
        for i, j in ((a, b), (b, a)):
            if i < n_atoms:
                lig.adj[i].pop()
                lig.hdeg[i] -= lig.elems[j] != "H"
    del lig.elems[n_atoms:], lig.ring[n_atoms:], lig.bonds[n_bonds:]
    del lig.adj[n_atoms:], lig.hdeg[n_atoms:]


def _ring_substituents(lig: Ligand, rid: int) -> int:
    return sum(1 for a, b, _ in lig.bonds
               if (lig.ring[a] == rid) != (lig.ring[b] == rid))


def _pending_h(lig: Ligand) -> int:
    return sum(_free(lig, i) for i in range(len(lig.elems))
               if lig.elems[i] in ("N", "O"))


def _hosts(lig: Ligand, kind: str) -> List[int]:
    hosts = [i for i in range(len(lig.elems)) if _free(lig, i) >= 1
             and (lig.ring[i] < 0 or _ring_substituents(lig, lig.ring[i])
                  < MAX_RING_SUBSTITUENTS)]
    if kind == "C=O":
        # a carbonyl on a chain carbon with room for the double bond
        return [i for i in hosts if lig.elems[i] == "C" and lig.ring[i] < 0
                and _free(lig, i) >= 2 and not _carbonyl(lig, i)
                and all(lig.elems[j] in ("C", "N", "O")
                        for j, _ in lig.neighbours(i))]
    if kind == "ring":
        return [i for i in hosts if lig.ring[i] < 0
                and lig.elems[i] in ("C", "N", "O")]
    if kind in ("O", "N", "S", "F", "Cl"):
        # heteroatoms and halogens bond to carbon only; a carbonyl carbon
        # takes only O or N (acid, ester, amide)
        return [i for i in hosts if lig.elems[i] == "C"
                and (kind in ("O", "N") or not _carbonyl(lig, i))]
    return hosts


def _grow(rng, params: dict, atoms: int, torsions: int) -> Ligand:
    """One random graph of about `atoms` atoms (heavy atoms and the polar
    hydrogens they will carry) with at most `torsions` rotatable bonds and
    a ring count drawn from params["rings"], then its polar hydrogens.  A
    group is added only where it keeps the rotatable bonds within
    `torsions`, so once they are spent the graph grows by leaves on inner
    atoms."""
    lig = Ligand(name="", elems=[], bonds=[], ring=[])
    rings = int(rng.choice(len(params["rings"]), p=params["rings"]))
    if rings:
        _add_ring(lig, -1)
    else:
        _add(lig, -1, "C")
    names = list(params["groups"]) + ["ring"]
    tries = 0
    while len(lig.elems) + _pending_h(lig) < atoms and tries < 400:
        tries += 1
        more_rings = rings - (max(lig.ring) + 1)
        probs = np.array([params["groups"][n] for n in names[:-1]]
                         + [params["ring_weight"] if more_rings > 0 else 0.0])
        kind = names[rng.choice(len(names), p=probs / probs.sum())]
        for h in rng.permutation(_hosts(lig, kind))[:4]:
            na, nb = len(lig.elems), len(lig.bonds)
            if kind == "ring":
                _add_ring(lig, int(h))
            elif kind == "C=O":
                _add(lig, int(h), "O", 2)
            else:
                _add(lig, int(h), kind)
            if (len(rotatable_bonds(lig)) <= torsions
                    and len(lig.elems) + _pending_h(lig) <= atoms):
                break
            _undo_to(lig, na, nb)
    for i in range(len(lig.elems)):
        if lig.elems[i] in ("N", "O"):
            for _ in range(_free(lig, i)):
                _add(lig, i, "H")
    return lig


# --- coordinates ---------------------------------------------------------------

def _trigonal(lig: Ligand, i: int) -> bool:
    if lig.ring[i] >= 0:
        return True
    e = lig.elems[i]
    if e in ("C", "O") and any(o == 2 for _, o in lig.neighbours(i)):
        return True
    # amide nitrogen
    return e == "N" and any(_carbonyl(lig, j) for j, _ in lig.neighbours(i))


def bond_length(lig: Ligand, a: int, b: int, order: int) -> float:
    ea, eb = sorted((lig.elems[a], lig.elems[b]))
    if _in_ring(lig, a, b):
        return RING_BOND
    if "H" in (ea, eb):
        return 1.01 if "N" in (ea, eb) else 0.96
    if (ea, eb) == ("C", "O"):
        c = a if lig.elems[a] == "C" else b
        if order == 2:
            return 1.23
        return 1.36 if _trigonal(lig, c) else 1.43
    if (ea, eb) == ("C", "N"):
        c = a if lig.elems[a] == "C" else b
        return 1.34 if _carbonyl(lig, c) else (
            1.40 if lig.ring[c] >= 0 else 1.47)
    if (ea, eb) == ("C", "S"):
        return 1.81
    if (ea, eb) == ("C", "F"):
        return 1.35
    if (ea, eb) == ("C", "Cl"):
        return 1.76
    return 1.51 if _trigonal(lig, a) or _trigonal(lig, b) else 1.53


def _place(a, b, c, bond, angle, torsion):
    """The point d with |cd| = bond, angle bcd and torsion abcd (radians)."""
    bc = c - b
    bc = bc / np.linalg.norm(bc)
    n = np.cross(b - a, bc)
    nn = np.linalg.norm(n)
    if nn < 1e-6:
        n = np.cross(bc, [1.0, 0.0, 0.0] if abs(bc[0]) < 0.9
                     else [0.0, 1.0, 0.0])
        nn = np.linalg.norm(n)
    n = n / nn
    m = np.cross(n, bc)
    return c + (-bond * math.cos(angle) * bc
                + bond * math.sin(angle) * math.cos(torsion) * m
                + bond * math.sin(angle) * math.sin(torsion) * n)


def _ring_walk(lig: Ligand, start: int) -> List[int]:
    """The ring of `start` in bond order, from `start`."""
    rid = lig.ring[start]
    out = [start]
    while len(out) < 6:
        nxt = [j for j, _ in lig.neighbours(out[-1]) if lig.ring[j] == rid
               and j not in out]
        out.append(nxt[0])
    return out


def _lay_ring(lig: Ligand, x, start: int, axis_from, turn: float) -> List[int]:
    """Place the flat ring of `start` (already placed): its centre on the
    line from `axis_from` through `start`, its plane turned by `turn`."""
    walk = _ring_walk(lig, start)
    u = x[start] - axis_from
    u = u / np.linalg.norm(u)
    centre = x[start] + RING_BOND * u
    w = np.cross(u, [0.0, 0.0, 1.0] if abs(u[2]) < 0.9 else [1.0, 0.0, 0.0])
    w = w / np.linalg.norm(w)
    v = math.cos(turn) * w + math.sin(turn) * np.cross(u, w)
    for k, i in enumerate(walk):
        t = math.pi / 3 * k
        x[i] = centre - RING_BOND * (math.cos(t) * u + math.sin(t) * v)
    return walk


def _clashes(lig: Ligand, x, new: List[int], placed: List[int], far,
             heavy, min_nonbonded: float) -> bool:
    """True when an atom of `new` lies too close to a placed atom or another
    new one three or more bonds away."""
    old = np.array(placed + new)
    nw = np.array(new)
    d = np.sqrt(((x[nw][:, None] - x[old][None]) ** 2).sum(-1))
    both = heavy[nw][:, None] & heavy[old][None, :]
    lim = np.where(both, min_nonbonded, 1.7)
    return bool(np.any(far[nw][:, old] & (d < lim)))


def _embed(lig: Ligand, rng, far, min_nonbonded: float,
           tries: int = 24) -> np.ndarray:
    """Coordinates built atom by atom from a root: each rotatable torsion,
    and the turn of each ring about its bond, is drawn up to `tries` times
    until the atoms it places clash with none placed before."""
    n = lig.num_atoms
    heavy = np.array([e != "H" for e in lig.elems])
    x = np.full((n, 3), np.nan)
    rot = {tuple(sorted(p)) for p in rotatable_bonds(lig)}
    parent = [-1] * n
    x[0] = 0.0
    if lig.ring[0] >= 0:
        queue = _lay_ring(lig, x, 0, np.array([-1.0, 0.0, 0.0]), 0.0)
    else:
        queue = [0]
    placed = list(queue)
    seen = set(queue)
    while queue:
        a = queue.pop(0)
        kids = [(j, o) for j, o in lig.neighbours(a) if j not in seen]
        if not kids:
            continue
        free_turn = any(lig.ring[j] >= 0 for j, _ in kids)
        if lig.ring[a] >= 0:
            # a ring atom's substituent points away from the ring's centre
            ring_nb = [j for j, _ in lig.neighbours(a)
                       if lig.ring[j] == lig.ring[a]]
            out = 2 * x[a] - x[ring_nb[0]] - x[ring_nb[1]]
            fixed = [out / np.linalg.norm(out)]
            p = ref = None
            free_phi = False
        else:
            p = parent[a]
            if p < 0:
                # the root chain atom: its first neighbour along x, the rest
                # as if that neighbour were its parent
                p, ref = kids[0][0], x[a] + [0.0, 1.0, 0.0]
                fixed = [np.array([1.0, 0.0, 0.0])]
                x[p] = x[a] + fixed[0]
            else:
                refs = [j for j, _ in lig.neighbours(p) if j != a
                        and j in seen]
                ref = x[refs[0]] if refs else x[p] + [0.0, 0.0, 1.0]
                fixed = []
            free_phi = tuple(sorted((a, p))) in rot
        trig = _trigonal(lig, a)
        angle = math.radians(120.0 if trig else 109.47)
        step = math.pi if trig else 2 * math.pi / 3
        for _ in range(tries if free_phi or free_turn else 1):
            phi = float(rng.uniform(0, 2 * math.pi)) if free_phi else math.pi
            dirs = list(fixed)
            for k in range(len(kids) - len(dirs)):
                dirs.append(_place(ref, x[p], x[a], 1.0, angle,
                                   phi + k * step) - x[a])
            new = []
            for (j, o), d in zip(kids, dirs):
                x[j] = x[a] + d * bond_length(lig, a, j, o)
                new.append(j)
                if lig.ring[j] >= 0:
                    new += _lay_ring(lig, x, j, x[a], float(
                        rng.uniform(0, 2 * math.pi)))[1:]
            if not _clashes(lig, x, new, placed, far, heavy, min_nonbonded):
                break
        for i in new:
            parent[i] = a if i in [j for j, _ in kids] else \
                next(j for j, _ in kids if lig.ring[j] == lig.ring[i])
            seen.add(i)
            placed.append(i)
            queue.append(i)
    return x


def _topo_far(lig: Ligand) -> np.ndarray:
    """(N, N) True for pairs three or more bonds apart."""
    n = lig.num_atoms
    adj = [[j for j, _ in lig.neighbours(i)] for i in range(n)]
    far = np.ones((n, n), bool)
    for i in range(n):
        far[i, i] = False
        for j in adj[i]:
            far[i, j] = False
            for k in adj[j]:
                far[i, k] = False
    return far


def conformer_ok(lig: Ligand, x: np.ndarray, min_nonbonded: float,
                 max_span: float, far: Optional[np.ndarray] = None) -> bool:
    if far is None:
        far = _topo_far(lig)
    heavy = np.array([e != "H" for e in lig.elems])
    d = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    hh = heavy[:, None] & heavy[None, :]
    if np.any(far & hh & (d < min_nonbonded)):
        return False
    if np.any(far & ~hh & (d < 1.7)):
        return False
    return float(d[hh].max()) <= max_span


def make_ligand(rng, params: dict, min_nonbonded: float, max_span: float,
                atoms: Sequence[int], torsions: Sequence[int],
                name: str) -> Ligand:
    """A ligand whose atom count lies in `atoms` and rotatable bonds in
    `torsions` (closed ranges), with a conformer that passes
    conformer_ok."""
    for _ in range(5000):
        lig = _grow(rng, params, int(rng.integers(atoms[0], atoms[1] + 1)),
                    int(rng.integers(torsions[0], torsions[1] + 1)))
        nt = len(rotatable_bonds(lig))
        if not (atoms[0] <= lig.num_atoms <= atoms[1]
                and torsions[0] <= nt <= torsions[1]):
            continue
        far = _topo_far(lig)
        for _ in range(params["embed_tries"]):
            x = _embed(lig, rng, far, min_nonbonded)
            if conformer_ok(lig, x, min_nonbonded, max_span, far):
                lig.coords = x - x.mean(axis=0)
                lig.name = name
                return lig
    raise RuntimeError(f"no ligand in atoms {atoms}, torsions {torsions}")


def random_rotation(rng) -> np.ndarray:
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def sdf_block(lig: Ligand, coords: Optional[np.ndarray] = None) -> str:
    x = lig.coords if coords is None else coords
    out = [lig.name, "  dockbench", ""]
    out.append(f"{lig.num_atoms:3d}{len(lig.bonds):3d}  0  0  0  0  0  0  0"
               "  0999 V2000")
    for (px, py, pz), e in zip(x, lig.elems):
        out.append(f"{px:10.4f}{py:10.4f}{pz:10.4f} {e:<3s} 0  0  0  0  0"
                   "  0  0  0  0  0  0  0")
    for a, b, o in lig.bonds:
        out.append(f"{a + 1:3d}{b + 1:3d}{o:3d}  0  0  0  0")
    out.append("M  END")
    out.append("$$$$")
    return "\n".join(out) + "\n"
