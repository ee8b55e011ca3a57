"""Minimal SMARTS pattern matcher over chem.mol.Molecule.

Supports the subset of SMARTS needed for covalent-docking ligand-atom
patterns (reference: gninasrc/lib/covinfo.h:43 OBSmartsPattern usage;
typical patterns are small, e.g. "[$(C=O)]", "C(=O)[OX1]", "[SX2H1]"):

  atoms      C N O S P F Cl Br I B  (aliphatic), c n o s p (aromatic), *
  brackets   [..] with primitives:
               element symbol / aromatic symbol / #<anum> / * / A / a
               D<n> explicit degree       X<n> total connections (w/ imp. H)
               H<n> total hydrogen count  h<n> implicit hydrogen count
               R / R0 ring membership     r<n> in ring of size n
               v<n> valence               +<n> / -<n> formal charge
               $(<smarts>) recursive match rooted at the atom
               ! negation, & high-AND, , OR, ; low-AND (precedence ! & , ;)
  bonds      - = # : ~ / \\  (default bond = single-or-aromatic)
  branches   ( ... )
  rings      digit closures 1-9 and %nn

match() returns mappings pattern-atom-index -> molecule-atom-index;
match_unique() deduplicates by matched atom set like OpenBabel's
GetUMapList (covinfo.cpp:171-174 returns unique matches).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from gnina_tpu_torch.chem.mol import Molecule

_SYMBOL_TO_ANUM = {
    "H": 1, "B": 5, "C": 6, "N": 7, "O": 8, "F": 9, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Se": 34, "Br": 35, "I": 53,
}
_TWO_CHAR = ("Cl", "Br", "Si", "Se")


# -- primitive predicates ----------------------------------------------------

@dataclasses.dataclass
class _Prim:
    kind: str            # elem|arom_elem|any|aliph|arom|deg|conn|hcount|
                         # imph|ring|ringsize|valence|charge|recursive
    value: object = None


class _Expr:
    """Boolean expression tree over primitives."""

    def __init__(self, op: str, kids=None, prim: Optional[_Prim] = None):
        self.op = op          # "prim" | "not" | "and" | "or"
        self.kids = kids or []
        self.prim = prim

    def eval(self, ctx: "_MolCtx", ai: int) -> bool:
        if self.op == "prim":
            return ctx.check(self.prim, ai)
        if self.op == "not":
            return not self.kids[0].eval(ctx, ai)
        if self.op == "and":
            return all(k.eval(ctx, ai) for k in self.kids)
        return any(k.eval(ctx, ai) for k in self.kids)


@dataclasses.dataclass
class _PatAtom:
    expr: _Expr


@dataclasses.dataclass
class _PatBond:
    a: int
    b: int
    kind: str   # "-" "=" "#" ":" "~" "default"


class _MolCtx:
    """Pre-computed molecule properties for fast predicate checks."""

    def __init__(self, mol: Molecule):
        self.mol = mol
        n = mol.num_atoms()
        self.adj = mol.adjacency()
        self.imp_h = [mol.implicit_hydrogen_count(i) for i in range(n)]
        self.exp_h = [sum(1 for j, _ in self.adj[i]
                          if mol.atoms[j].anum == 1) for i in range(n)]
        rings = mol.rings()
        self.ring_sizes: List[set] = [set() for _ in range(n)]
        for r in rings:
            for a in r:
                self.ring_sizes[a].add(len(r))
        self.in_ring = [bool(s) for s in self.ring_sizes]
        self._rec_cache: Dict[int, set] = {}

    def check(self, p: _Prim, i: int) -> bool:
        a = self.mol.atoms[i]
        if p.kind == "elem":
            return a.anum == p.value and not a.aromatic
        if p.kind == "elem_any":      # "#6" matches regardless of aromaticity
            return a.anum == p.value
        if p.kind == "arom_elem":
            return a.anum == p.value and a.aromatic
        if p.kind == "any":
            return True
        if p.kind == "aliph":
            return not a.aromatic
        if p.kind == "arom":
            return a.aromatic
        if p.kind == "deg":
            return len(self.adj[i]) == p.value
        if p.kind == "conn":
            return len(self.adj[i]) + self.imp_h[i] == p.value
        if p.kind == "hcount":
            return self.exp_h[i] + self.imp_h[i] == p.value
        if p.kind == "imph":
            return self.imp_h[i] == p.value
        if p.kind == "ring":
            return self.in_ring[i] == bool(p.value)
        if p.kind == "ringsize":
            return p.value in self.ring_sizes[i]
        if p.kind == "valence":
            tot = self.imp_h[i]
            for j, b in self.adj[i]:
                tot += 1.5 if b.aromatic else b.order
            return int(round(tot)) == p.value
        if p.kind == "charge":
            return a.formal_charge == p.value
        if p.kind == "recursive":
            pat_id = id(p.value)
            if pat_id not in self._rec_cache:
                roots = set()
                for m in p.value.match(self.mol, ctx=self):
                    roots.add(m[0])
                self._rec_cache[pat_id] = roots
            return i in self._rec_cache[pat_id]
        raise ValueError(f"unknown primitive {p.kind}")


def _bond_ok(kind: str, bond) -> bool:
    if kind == "~":
        return True
    if kind == ":":
        return bond.aromatic
    if kind == "-":
        return bond.order == 1 and not bond.aromatic
    if kind == "=":
        return bond.order == 2 and not bond.aromatic
    if kind == "#":
        return bond.order == 3
    # default: single or aromatic
    return bond.aromatic or bond.order == 1


# -- parser -------------------------------------------------------------------

class SmartsError(ValueError):
    pass


class SmartsPattern:
    def __init__(self, smarts: str):
        self.smarts = smarts
        self.atoms: List[_PatAtom] = []
        self.bonds: List[_PatBond] = []
        self._parse(smarts)
        # adjacency of the pattern graph
        self.adj: List[List[Tuple[int, _PatBond]]] = [
            [] for _ in self.atoms]
        for b in self.bonds:
            self.adj[b.a].append((b.b, b))
            self.adj[b.b].append((b.a, b))

    # parsing ------------------------------------------------------------

    def _parse(self, s: str):
        self.pos = 0
        self.s = s
        stack: List[int] = []
        prev: Optional[int] = None
        pending_bond = "default"
        ring_open: Dict[str, Tuple[int, str]] = {}

        while self.pos < len(self.s):
            c = self.s[self.pos]
            if c == "(":
                if prev is None:
                    raise SmartsError("branch before any atom")
                stack.append(prev)
                self.pos += 1
            elif c == ")":
                if not stack:
                    raise SmartsError("unbalanced )")
                prev = stack.pop()
                self.pos += 1
            elif c in "-=#:~/\\":
                pending_bond = "-" if c in "/\\" else c
                self.pos += 1
            elif c.isdigit() or c == "%":
                if c == "%":
                    label = self.s[self.pos + 1:self.pos + 3]
                    self.pos += 3
                else:
                    label = c
                    self.pos += 1
                if label in ring_open:
                    a, bk = ring_open.pop(label)
                    kind = pending_bond if pending_bond != "default" else bk
                    self.bonds.append(_PatBond(a, prev, kind))
                else:
                    ring_open[label] = (prev, pending_bond)
                pending_bond = "default"
            else:
                expr = self._parse_atom()
                ai = len(self.atoms)
                self.atoms.append(_PatAtom(expr))
                if prev is not None:
                    self.bonds.append(_PatBond(prev, ai, pending_bond))
                pending_bond = "default"
                prev = ai
        if stack:
            raise SmartsError("unbalanced (")
        if ring_open:
            raise SmartsError("unclosed ring bond")
        if not self.atoms:
            raise SmartsError("empty pattern")

    def _parse_atom(self) -> _Expr:
        s, i = self.s, self.pos
        c = s[i]
        if c == "[":
            j = self._matching_bracket(i)
            inner = s[i + 1:j]
            self.pos = j + 1
            return self._parse_bracket(inner)
        # bare atom
        for sym in _TWO_CHAR:
            if s.startswith(sym, i):
                self.pos = i + len(sym)
                return _Expr("prim", prim=_Prim("elem", _SYMBOL_TO_ANUM[sym]))
        if c == "*":
            self.pos = i + 1
            return _Expr("prim", prim=_Prim("any"))
        if c == "A":
            self.pos = i + 1
            return _Expr("prim", prim=_Prim("aliph"))
        if c == "a":
            self.pos = i + 1
            return _Expr("prim", prim=_Prim("arom"))
        if c.isupper():
            if c not in _SYMBOL_TO_ANUM:
                raise SmartsError(f"unknown atom symbol {c!r}")
            self.pos = i + 1
            return _Expr("prim", prim=_Prim("elem", _SYMBOL_TO_ANUM[c]))
        if c.islower():
            sym = c.upper()
            if sym not in _SYMBOL_TO_ANUM:
                raise SmartsError(f"unknown aromatic symbol {c!r}")
            self.pos = i + 1
            return _Expr("prim", prim=_Prim("arom_elem", _SYMBOL_TO_ANUM[sym]))
        raise SmartsError(f"cannot parse atom at {s[i:]!r}")

    def _matching_bracket(self, i: int) -> int:
        depth = 0
        for j in range(i, len(self.s)):
            if self.s[j] == "[":
                depth += 1
            elif self.s[j] == "]":
                depth -= 1
                if depth == 0:
                    return j
        raise SmartsError("unbalanced [")

    def _parse_bracket(self, inner: str) -> _Expr:
        # precedence: ; (low AND) > , (OR) > & (high AND) > ! (NOT)
        def parse_or(tokens: List[str]) -> _Expr:
            pass  # placeholder, structured below

        # split on ';' then ',' then '&', respecting $() nesting
        def split_level(text: str, sep: str) -> List[str]:
            parts, depth, cur = [], 0, []
            for ch in text:
                if ch == "(":
                    depth += 1
                elif ch == ")":
                    depth -= 1
                if ch == sep and depth == 0:
                    parts.append("".join(cur))
                    cur = []
                else:
                    cur.append(ch)
            parts.append("".join(cur))
            return parts

        def build(text: str, seps=(";", ",", "&")) -> _Expr:
            if not seps:
                return self._parse_primitive_seq(text)
            sep = seps[0]
            parts = split_level(text, sep)
            if len(parts) == 1:
                return build(text, seps[1:])
            kids = [build(p, seps[1:]) for p in parts]
            op = "or" if sep == "," else "and"
            return _Expr(op, kids=kids)

        return build(inner)

    def _parse_primitive_seq(self, text: str) -> _Expr:
        """A run of implicitly-ANDed primitives, each optionally !-negated."""
        prims: List[_Expr] = []
        i = 0
        while i < len(text):
            neg = False
            while i < len(text) and text[i] == "!":
                neg = not neg
                i += 1
            if i >= len(text):
                raise SmartsError(f"dangling ! in [{text}]")
            prim, i = self._one_primitive(text, i)
            e = _Expr("prim", prim=prim)
            if neg:
                e = _Expr("not", kids=[e])
            prims.append(e)
        if not prims:
            raise SmartsError(f"empty bracket expression [{text}]")
        return prims[0] if len(prims) == 1 else _Expr("and", kids=prims)

    def _one_primitive(self, t: str, i: int) -> Tuple[_Prim, int]:
        def num_after(j, default=None):
            k = j
            sign = 1
            if k < len(t) and t[k] in "+-":
                k += 1
            while k < len(t) and t[k].isdigit():
                k += 1
            if k == j:
                return default, j
            return int(t[j:k]), k

        c = t[i]
        if c == "$":
            if i + 1 >= len(t) or t[i + 1] != "(":
                raise SmartsError("$ must be followed by (...)")
            depth = 0
            for j in range(i + 1, len(t)):
                if t[j] == "(":
                    depth += 1
                elif t[j] == ")":
                    depth -= 1
                    if depth == 0:
                        sub = SmartsPattern(t[i + 2:j])
                        return _Prim("recursive", sub), j + 1
            raise SmartsError("unbalanced $(")
        if c == "#":
            v, j = num_after(i + 1)
            if v is None:
                raise SmartsError("# needs a number")
            return _Prim("elem_any", v), j
        if c == "*":
            return _Prim("any"), i + 1
        if c == "A":
            return _Prim("aliph"), i + 1
        if c == "a":
            return _Prim("arom"), i + 1
        if c == "D":
            v, j = num_after(i + 1, 1)
            return _Prim("deg", v), j
        if c == "X":
            v, j = num_after(i + 1, 1)
            return _Prim("conn", v), j
        if c == "H":
            # element H only when followed by nothing digit-like AND the
            # bracket context is element-position; SMARTS treats bare H as
            # hcount=1 in practice for patterns like [SX2H1]
            v, j = num_after(i + 1, 1)
            return _Prim("hcount", v), j
        if c == "h":
            v, j = num_after(i + 1, 1)
            return _Prim("imph", v), j
        if c == "R":
            v, j = num_after(i + 1, None)
            if v is None:
                return _Prim("ring", True), i + 1
            return (_Prim("ring", False), j) if v == 0 else (_Prim("ring", True), j)
        if c == "r":
            v, j = num_after(i + 1, None)
            if v is None:
                return _Prim("ring", True), i + 1
            return _Prim("ringsize", v), j
        if c == "v":
            v, j = num_after(i + 1, 1)
            return _Prim("valence", v), j
        if c in "+-":
            v, j = num_after(i + 1, None)
            if v is None:
                # count consecutive +/- signs
                j = i
                while j < len(t) and t[j] == c:
                    j += 1
                v = j - i
            return _Prim("charge", v if c == "+" else -v), j
        # element symbols (two-char first)
        for sym in _TWO_CHAR:
            if t.startswith(sym, i):
                return _Prim("elem", _SYMBOL_TO_ANUM[sym]), i + len(sym)
        if c.isupper() and c in _SYMBOL_TO_ANUM:
            return _Prim("elem", _SYMBOL_TO_ANUM[c]), i + 1
        if c.islower() and c.upper() in _SYMBOL_TO_ANUM:
            return _Prim("arom_elem", _SYMBOL_TO_ANUM[c.upper()]), i + 1
        raise SmartsError(f"cannot parse primitive at {t[i:]!r}")

    # matching -----------------------------------------------------------

    def match(self, mol: Molecule, ctx: Optional[_MolCtx] = None
              ) -> List[Tuple[int, ...]]:
        """All mappings (pattern atom i -> molecule atom mapping[i])."""
        ctx = ctx or _MolCtx(mol)
        n_pat = len(self.atoms)
        results: List[Tuple[int, ...]] = []

        # candidate molecule atoms per pattern atom 0
        def extend(mapping: Dict[int, int], used: set):
            if len(mapping) == n_pat:
                results.append(tuple(mapping[i] for i in range(n_pat)))
                return
            # next pattern atom adjacent to the mapped set (pattern is
            # connected by construction)
            nxt, anchor = None, None
            for pi in range(n_pat):
                if pi in mapping:
                    continue
                for (pj, _b) in self.adj[pi]:
                    if pj in mapping:
                        nxt, anchor = pi, pj
                        break
                if nxt is not None:
                    break
            if nxt is None:   # disconnected pattern: not supported
                raise SmartsError("disconnected SMARTS not supported")
            # molecule candidates: neighbors of mapping[anchor]
            for (mi, bond) in ctx.adj[mapping[anchor]]:
                if mi in used:
                    continue
                if not self.atoms[nxt].expr.eval(ctx, mi):
                    continue
                ok = True
                for (pj, pb) in self.adj[nxt]:
                    if pj not in mapping:
                        continue
                    mb = _find_bond(ctx, mi, mapping[pj])
                    if mb is None or not _bond_ok(pb.kind, mb):
                        ok = False
                        break
                if ok:
                    mapping[nxt] = mi
                    used.add(mi)
                    extend(mapping, used)
                    del mapping[nxt]
                    used.remove(mi)

        for a0 in range(mol.num_atoms()):
            if self.atoms[0].expr.eval(ctx, a0):
                extend({0: a0}, {a0})
        return results

    def match_unique(self, mol: Molecule) -> List[Tuple[int, ...]]:
        """Unique matches by matched-atom set (OB GetUMapList)."""
        seen = set()
        out = []
        for m in self.match(mol):
            key = frozenset(m)
            if key not in seen:
                seen.add(key)
                out.append(m)
        return out


def _find_bond(ctx: _MolCtx, a: int, b: int):
    for (j, bond) in ctx.adj[a]:
        if j == b:
            return bond
    return None
