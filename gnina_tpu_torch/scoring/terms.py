"""Empirical (smina/AutoDock-Vina) scoring-function terms on torch tensors.

Each pairwise term is a function of (per-atom-a params, per-atom-b params,
distance r) that broadcasts over any batch shape.  Formulas reproduce the
reference term zoo (reference: gninasrc/lib/everything.h) as vectorized,
differentiable elementwise math — no per-pair virtual dispatch, no
precomputed spline tables.

Per-atom parameters are gathered from an AtomTypeTable by smina type id,
producing a dict of tensors ("type params") that the terms consume.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np
import torch

from gnina_tpu_torch.constants import EPSILON_FL, AtomTypeTable

_F32_MAX = float(np.finfo(np.float32).max)


def gather_type_params(table: AtomTypeTable, types, device=None):
    """Per-atom parameter bundle (torch tensors) for a smina type-id array."""
    t = np.asarray(types.cpu() if torch.is_tensor(types) else types)

    def f(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a[t]), dtype=dtype,
                               device=device)

    return {
        "xs_radius": f(table.xs_radius),
        "hydrophobe": f(table.xs_hydrophobe, torch.bool),
        "donor": f(table.xs_donor, torch.bool),
        "acceptor": f(table.xs_acceptor, torch.bool),
        "solvation": f(table.ad_solvation),
        "volume": f(table.ad_volume),
        "type": torch.as_tensor(t.astype(np.int64), device=device),
    }


def type_param_tables(table: AtomTypeTable, device=None):
    """gather_type_params of every type id: (types,) tensors that a type
    tensor indexes on its own device, with no host read."""
    return gather_type_params(table, np.arange(len(table.xs_radius)), device)


def slope_step(x_bad, x_good, x):
    """Linear interpolant that is 0 at x_bad, 1 at x_good, clipped outside.

    reference: everything.h:207-216.  x_bad != x_good is assumed.
    """
    frac = (x - x_bad) / (x_good - x_bad)
    return torch.clamp(frac, 0.0, 1.0)


def _optimal_distance(pa, pb):
    return pa["xs_radius"] + pb["xs_radius"]


def _vdw_coefficients(n, m, position, depth):
    c_n = position**n * depth * m / (float(n) - float(m))
    c_m = position**m * depth * n / (float(m) - float(n))
    return c_n, c_m


@dataclasses.dataclass(frozen=True)
class Term:
    """Base pairwise term. cutoff in Angstrom; charges used iff charge_dependent."""

    cutoff: float = 8.0
    name: str = ""

    charge_dependent = False

    def eval(self, pa, pb, r, qa=None, qb=None):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Gauss(Term):
    offset: float = 0.0
    width: float = 0.5

    def eval(self, pa, pb, r, qa=None, qb=None):
        d = r - (_optimal_distance(pa, pb) + self.offset)
        return torch.exp(-((d / self.width) ** 2))


@dataclasses.dataclass(frozen=True)
class Repulsion(Term):
    offset: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        d = r - (_optimal_distance(pa, pb) + self.offset)
        return torch.where(d < 0.0, d * d, 0.0)


@dataclasses.dataclass(frozen=True)
class Hydrophobic(Term):
    good: float = 0.5
    bad: float = 1.5

    def eval(self, pa, pb, r, qa=None, qb=None):
        mask = pa["hydrophobe"] & pb["hydrophobe"]
        v = slope_step(self.bad, self.good, r - _optimal_distance(pa, pb))
        return torch.where(mask, v, 0.0)


@dataclasses.dataclass(frozen=True)
class NonHydrophobic(Term):
    good: float = 0.5
    bad: float = 1.5

    def eval(self, pa, pb, r, qa=None, qb=None):
        mask = ~pa["hydrophobe"] & ~pb["hydrophobe"]
        v = slope_step(self.bad, self.good, r - _optimal_distance(pa, pb))
        return torch.where(mask, v, 0.0)


@dataclasses.dataclass(frozen=True)
class Vdw(Term):
    """Smoothed i-j Lennard-Jones (reference: everything.h:287-343)."""

    i: int = 6
    j: int = 12
    smoothing: float = 1.0
    cap: float = 100.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        d0 = _optimal_distance(pa, pb)
        c_i, c_j = _vdw_coefficients(self.i, self.j, d0, 1.0)
        r_s = torch.where(
            r > d0 + self.smoothing,
            r - self.smoothing,
            torch.where(r < d0 - self.smoothing, r + self.smoothing, d0),
        )
        # guard against division by ~0 (reference returns cap there)
        r_s = torch.clamp(r_s, min=0.01)
        val = c_i / r_s**self.i + c_j / r_s**self.j
        return torch.clamp(val, max=self.cap)


def _h_bond_possible(pa, pb):
    return (pa["donor"] & pb["acceptor"]) | (pb["donor"] & pa["acceptor"])


def _anti_h_bond(pa, pb):
    """Both strict donors or both strict acceptors (atom_constants.h:204-212)."""
    a_strict_donor = pa["donor"] & ~pa["acceptor"]
    b_strict_donor = pb["donor"] & ~pb["acceptor"]
    a_strict_acc = ~pa["donor"] & pa["acceptor"]
    b_strict_acc = ~pb["donor"] & pb["acceptor"]
    return (a_strict_donor & b_strict_donor) | (a_strict_acc & b_strict_acc)


@dataclasses.dataclass(frozen=True)
class NonDirHBond(Term):
    """Classic Vina h-bond term (everything.h:479-506)."""

    good: float = -0.7
    bad: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        v = slope_step(self.bad, self.good, r - _optimal_distance(pa, pb))
        return torch.where(_h_bond_possible(pa, pb), v, 0.0)


@dataclasses.dataclass(frozen=True)
class NonDirHBondLJ(Term):
    """10-12 LJ h-bond potential (everything.h:345-385)."""

    offset: float = -0.7
    cap: float = 100.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        d0 = _optimal_distance(pa, pb) + self.offset
        c_i, c_j = _vdw_coefficients(10, 12, d0, 5.0)
        r_s = torch.clamp(r, min=0.01)
        val = torch.clamp(c_i / r_s**10 + c_j / r_s**12, max=self.cap)
        return torch.where(_h_bond_possible(pa, pb), val, 0.0)


def _quadratic_well(pa, pb, r, offset):
    d = r - (_optimal_distance(pa, pb) + offset)
    return torch.where(d < 0.0, d * d, 0.0)


@dataclasses.dataclass(frozen=True)
class NonDirAntiHBondQuadratic(Term):
    offset: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        return torch.where(_anti_h_bond(pa, pb),
                           _quadratic_well(pa, pb, r, self.offset), 0.0)


@dataclasses.dataclass(frozen=True)
class DonorDonorQuadratic(Term):
    offset: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        mask = pa["donor"] & pb["donor"]
        return torch.where(mask, _quadratic_well(pa, pb, r, self.offset), 0.0)


@dataclasses.dataclass(frozen=True)
class AcceptorAcceptorQuadratic(Term):
    offset: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        mask = pa["acceptor"] & pb["acceptor"]
        return torch.where(mask, _quadratic_well(pa, pb, r, self.offset), 0.0)


@dataclasses.dataclass(frozen=True)
class Electrostatic(Term):
    """Charge product / r^power, capped (everything.h:60-99)."""

    power: int = 2
    cap: float = 100.0
    charge_dependent = True

    def eval(self, pa, pb, r, qa=None, qb=None):
        rp = r ** self.power
        inv = torch.where(rp < EPSILON_FL, self.cap, torch.clamp(
            1.0 / torch.clamp(rp, min=EPSILON_FL), max=self.cap))
        return qa * qb * inv


@dataclasses.dataclass(frozen=True)
class AD4Solvation(Term):
    """AutoDock4 desolvation (everything.h:101-147)."""

    desolvation_sigma: float = 3.6
    solvation_q: float = 0.01097
    charge_dependent = True

    def eval(self, pa, pb, r, qa=None, qb=None):
        distfactor = torch.exp(-((r / (2.0 * self.desolvation_sigma)) ** 2))
        type_dep = pa["solvation"] * pb["volume"] + pb["solvation"] * pa["volume"]
        charge_dep = self.solvation_q * (
            torch.abs(qa) * pb["volume"] + torch.abs(qb) * pa["volume"]
        )
        return (type_dep + charge_dep) * distfactor


def _types_match(pa, pb, t1, t2):
    return (((pa["type"] == t1) & (pb["type"] == t2))
            | ((pa["type"] == t2) & (pb["type"] == t1)))


@dataclasses.dataclass(frozen=True)
class AtomTypeGaussian(Term):
    t1: int = 0
    t2: int = 0
    offset: float = 0.0
    width: float = 1.0
    opt_distance: float = 0.0  # xs_radius[t1]+xs_radius[t2], set by factory

    def eval(self, pa, pb, r, qa=None, qb=None):
        d = r - (self.opt_distance + self.offset)
        v = torch.exp(-((d / self.width) ** 2))
        return torch.where(_types_match(pa, pb, self.t1, self.t2), v, 0.0)


@dataclasses.dataclass(frozen=True)
class AtomTypeLinear(Term):
    t1: int = 0
    t2: int = 0
    good: float = 0.0
    bad: float = 0.0
    opt_distance: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        v = slope_step(self.bad, self.good, r - self.opt_distance)
        return torch.where(_types_match(pa, pb, self.t1, self.t2), v, 0.0)


@dataclasses.dataclass(frozen=True)
class AtomTypeQuadratic(Term):
    t1: int = 0
    t2: int = 0
    offset: float = 0.0
    opt_distance: float = 0.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        d = r - (self.opt_distance + self.offset)
        v = torch.where(d < 0.0, d * d, 0.0)
        return torch.where(_types_match(pa, pb, self.t1, self.t2), v, 0.0)


@dataclasses.dataclass(frozen=True)
class AtomTypeInversePower(Term):
    t1: int = 0
    t2: int = 0
    power: int = 1
    cap: float = 100.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        rp = r ** self.power
        v = torch.where(rp < EPSILON_FL, self.cap, torch.clamp(
            1.0 / torch.clamp(rp, min=EPSILON_FL), max=self.cap))
        return torch.where(_types_match(pa, pb, self.t1, self.t2), v, 0.0)


@dataclasses.dataclass(frozen=True)
class AtomTypeLennardJones(Term):
    """6-12 LJ with explicit optimal distance; applies to ALL pairs
    (the reference eval does not check types_match — bug-compatible)."""

    t1: int = 0
    t2: int = 0
    opt_distance: float = 0.0
    cap: float = 100.0

    def eval(self, pa, pb, r, qa=None, qb=None):
        c_i, c_j = _vdw_coefficients(6, 12, self.opt_distance, 1.0)
        r_s = torch.clamp(r, min=0.01)
        return torch.clamp(c_i / r_s**6 + c_j / r_s**12, max=self.cap)


# ---------------------------------------------------------------------------
# Conf-independent (post-processing) terms: everything.h:733-949.  They act
# on host energies (numpy arrays or python floats) after the exact rescore.
# ---------------------------------------------------------------------------

def smooth_div(x, y):
    """reference: everything.h:52-56."""
    x = np.asarray(x, np.float32)
    y = np.asarray(y, np.float32)
    safe_y = np.where(np.abs(y) < EPSILON_FL, np.float32(1.0), y)
    return np.where(
        np.abs(x) < EPSILON_FL,
        np.float32(0.0),
        np.where(np.abs(y) < EPSILON_FL,
                 np.where(x * y > 0, np.float32(_F32_MAX),
                          np.float32(-_F32_MAX)),
                 x / safe_y)).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class ConfIndependent:
    name: str = ""

    def eval(self, inputs, x, w):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NumTorsAdd(ConfIndependent):
    name: str = "num_tors_add"

    def eval(self, inputs, x, w):
        return x + np.float32(w) * inputs["num_tors"]


@dataclasses.dataclass(frozen=True)
class NumTorsSqr(ConfIndependent):
    name: str = "num_tors_sqr"

    def eval(self, inputs, x, w):
        return x + np.float32(0.1 * w) * inputs["num_tors"] ** 2 / np.float32(5.0)


@dataclasses.dataclass(frozen=True)
class NumTorsSqrt(ConfIndependent):
    name: str = "num_tors_sqrt"

    def eval(self, inputs, x, w):
        return x + (np.float32(0.1 * w) * np.sqrt(inputs["num_tors"])
                    / np.float32(np.sqrt(5.0)))


@dataclasses.dataclass(frozen=True)
class NumTorsDiv(ConfIndependent):
    name: str = "num_tors_div"

    def eval(self, inputs, x, w):
        wv = np.float32(0.1 * (w + 1.0))  # w in [0 .. 0.2]
        return smooth_div(x, np.float32(1.0)
                          + wv * inputs["num_tors"] / np.float32(5.0))


@dataclasses.dataclass(frozen=True)
class NumTorsDivSimple(ConfIndependent):
    name: str = "num_tors_div_simple"

    def eval(self, inputs, x, w):
        return smooth_div(x, np.float32(1.0) + np.float32(w) * inputs["num_tors"])


@dataclasses.dataclass(frozen=True)
class LigandLength(ConfIndependent):
    name: str = "ligand_length"

    def eval(self, inputs, x, w):
        return x + np.float32(w) * inputs["ligand_lengths_sum"]


@dataclasses.dataclass(frozen=True)
class NumLigands(ConfIndependent):
    name: str = "num_ligands"

    def eval(self, inputs, x, w):
        return x + np.float32(w) * inputs["num_ligands"]


@dataclasses.dataclass(frozen=True)
class NumHeavyAtomsDiv(ConfIndependent):
    name: str = "num_heavy_atoms_div"

    def eval(self, inputs, x, w):
        return smooth_div(x, np.float32(1.0) + np.float32(0.05 * w)
                          * inputs["num_heavy_atoms"])


@dataclasses.dataclass(frozen=True)
class NumHeavyAtoms(ConfIndependent):
    name: str = "num_heavy_atoms"

    def eval(self, inputs, x, w):
        return x + np.float32(0.05 * w) * inputs["num_heavy_atoms"]


@dataclasses.dataclass(frozen=True)
class NumHydrophobicAtoms(ConfIndependent):
    name: str = "num_hydrophobic_atoms"

    def eval(self, inputs, x, w):
        return x + np.float32(0.05 * w) * inputs["num_hydrophobic_atoms"]


@dataclasses.dataclass(frozen=True)
class ConstantTerm(ConfIndependent):
    name: str = "constant_term"

    def eval(self, inputs, x, w):
        return x + np.float32(w)


# ---------------------------------------------------------------------------
# Term-description parsing (builtins)
# ---------------------------------------------------------------------------

_FLOAT = r"([-+0-9.eE]+)"
_NAME = r"(\S+?)"

_PATTERNS = [
    (re.compile(rf"gauss\(o={_FLOAT},_w={_FLOAT},_c={_FLOAT}\)"),
     lambda m: Gauss(offset=float(m[0]), width=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"repulsion\(o={_FLOAT},_c={_FLOAT}\)"),
     lambda m: Repulsion(offset=float(m[0]), cutoff=float(m[1]))),
    (re.compile(rf"hydrophobic\(g={_FLOAT},_b={_FLOAT},_c={_FLOAT}\)"),
     lambda m: Hydrophobic(good=float(m[0]), bad=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"non_hydrophobic\(g={_FLOAT},_b={_FLOAT},_c={_FLOAT}\)"),
     lambda m: NonHydrophobic(good=float(m[0]), bad=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"vdw\(i={_FLOAT},_j={_FLOAT},_s={_FLOAT},_\^={_FLOAT},_c={_FLOAT}\)"),
     lambda m: Vdw(i=int(float(m[0])), j=int(float(m[1])), smoothing=float(m[2]),
                   cap=float(m[3]), cutoff=float(m[4]))),
    (re.compile(rf"non_dir_h_bond_lj\(o={_FLOAT},_\^={_FLOAT},_c={_FLOAT}\)"),
     lambda m: NonDirHBondLJ(offset=float(m[0]), cap=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"non_dir_anti_h_bond_quadratic\(o={_FLOAT},_c={_FLOAT}\)"),
     lambda m: NonDirAntiHBondQuadratic(offset=float(m[0]), cutoff=float(m[1]))),
    (re.compile(rf"donor_donor_quadratic\(o={_FLOAT},_c={_FLOAT}\)"),
     lambda m: DonorDonorQuadratic(offset=float(m[0]), cutoff=float(m[1]))),
    (re.compile(rf"acceptor_acceptor_quadratic\(o={_FLOAT},_c={_FLOAT}\)"),
     lambda m: AcceptorAcceptorQuadratic(offset=float(m[0]), cutoff=float(m[1]))),
    (re.compile(rf"non_dir_h_bond\(g={_FLOAT},_b={_FLOAT},_c={_FLOAT}\)"),
     lambda m: NonDirHBond(good=float(m[0]), bad=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"electrostatic\(i={_FLOAT},_\^={_FLOAT},_c={_FLOAT}\)"),
     lambda m: Electrostatic(power=int(float(m[0])), cap=float(m[1]), cutoff=float(m[2]))),
    (re.compile(rf"ad4_solvation\(d-sigma={_FLOAT},_s/q={_FLOAT},_c={_FLOAT}\)"),
     lambda m: AD4Solvation(desolvation_sigma=float(m[0]), solvation_q=float(m[1]),
                            cutoff=float(m[2]))),
]

_CONF_INDEP = {
    "num_tors_add": NumTorsAdd,
    "num_tors_sqr": NumTorsSqr,
    "num_tors_sqrt": NumTorsSqrt,
    "num_tors_div": NumTorsDiv,
    "num_tors_div_simple": NumTorsDivSimple,
    "ligand_length": LigandLength,
    "num_ligands": NumLigands,
    "num_heavy_atoms_div": NumHeavyAtomsDiv,
    "num_heavy_atoms": NumHeavyAtoms,
    "num_hydrophobic_atoms": NumHydrophobicAtoms,
    "constant_term": ConstantTerm,
}


def _parse_atom_type_term(desc: str, table: AtomTypeTable):
    from gnina_tpu_torch.constants import string_to_smina_type

    m = re.fullmatch(
        rf"atom_type_gaussian\(t1={_NAME},t2={_NAME},o={_FLOAT},_w={_FLOAT},_c={_FLOAT}\)", desc)
    if m:
        t1, t2 = string_to_smina_type(m[1]), string_to_smina_type(m[2])
        opt = float(table.xs_radius[t1] + table.xs_radius[t2])
        return AtomTypeGaussian(t1=int(t1), t2=int(t2), offset=float(m[3]),
                                width=float(m[4]), cutoff=float(m[5]), opt_distance=opt)
    m = re.fullmatch(
        rf"atom_type_linear\(t1={_NAME},t2={_NAME},g={_FLOAT},_b={_FLOAT},_c={_FLOAT}\)", desc)
    if m:
        t1, t2 = string_to_smina_type(m[1]), string_to_smina_type(m[2])
        opt = float(table.xs_radius[t1] + table.xs_radius[t2])
        return AtomTypeLinear(t1=int(t1), t2=int(t2), good=float(m[3]),
                              bad=float(m[4]), cutoff=float(m[5]), opt_distance=opt)
    m = re.fullmatch(
        rf"atom_type_quadratic\(t1={_NAME},t2={_NAME},o={_FLOAT},_c={_FLOAT}\)", desc)
    if m:
        t1, t2 = string_to_smina_type(m[1]), string_to_smina_type(m[2])
        opt = float(table.xs_radius[t1] + table.xs_radius[t2])
        return AtomTypeQuadratic(t1=int(t1), t2=int(t2), offset=float(m[3]),
                                 cutoff=float(m[4]), opt_distance=opt)
    m = re.fullmatch(
        rf"atom_type_inverse_power\(t1={_NAME},t2={_NAME},i={_FLOAT},_\^={_FLOAT},_c={_FLOAT}\)",
        desc)
    if m:
        t1, t2 = string_to_smina_type(m[1]), string_to_smina_type(m[2])
        return AtomTypeInversePower(t1=int(t1), t2=int(t2), power=int(float(m[3])),
                                    cap=float(m[4]), cutoff=float(m[5]))
    m = re.fullmatch(
        rf"atom_type_lennard_jones\(t1={_NAME},t2={_NAME},o={_FLOAT},_\^={_FLOAT},_c={_FLOAT}\)",
        desc)
    if m:
        t1, t2 = string_to_smina_type(m[1]), string_to_smina_type(m[2])
        return AtomTypeLennardJones(t1=int(t1), t2=int(t2), opt_distance=float(m[3]),
                                    cap=float(m[4]), cutoff=float(m[5]))
    return None


def describe_term(t) -> str:
    """Inverse of parse_term: the reference-format name string of a pair
    term (the names terms::get_names returns, used as column headers in
    --atom_terms output; everything.h registration strings)."""
    from gnina_tpu_torch.constants import smina_type_name

    def g(x):
        return f"{x:g}"

    if isinstance(t, Gauss):
        return f"gauss(o={g(t.offset)},_w={g(t.width)},_c={g(t.cutoff)})"
    if isinstance(t, Repulsion):
        return f"repulsion(o={g(t.offset)},_c={g(t.cutoff)})"
    if isinstance(t, Hydrophobic):
        return f"hydrophobic(g={g(t.good)},_b={g(t.bad)},_c={g(t.cutoff)})"
    if isinstance(t, NonHydrophobic):
        return (f"non_hydrophobic(g={g(t.good)},_b={g(t.bad)},"
                f"_c={g(t.cutoff)})")
    if isinstance(t, Vdw):
        return (f"vdw(i={t.i},_j={t.j},_s={g(t.smoothing)},"
                f"_^={g(t.cap)},_c={g(t.cutoff)})")
    if isinstance(t, NonDirHBondLJ):
        return (f"non_dir_h_bond_lj(o={g(t.offset)},_^={g(t.cap)},"
                f"_c={g(t.cutoff)})")
    if isinstance(t, NonDirAntiHBondQuadratic):
        return (f"non_dir_anti_h_bond_quadratic(o={g(t.offset)},"
                f"_c={g(t.cutoff)})")
    if isinstance(t, DonorDonorQuadratic):
        return f"donor_donor_quadratic(o={g(t.offset)},_c={g(t.cutoff)})"
    if isinstance(t, AcceptorAcceptorQuadratic):
        return f"acceptor_acceptor_quadratic(o={g(t.offset)},_c={g(t.cutoff)})"
    if isinstance(t, NonDirHBond):
        return (f"non_dir_h_bond(g={g(t.good)},_b={g(t.bad)},"
                f"_c={g(t.cutoff)})")
    if isinstance(t, Electrostatic):
        return f"electrostatic(i={t.power},_^={g(t.cap)},_c={g(t.cutoff)})"
    if isinstance(t, AD4Solvation):
        return (f"ad4_solvation(d-sigma={g(t.desolvation_sigma)},"
                f"_s/q={g(t.solvation_q)},_c={g(t.cutoff)})")
    if isinstance(t, AtomTypeGaussian):
        return (f"atom_type_gaussian(t1={smina_type_name(t.t1)},"
                f"t2={smina_type_name(t.t2)},o={g(t.offset)},"
                f"_w={g(t.width)},_c={g(t.cutoff)})")
    if isinstance(t, AtomTypeLinear):
        return (f"atom_type_linear(t1={smina_type_name(t.t1)},"
                f"t2={smina_type_name(t.t2)},g={g(t.good)},"
                f"_b={g(t.bad)},_c={g(t.cutoff)})")
    if isinstance(t, AtomTypeQuadratic):
        return (f"atom_type_quadratic(t1={smina_type_name(t.t1)},"
                f"t2={smina_type_name(t.t2)},o={g(t.offset)},"
                f"_c={g(t.cutoff)})")
    if isinstance(t, AtomTypeInversePower):
        return (f"atom_type_inverse_power(t1={smina_type_name(t.t1)},"
                f"t2={smina_type_name(t.t2)},i={t.power},"
                f"_^={g(t.cap)},_c={g(t.cutoff)})")
    if isinstance(t, AtomTypeLennardJones):
        return (f"atom_type_lennard_jones(t1={smina_type_name(t.t1)},"
                f"t2={smina_type_name(t.t2)},o={g(t.opt_distance)},"
                f"_^={g(t.cap)},_c={g(t.cutoff)})")
    return type(t).__name__


def parse_term(desc: str, table: Optional[AtomTypeTable] = None):
    """Parse a gnina term-description string into a Term or ConfIndependent.

    Matches the self-registered regexes in the reference term zoo
    (everything.h).  Returns None for unrecognized descriptions.
    """
    desc = desc.strip()
    if desc in _CONF_INDEP:
        return _CONF_INDEP[desc]()
    for pat, factory in _PATTERNS:
        m = pat.fullmatch(desc)
        if m:
            return factory(m.groups())
    if table is None:
        from gnina_tpu_torch.constants import DEFAULT_TABLE as table  # noqa: F811
    return _parse_atom_type_term(desc, table)


def available_term_names() -> "list[str]":
    """--print_terms dump: every registered term creator's default-
    parameterized name string, in the reference's registration order
    (everything.h:953-985 term_creators; printed by
    custom_terms.cpp:90-94 print_available_terms)."""

    def g(x):
        return f"{float(x):g}"

    pair = [
        f"electrostatic(i=2,_^={g(100)},_c={g(8)})",
        f"ad4_solvation(d-sigma={g(3.6)},_s/q={g(0.01097)},_c={g(8)})",
        f"gauss(o={g(0)},_w={g(0.5)},_c={g(8)})",
        f"repulsion(o={g(0)},_c={g(8)})",
        f"hydrophobic(g={g(0.5)},_b={g(1.5)},_c={g(8)})",
        f"non_hydrophobic(g={g(0.5)},_b={g(1.5)},_c={g(8)})",
        f"vdw(i=6,_j=12,_s={g(1)},_^={g(100)},_c={g(8)})",
        f"non_dir_h_bond_lj(o={g(-0.7)},_^={g(100)},_c={g(8)})",
        f"non_dir_anti_h_bond_quadratic(o={g(0)},_c={g(8)})",
        f"non_dir_h_bond(g={g(-0.7)},_b={g(0)},_c={g(8)})",
        f"acceptor_acceptor_quadratic(o={g(0)},_c={g(8)})",
        f"donor_donor_quadratic(o={g(0)},_c={g(8)})",
        f"atom_type_gaussian(t1=,t2=,o={g(0)},_w={g(0)},_c={g(8)})",
        f"atom_type_linear(t1=,t2=,g={g(0)},_b={g(0)},_c={g(8)})",
        f"atom_type_quadratic(t1=,t2=,o={g(0)},_c={g(8)})",
        f"atom_type_inverse_power(t1=,t2=,i=0,_^={g(100)},_c={g(8)})",
        f"atom_type_lennard_jones(t1=,t2=,o={g(0)},_^={g(100)},_c={g(8)})",
    ]
    return pair + list(_CONF_INDEP)
