"""Smina unified atom types and per-type parameter tables.

The 28 unified atom types cover all AutoDock4 + X-scale (Vina) atom type
combinations.  Parameter values reproduce the reference tables
(reference: gninasrc/lib/atom_constants.h:45-133 for the default table and
gninasrc/lib/builtinscoring.cpp:7-37 for the vinardo variant), but the
representation is TPU-native: flat numpy arrays indexed by type id so they
can be gathered on-device.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class SminaType(enum.IntEnum):
    Hydrogen = 0
    PolarHydrogen = 1
    AliphaticCarbonXSHydrophobe = 2
    AliphaticCarbonXSNonHydrophobe = 3
    AromaticCarbonXSHydrophobe = 4
    AromaticCarbonXSNonHydrophobe = 5
    Nitrogen = 6
    NitrogenXSDonor = 7
    NitrogenXSDonorAcceptor = 8
    NitrogenXSAcceptor = 9
    Oxygen = 10
    OxygenXSDonor = 11
    OxygenXSDonorAcceptor = 12
    OxygenXSAcceptor = 13
    Sulfur = 14
    SulfurAcceptor = 15
    Phosphorus = 16
    Fluorine = 17
    Chlorine = 18
    Bromine = 19
    Iodine = 20
    Magnesium = 21
    Manganese = 22
    Zinc = 23
    Calcium = 24
    Iron = 25
    GenericMetal = 26
    Boron = 27


NUM_TYPES = 28

# epsilon used throughout the reference for float comparisons
# (reference: gninasrc/lib/common.h)
EPSILON_FL = float(np.finfo(np.float32).eps)
MAX_FL = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class AtomTypeTable:
    """Per-smina-type parameters as flat arrays (index = SminaType value)."""

    smina_names: tuple
    ad_names: tuple
    anum: np.ndarray          # atomic number
    ad_radius: np.ndarray
    ad_depth: np.ndarray
    ad_solvation: np.ndarray
    ad_volume: np.ndarray
    covalent_radius: np.ndarray
    xs_radius: np.ndarray
    xs_hydrophobe: np.ndarray  # bool
    xs_donor: np.ndarray       # bool
    xs_acceptor: np.ndarray    # bool
    ad_heteroatom: np.ndarray  # bool

    def __post_init__(self):
        for f in ("ad_radius", "ad_depth", "ad_solvation", "ad_volume",
                  "covalent_radius", "xs_radius"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), np.float32))
        for f in ("xs_hydrophobe", "xs_donor", "xs_acceptor", "ad_heteroatom"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), bool))
        object.__setattr__(self, "anum", np.asarray(self.anum, np.int32))


def _make_table(rows):
    cols = list(zip(*rows))
    return AtomTypeTable(
        smina_names=tuple(cols[0]),
        ad_names=tuple(cols[1]),
        anum=np.array(cols[2]),
        ad_radius=np.array(cols[3]),
        ad_depth=np.array(cols[4]),
        ad_solvation=np.array(cols[5]),
        ad_volume=np.array(cols[6]),
        covalent_radius=np.array(cols[7]),
        xs_radius=np.array(cols[8]),
        xs_hydrophobe=np.array(cols[9]),
        xs_donor=np.array(cols[10]),
        xs_acceptor=np.array(cols[11]),
        ad_heteroatom=np.array(cols[12]),
    )


# name, adname, anum, ad_radius, ad_depth, ad_solv, ad_vol, cov_radius,
# xs_radius, xs_hydrophobe, xs_donor, xs_acceptor, ad_heteroatom
DEFAULT_TABLE = _make_table([
    ("Hydrogen", "H", 1, 1.0, 0.02, 0.000510, 0.0, 0.37, 0.37, False, False, False, False),
    ("PolarHydrogen", "HD", 1, 1.0, 0.02, 0.000510, 0.0, 0.37, 0.37, False, False, False, False),
    ("AliphaticCarbonXSHydrophobe", "C", 6, 2.0, 0.15, -0.00143, 33.5103, 0.77, 1.9, True, False, False, False),
    ("AliphaticCarbonXSNonHydrophobe", "C", 6, 2.0, 0.15, -0.00143, 33.5103, 0.77, 1.9, False, False, False, False),
    ("AromaticCarbonXSHydrophobe", "A", 6, 2.0, 0.15, -0.00052, 33.5103, 0.77, 1.9, True, False, False, False),
    ("AromaticCarbonXSNonHydrophobe", "A", 6, 2.0, 0.15, -0.00052, 33.5103, 0.77, 1.9, False, False, False, False),
    ("Nitrogen", "N", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.8, False, False, False, True),
    ("NitrogenXSDonor", "N", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.8, False, True, False, True),
    ("NitrogenXSDonorAcceptor", "NA", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.8, False, True, True, True),
    ("NitrogenXSAcceptor", "NA", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.8, False, False, True, True),
    ("Oxygen", "O", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.7, False, False, False, True),
    ("OxygenXSDonor", "O", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.7, False, True, False, True),
    ("OxygenXSDonorAcceptor", "OA", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.7, False, True, True, True),
    ("OxygenXSAcceptor", "OA", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.7, False, False, True, True),
    ("Sulfur", "S", 16, 2.0, 0.2, -0.00214, 33.5103, 1.02, 2.0, False, False, False, True),
    ("SulfurAcceptor", "SA", 16, 2.0, 0.2, -0.00214, 33.5103, 1.02, 2.0, False, False, False, True),
    ("Phosphorus", "P", 15, 2.1, 0.2, -0.00110, 38.7924, 1.06, 2.1, False, False, False, True),
    ("Fluorine", "F", 9, 1.545, 0.08, -0.00110, 15.448, 0.71, 1.5, True, False, False, True),
    ("Chlorine", "Cl", 17, 2.045, 0.276, -0.00110, 35.8235, 0.99, 1.8, True, False, False, True),
    ("Bromine", "Br", 35, 2.165, 0.389, -0.00110, 42.5661, 1.14, 2.0, True, False, False, True),
    ("Iodine", "I", 53, 2.36, 0.55, -0.00110, 55.0585, 1.33, 2.2, True, False, False, True),
    ("Magnesium", "Mg", 12, 0.65, 0.875, -0.00110, 1.56, 1.30, 1.2, False, True, False, True),
    ("Manganese", "Mn", 25, 0.65, 0.875, -0.00110, 2.14, 1.39, 1.2, False, True, False, True),
    ("Zinc", "Zn", 30, 0.74, 0.55, -0.00110, 1.70, 1.31, 1.2, False, True, False, True),
    ("Calcium", "Ca", 20, 0.99, 0.55, -0.00110, 2.77, 1.74, 1.2, False, True, False, True),
    ("Iron", "Fe", 26, 0.65, 0.01, -0.00110, 1.84, 1.25, 1.2, False, True, False, True),
    ("GenericMetal", "M", 0, 1.2, 0.0, -0.00110, 22.4493, 1.75, 1.2, False, True, False, True),
    ("Boron", "B", 5, 2.04, 0.18, -0.00110, 12.052, 0.90, 1.92, True, False, False, False),
])

# Vinardo swaps in its own parameter table (note: AromaticCarbonXSNonHydrophobe
# and SulfurAcceptor are marked hydrophobic here, matching the reference).
VINARDO_TABLE = _make_table([
    ("Hydrogen", "H", 1, 1.0, 0.02, 0.000510, 0.0, 0.37, 0.0, False, False, False, False),
    ("PolarHydrogen", "HD", 1, 1.0, 0.02, 0.000510, 0.0, 0.37, 0.0, False, False, False, False),
    ("AliphaticCarbonXSHydrophobe", "C", 6, 2.0, 0.15, -0.00143, 33.5103, 0.77, 2.0, True, False, False, False),
    ("AliphaticCarbonXSNonHydrophobe", "C", 6, 2.0, 0.15, -0.00143, 33.5103, 0.77, 2.0, False, False, False, False),
    ("AromaticCarbonXSHydrophobe", "A", 6, 2.0, 0.15, -0.00052, 33.5103, 0.77, 1.9, True, False, False, False),
    ("AromaticCarbonXSNonHydrophobe", "A", 6, 2.0, 0.15, -0.00052, 33.5103, 0.77, 1.9, True, False, False, False),
    ("Nitrogen", "N", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.7, False, False, False, True),
    ("NitrogenXSDonor", "N", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.7, False, True, False, True),
    ("NitrogenXSDonorAcceptor", "NA", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.7, False, True, True, True),
    ("NitrogenXSAcceptor", "NA", 7, 1.75, 0.16, -0.00162, 22.4493, 0.75, 1.7, False, False, True, True),
    ("Oxygen", "O", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.6, False, False, False, True),
    ("OxygenXSDonor", "O", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.6, False, True, False, True),
    ("OxygenXSDonorAcceptor", "OA", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.6, False, True, True, True),
    ("OxygenXSAcceptor", "OA", 8, 1.6, 0.2, -0.00251, 17.1573, 0.73, 1.6, False, False, True, True),
    ("Sulfur", "S", 16, 2.0, 0.2, -0.00214, 33.5103, 1.02, 2.0, False, False, False, True),
    ("SulfurAcceptor", "SA", 16, 2.0, 0.2, -0.00214, 33.5103, 1.02, 2.0, True, False, False, True),
    ("Phosphorus", "P", 15, 2.1, 0.2, -0.00110, 38.7924, 1.06, 2.1, False, False, False, True),
    ("Fluorine", "F", 9, 1.545, 0.08, -0.00110, 15.448, 0.71, 1.5, True, False, False, True),
    ("Chlorine", "Cl", 17, 2.045, 0.276, -0.00110, 35.8235, 0.99, 1.8, True, False, False, True),
    ("Bromine", "Br", 35, 2.165, 0.389, -0.00110, 42.5661, 1.14, 2.0, True, False, False, True),
    ("Iodine", "I", 53, 2.36, 0.55, -0.00110, 55.0585, 1.33, 2.2, True, False, False, True),
    ("Magnesium", "Mg", 12, 0.65, 0.875, -0.00110, 1.56, 1.30, 1.2, False, True, False, True),
    ("Manganese", "Mn", 25, 0.65, 0.875, -0.00110, 2.14, 1.39, 1.2, False, True, False, True),
    ("Zinc", "Zn", 30, 0.74, 0.55, -0.00110, 1.70, 1.31, 1.2, False, True, False, True),
    ("Calcium", "Ca", 20, 0.99, 0.55, -0.00110, 2.77, 1.74, 1.2, False, True, False, True),
    ("Iron", "Fe", 26, 0.65, 0.01, -0.00110, 1.84, 1.25, 1.2, False, True, False, True),
    ("GenericMetal", "M", 0, 1.2, 0.0, -0.00110, 22.4493, 1.75, 1.2, False, True, False, True),
    ("Boron", "B", 5, 2.04, 0.18, -0.00110, 12.052, 0.90, 1.92, True, False, False, False),
])

# Element symbols treated as generic metals when an AD name lookup fails
# (reference: atom_constants.h:168-169).
NON_AD_METAL_NAMES = ("Cu", "Fe", "Na", "K", "Hg", "Co", "U", "Cd", "Ni", "Si")
ATOM_EQUIVALENCES = {"Se": "S"}

_ADNAME_TO_TYPE = {}
for _t in SminaType:
    _ADNAME_TO_TYPE.setdefault(DEFAULT_TABLE.ad_names[_t], _t)
_NAME_TO_TYPE = {DEFAULT_TABLE.smina_names[_t]: _t for _t in SminaType}


def string_to_smina_type(name: str):
    """AD4 short name or full smina name -> type (reference: atom_constants.h:230-253)."""
    if len(name) == 0:
        return None
    if len(name) <= 2:
        if name in _ADNAME_TO_TYPE:
            return _ADNAME_TO_TYPE[name]
        if name in ATOM_EQUIVALENCES:
            return string_to_smina_type(ATOM_EQUIVALENCES[name])
        return SminaType.GenericMetal  # catch-all, incl. non-AD metals
    return _NAME_TO_TYPE.get(name)


def table_from_custom_atoms(path: str, base: AtomTypeTable = DEFAULT_TABLE,
                            warn=print) -> AtomTypeTable:
    """--custom_atoms runtime atom-parameter table
    (reference: main.cpp setup_atomconstants_from_file :546-600).

    Each non-comment line: name ad_radius ad_depth ad_solvation ad_volume
    covalent_radius xs_radius xs_hydrophobe xs_donor xs_acceptor
    ad_heteroatom."""
    name_to = {n: i for i, n in enumerate(base.smina_names)}
    float_fields = ("ad_radius", "ad_depth", "ad_solvation", "ad_volume",
                    "covalent_radius", "xs_radius")
    bool_fields = ("xs_hydrophobe", "xs_donor", "xs_acceptor",
                   "ad_heteroatom")
    arrays = {f: np.array(getattr(base, f), copy=True)
              for f in float_fields + bool_fields}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            name = toks[0]
            if name not in name_to:
                warn(f"Line {lineno}: omitting atom type name {name}")
                continue
            if len(toks) < 11:
                raise ValueError(
                    f"Error at line {lineno} of the atom constants file: "
                    f"expected 10 fields after the name, got {len(toks) - 1}")
            i = name_to[name]
            for k, fld in enumerate(float_fields):
                arrays[fld][i] = float(toks[1 + k])
            for k, fld in enumerate(bool_fields):
                arrays[fld][i] = bool(int(float(toks[7 + k])))
    import dataclasses as _dc

    return _dc.replace(base, **arrays)


def smina_type_name(t) -> str:
    """Full smina type name (e.g. 'Oxygen', 'OxygenXSDonor')."""
    return DEFAULT_TABLE.smina_names[int(t)]


def smina_type_to_element_name(t: SminaType) -> str:
    ad = DEFAULT_TABLE.ad_names[t]
    if ad == "A":
        return "C"
    if len(ad) > 1 and ad[-1] in ("A", "D") and ad not in ("Ca",):
        return ad[:-1]
    return ad


def is_hydrogen_type(t) -> bool:
    return t in (SminaType.Hydrogen, SminaType.PolarHydrogen)


IS_HYDROGEN = np.zeros(NUM_TYPES, bool)
IS_HYDROGEN[[SminaType.Hydrogen, SminaType.PolarHydrogen]] = True


def adjust_smina_type(t, h_bonded: bool, hetero_bonded: bool):
    """Neighborhood-dependent type adjustment (reference: atom_constants.h:280-309)."""
    S = SminaType
    if t in (S.AliphaticCarbonXSHydrophobe, S.AliphaticCarbonXSNonHydrophobe):
        return S.AliphaticCarbonXSNonHydrophobe if hetero_bonded else S.AliphaticCarbonXSHydrophobe
    if t in (S.AromaticCarbonXSHydrophobe, S.AromaticCarbonXSNonHydrophobe):
        return S.AromaticCarbonXSNonHydrophobe if hetero_bonded else S.AromaticCarbonXSHydrophobe
    if t in (S.NitrogenXSDonor, S.Nitrogen):
        return S.NitrogenXSDonor if h_bonded else S.Nitrogen
    if t in (S.NitrogenXSDonorAcceptor, S.NitrogenXSAcceptor):
        return S.NitrogenXSDonorAcceptor if h_bonded else S.NitrogenXSAcceptor
    if t in (S.OxygenXSDonor, S.Oxygen):
        return S.OxygenXSDonor if h_bonded else S.Oxygen
    if t in (S.OxygenXSDonorAcceptor, S.OxygenXSAcceptor):
        return S.OxygenXSDonorAcceptor if h_bonded else S.OxygenXSAcceptor
    return t


def atom_info_lines(table: AtomTypeTable = None) -> "list[str]":
    """--print_atom_types dump: the atom-parameter table in the
    reference's format (main.cpp:602-620 print_atom_info), header
    included."""
    t = table or DEFAULT_TABLE

    def g(x):
        return f"{float(x):g}"

    lines = ["#Name radius depth solvation volume covalent_radius xs_radius"
             " xs_hydrophobe xs_donor xs_acceptr ad_heteroatom"]
    for i, name in enumerate(t.smina_names):
        lines.append(" ".join([
            name, g(t.ad_radius[i]), g(t.ad_depth[i]), g(t.ad_solvation[i]),
            g(t.ad_volume[i]), g(t.covalent_radius[i]), g(t.xs_radius[i]),
            str(int(t.xs_hydrophobe[i])), str(int(t.xs_donor[i])),
            str(int(t.xs_acceptor[i])), str(int(t.ad_heteroatom[i]))]))
    return lines
