"""Minimal periodic-table data for bond perception and atom typing.

Covalent radii follow Pyykko & Atsumi (2009) single-bond values (Angstrom),
the same data OpenBabel uses for connectivity perception.
"""

from __future__ import annotations

SYMBOL_TO_ANUM = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "W": 74, "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83,
    "U": 92,
}
ANUM_TO_SYMBOL = {v: k for k, v in SYMBOL_TO_ANUM.items()}

COVALENT_RADIUS = {
    1: 0.31, 2: 0.28, 3: 1.28, 4: 0.96, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66,
    9: 0.57, 10: 0.58, 11: 1.66, 12: 1.41, 13: 1.21, 14: 1.11, 15: 1.07,
    16: 1.05, 17: 1.02, 18: 1.06, 19: 2.03, 20: 1.76, 21: 1.70, 22: 1.60,
    23: 1.53, 24: 1.39, 25: 1.39, 26: 1.32, 27: 1.26, 28: 1.24, 29: 1.32,
    30: 1.22, 31: 1.22, 32: 1.20, 33: 1.19, 34: 1.20, 35: 1.20, 36: 1.16,
    37: 2.20, 38: 1.95, 39: 1.90, 40: 1.75, 41: 1.64, 42: 1.54, 43: 1.47,
    44: 1.46, 45: 1.42, 46: 1.39, 47: 1.45, 48: 1.44, 49: 1.42, 50: 1.39,
    51: 1.39, 52: 1.38, 53: 1.39, 54: 1.40, 55: 2.44, 56: 2.15, 57: 2.07,
    74: 1.62, 78: 1.36, 79: 1.36, 80: 1.32, 81: 1.45, 82: 1.46, 83: 1.48,
    92: 1.96,
}

METALS = frozenset(
    [3, 4, 11, 12, 13, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
     31, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 55, 56,
     57, 74, 78, 79, 80, 81, 82, 83, 92])

# typical max valences for bond-order perception
MAX_VALENCE = {1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1, 14: 4, 15: 5, 16: 6,
               17: 1, 35: 1, 53: 1}


def symbol_to_anum(sym: str) -> int:
    s = sym.strip()
    if not s:
        return 0
    s = s[0].upper() + s[1:].lower()
    if s in SYMBOL_TO_ANUM:
        return SYMBOL_TO_ANUM[s]
    # single-letter fallback (e.g. "CL1" -> Cl handled by caller; "C1" -> C)
    if s[0] in SYMBOL_TO_ANUM:
        return SYMBOL_TO_ANUM[s[0]]
    return 0


def covalent_radius(anum: int) -> float:
    return COVALENT_RADIUS.get(anum, 1.5)
