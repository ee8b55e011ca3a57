"""Standard-residue templates for receptor atom typing.

The reference pipes the receptor through OpenBabel (AddHydrogens(polar) +
PDBQT typing, reference: gninasrc/lib/molgetter.cpp:137-139).  Without
OpenBabel we encode the chemistry directly: which protein atoms carry polar
hydrogens (donors), which nitrogens are acceptors, and which atoms are
aromatic.  Oxygens are always acceptors in the smina typing scheme.
"""

from __future__ import annotations

STANDARD_RESIDUES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    # common variants
    "HID", "HIE", "HIP", "CYX", "MSE", "SEC",
}

# (resname, atomname) pairs whose N/O carries at least one polar hydrogen
# after protonation at physiological pH
_DONOR_ATOMS = {
    ("ARG", "NE"), ("ARG", "NH1"), ("ARG", "NH2"),
    ("LYS", "NZ"),
    ("ASN", "ND2"), ("GLN", "NE2"),
    ("TRP", "NE1"),
    ("HIS", "NE2"), ("HIE", "NE2"), ("HIP", "NE2"), ("HIP", "ND1"),
    ("HID", "ND1"),
    ("SER", "OG"), ("THR", "OG1"), ("TYR", "OH"),
    ("CYS", "SG"),  # thiol H (polar); S types carry no donor flag anyway
}

# aromatic ring N that accept (no H): HIS ND1 in the epsilon tautomer
_ACCEPTOR_N = {
    ("HIS", "ND1"), ("HIE", "ND1"), ("HID", "NE2"),
}

_AROMATIC_ATOMS = {
    "PHE": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TYR": {"CG", "CD1", "CD2", "CE1", "CE2", "CZ"},
    "TRP": {"CG", "CD1", "CD2", "NE1", "CE2", "CE3", "CZ2", "CZ3", "CH2"},
    "HIS": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HID": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HIE": {"CG", "ND1", "CD2", "CE1", "NE2"},
    "HIP": {"CG", "ND1", "CD2", "CE1", "NE2"},
}


def is_standard_residue(resname: str) -> bool:
    return resname in STANDARD_RESIDUES


def is_backbone_n(resname: str, atomname: str) -> bool:
    return atomname == "N"


def protein_atom_flags(resname: str, atomname: str, anum: int):
    """(h_bonded, n_acceptor, aromatic) for a standard-residue atom.

    h_bonded: carries a polar H after protonation -> donor types.
    n_acceptor: nitrogen typed "NA" (h-bond acceptor).
    """
    aromatic = atomname in _AROMATIC_ATOMS.get(resname, ())
    if anum == 7:
        if atomname == "N":
            # backbone amide N: donor unless proline; never an acceptor
            return resname != "PRO", False, False
        donor = (resname, atomname) in _DONOR_ATOMS
        acceptor = (resname, atomname) in _ACCEPTOR_N
        return donor, acceptor, aromatic
    if anum == 8:
        donor = (resname, atomname) in _DONOR_ATOMS
        return donor, True, False
    if anum == 16:
        donor = (resname, atomname) in _DONOR_ATOMS
        return donor, False, False
    return False, False, aromatic
