"""Carry the JAX package's docking inputs into this package's objects.

The docking search has no learned weights: its parameters are the scoring
function's term table and the per-ligand torsion tree; the CNN rescore's
are a converted model's op list and weight arrays.  These functions
take them as numpy arrays or python floats (as gnina_tpu holds them) and
return the port's objects, so a JAX call and its port counterpart can be
fed the very same inputs.  Nothing here imports gnina_tpu.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from gnina_tpu_torch.chem.ingest import Receptor
from gnina_tpu_torch.chem.mol import Atom, Molecule
from gnina_tpu_torch.chem.tree_build import LigandStruct
from gnina_tpu_torch.constants import DEFAULT_TABLE, AtomTypeTable
from gnina_tpu_torch.scoring.weighted import ScoringFunction, \
    build_scoring_function

_TABLE_FIELDS = ("smina_names", "ad_names", "anum", "ad_radius", "ad_depth",
                 "ad_solvation", "ad_volume", "covalent_radius", "xs_radius",
                 "xs_hydrophobe", "xs_donor", "xs_acceptor", "ad_heteroatom")

_LIGAND_FIELDS = ("name", "local_coords", "orig_coords", "types", "charges",
                  "node_id", "parent", "rel_axis", "rel_origin", "layer",
                  "parent_anchor", "pairs", "num_tors", "num_heavy_atoms",
                  "num_hydrophobic_atoms", "ligand_length", "torsdof")


def scoring_from_numpy(name: str,
                       terms: Sequence[Tuple[str, float]],
                       table: dict) -> ScoringFunction:
    """terms: (reference term description, weight) pairs, e.g. from
    `describe_term`; table: the AtomTypeTable fields as numpy arrays or
    tuples (keys of _TABLE_FIELDS)."""
    tab = AtomTypeTable(**{f: (tuple(table[f]) if f.endswith("names")
                               else np.asarray(table[f]))
                           for f in _TABLE_FIELDS})
    return build_scoring_function(name, [(d, float(w)) for d, w in terms],
                                  tab)


def ligand_from_numpy(arrays: dict) -> LigandStruct:
    """A LigandStruct from its field arrays (keys of _LIGAND_FIELDS, plus
    the optional num_lig_atoms, num_movable_atoms, has_rigid_dof)."""
    kw = {f: arrays[f] for f in _LIGAND_FIELDS}
    for f in ("local_coords", "orig_coords", "rel_axis", "rel_origin",
              "charges"):
        kw[f] = np.asarray(kw[f], np.float32)
    for f in ("types", "node_id", "parent", "layer", "parent_anchor",
              "pairs"):
        kw[f] = np.asarray(kw[f], np.int64)
    for f in ("num_lig_atoms", "num_movable_atoms", "has_rigid_dof"):
        if f in arrays:
            kw[f] = arrays[f]
    return LigandStruct(**kw)


def receptor_from_numpy(coords, types, charges, name: str = "") -> Receptor:
    """A Receptor from atom coordinates, smina types and charges.  The
    molecule graph is not carried (docking reads only these arrays): its
    atoms hold just the element of each type and the coordinates."""
    coords = np.asarray(coords, np.float32)
    types = np.asarray(types, np.int64)
    mol = Molecule(name=name)
    mol.atoms = [Atom(anum=int(DEFAULT_TABLE.anum[t]), coords=c)
                 for t, c in zip(types, coords)]
    return Receptor(mol=mol, coords=coords, types=types,
                    charges=np.asarray(charges, np.float32))


def cnn_model_from_numpy(spec: dict, params: dict, name: str = "model",
                         device=None):
    """A models.registry.CNNModel from a converted model's spec (the op
    list with its metadata, as the JAX package's CNNModel.spec holds it)
    and its parameters as numpy arrays, on `device` (None: the card)."""
    from gnina_tpu_torch.models.registry import model_from_spec

    return model_from_spec(name, spec, {k: np.asarray(v)
                                        for k, v in params.items()},
                           device=device)
