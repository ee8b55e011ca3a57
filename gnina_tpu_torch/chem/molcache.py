"""Pre-parsed ligand serialization (tognina/fromgnina equivalent).

reference: gninasrc/tognina.cpp / fromgnina.cpp serialize the parsed smina
tree (gzip + boost archives) so screening pipelines skip molecule parsing.
The device-ready equivalent serializes LigandStruct arrays to npz — every
field the device needs, zero chemistry at load time.
"""

from __future__ import annotations

import io
import json
import zipfile
from typing import Iterator, List

import numpy as np

from gnina_tpu_torch.chem.tree_build import LigandStruct

_ARRAY_FIELDS = [
    "local_coords", "orig_coords", "types", "charges", "node_id",
    "parent", "rel_axis", "rel_origin", "layer", "parent_anchor", "pairs",
]
_SCALAR_FIELDS = ["num_tors", "num_heavy_atoms", "num_hydrophobic_atoms",
                  "ligand_length", "torsdof", "num_lig_atoms",
                  "num_movable_atoms"]


def save_ligands(path: str, ligs: List[LigandStruct]):
    """Write a .molcache file (zip of npz records + manifest)."""
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        manifest = []
        for i, lig in enumerate(ligs):
            buf = io.BytesIO()
            arrays = {f: getattr(lig, f) for f in _ARRAY_FIELDS}
            if lig.other_pairs is not None:
                arrays["other_pairs"] = lig.other_pairs
            np.savez(buf, **arrays)
            z.writestr(f"lig{i}.npz", buf.getvalue())
            manifest.append({
                "name": lig.name,
                **{f: getattr(lig, f) for f in _SCALAR_FIELDS},
            })
        z.writestr("manifest.json", json.dumps(manifest))


def load_ligands(path: str) -> Iterator[LigandStruct]:
    with zipfile.ZipFile(path) as z:
        manifest = json.loads(z.read("manifest.json"))
        for i, meta in enumerate(manifest):
            raw = np.load(io.BytesIO(z.read(f"lig{i}.npz")))
            kwargs = {f: raw[f] for f in _ARRAY_FIELDS}
            kwargs["other_pairs"] = (raw["other_pairs"]
                                     if "other_pairs" in raw.files else None)
            yield LigandStruct(
                name=meta["name"],
                num_tors=meta["num_tors"],
                num_heavy_atoms=meta["num_heavy_atoms"],
                num_hydrophobic_atoms=meta["num_hydrophobic_atoms"],
                ligand_length=meta["ligand_length"],
                torsdof=meta["torsdof"],
                num_lig_atoms=meta.get("num_lig_atoms", -1),
                num_movable_atoms=meta.get("num_movable_atoms", -1),
                mol=None,
                **kwargs,
            )
