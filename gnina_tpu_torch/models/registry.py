"""CNN model registry: names, ensembles and loading of converted models.

Mirrors the reference's embedded-model table and ensemble-expansion logic
(reference: gninasrc/lib/cnn_torch_scorer.cpp:28-66, torch_models.h).  The
converted models (a `.spec.json` op list + `.npz` weights each) are read in
place from the repository's one copy, gnina_tpu/data/models/, or from a
`models_dir` the caller names.  A user's own TorchScript checkpoint (a
`.pt` path, --cnn_model) is converted by models/torchscript_import.py into
CACHE_DIR, keyed by the file's contents, and runs through the same
SpecModule.  Every built-in name has its converted file in the repository;
a name without one raises (the JAX registry's conversion of a name from a
directory of TorchScript sources is not ported).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from gnina_tpu_torch.device import resolve_device
from gnina_tpu_torch.models.runtime import SpecModule, load_spec
from gnina_tpu_torch.models.torchscript_import import convert_and_save
from gnina_tpu_torch.models.typer import (ChannelTyper, DEFAULT_LIGMAP,
                                          DEFAULT_RECMAP)

# the repository's converted models, beside this package
MODELS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "gnina_tpu", "data", "models")
# conversions of user checkpoints (--cnn_model), inside the package's
# build directory
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build",
    "models")

ALL_MODEL_FILES = [
    "all_default_to_default_1.3_1", "all_default_to_default_1.3_2",
    "all_default_to_default_1.3_3", "crossdock_default2018",
    "crossdock_default2018_1.3", "crossdock_default2018_1.3_1",
    "crossdock_default2018_1.3_2", "crossdock_default2018_1.3_3",
    "crossdock_default2018_1.3_4", "crossdock_default2018_1",
    "crossdock_default2018_2", "crossdock_default2018_3",
    "crossdock_default2018_4", "crossdock_default2018_KD_1",
    "crossdock_default2018_KD_2", "crossdock_default2018_KD_3",
    "crossdock_default2018_KD_4", "crossdock_default2018_KD_5",
    "default2017", "dense", "dense_1.3", "dense_1.3_1", "dense_1.3_2",
    "dense_1.3_3", "dense_1.3_4", "dense_1.3_PT_KD", "dense_1.3_PT_KD_1",
    "dense_1.3_PT_KD_2", "dense_1.3_PT_KD_3", "dense_1.3_PT_KD_4",
    "dense_1.3_PT_KD_def2018", "dense_1.3_PT_KD_def2018_1",
    "dense_1.3_PT_KD_def2018_2", "dense_1.3_PT_KD_def2018_3",
    "dense_1.3_PT_KD_def2018_4", "dense_1", "dense_2", "dense_3", "dense_4",
    "general_default2018", "general_default2018_1", "general_default2018_2",
    "general_default2018_3", "general_default2018_4",
    "general_default2018_KD_1", "general_default2018_KD_2",
    "general_default2018_KD_3", "general_default2018_KD_4",
    "general_default2018_KD_5", "redock_default2018", "redock_default2018_1.3",
    "redock_default2018_1.3_1", "redock_default2018_1.3_2",
    "redock_default2018_1.3_3", "redock_default2018_1.3_4",
    "redock_default2018_1", "redock_default2018_2", "redock_default2018_3",
    "redock_default2018_4", "redock_default2018_KD_1",
    "redock_default2018_KD_2", "redock_default2018_KD_3",
    "redock_default2018_KD_4", "redock_default2018_KD_5",
]

MODEL_NAMES = {f.replace(".", "_"): f for f in ALL_MODEL_FILES}

DEFAULT_ENSEMBLE = ["dense_1_3", "dense_1_3_PT_KD_3", "crossdock_default2018_KD_4"]
FAST_MODEL = "all_default_to_default_1_3_1"
DEFAULT_1_0_ENSEMBLE = ["dense", "general_default2018_3", "dense_3",
                        "crossdock_default2018", "redock_default2018_2"]


def expand_model_names(names: List[str]) -> List[str]:
    """Ensemble expansion (cnn_torch_scorer.cpp:28-64)."""
    if not names:
        return list(DEFAULT_ENSEMBLE)
    if len(names) == 1:
        if names[0] == "fast":
            return [FAST_MODEL]
        if names[0] == "default1.0":
            return list(DEFAULT_1_0_ENSEMBLE)
        if names[0] in ("default", "default2.0"):
            return list(DEFAULT_ENSEMBLE)
    out: List[str] = []
    for name in names:
        if name.endswith("_ensemble"):
            prefix = name[: -len("_ensemble")]
            matches = sorted(k for k in MODEL_NAMES if k.startswith(prefix))
            if not matches:
                raise KeyError(f"no models match ensemble prefix {prefix!r}")
            out.extend(matches)
        else:
            out.append(name)
    return out


@dataclasses.dataclass
class CNNModel:
    name: str
    module: SpecModule          # op list + parameters on the model's device
    rec_typer: ChannelTyper
    lig_typer: ChannelTyper
    resolution: float
    dimension: float
    radius_scale: float
    skip_softmax: bool
    apply_logistic_loss: bool

    @property
    def spec(self) -> dict:
        return self.module.spec

    @property
    def grid_points(self) -> int:
        return int(round(self.dimension / self.resolution)) + 1

    @property
    def num_channels(self) -> int:
        return self.rec_typer.num_channels + self.lig_typer.num_channels


def model_from_spec(name: str, spec: dict, params: Dict[str, np.ndarray],
                    device=None) -> CNNModel:
    """A CNNModel from a converted spec and its numpy parameters."""
    meta = spec.get("metadata", {}) or {}
    return CNNModel(
        name=name,
        module=SpecModule(spec, params, device=device),
        rec_typer=ChannelTyper(meta.get("recmap", DEFAULT_RECMAP)),
        lig_typer=ChannelTyper(meta.get("ligmap", DEFAULT_LIGMAP)),
        resolution=float(meta.get("resolution", 0.5)),
        dimension=float(meta.get("dimension", 23.5)),
        radius_scale=float(meta.get("radius_scaling", 1.0)),
        skip_softmax=bool(meta.get("skip_softmax", False)),
        apply_logistic_loss=bool(meta.get("apply_logistic_loss", False)),
    )


_MODEL_CACHE: dict = {}


def load_model_from_file(path: str, device=None) -> CNNModel:
    """A user's TorchScript checkpoint (--cnn_model) on `device` (None: the
    card): converted once into CACHE_DIR under the hash of its bytes, then
    loaded as a converted model."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        tag = "file_" + hashlib.sha1(f.read()).hexdigest()[:16]
    key = (tag, CACHE_DIR, str(device))
    if key not in _MODEL_CACHE:
        spec_path = os.path.join(CACHE_DIR, f"{tag}.spec.json")
        npz_path = os.path.join(CACHE_DIR, f"{tag}.npz")
        if not (os.path.exists(spec_path) and os.path.exists(npz_path)):
            # convert beside the cache and move in, so that concurrent
            # processes never read a half-written file
            os.makedirs(CACHE_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=CACHE_DIR) as tmp:
                convert_and_save(path, tmp, tag)
                os.replace(os.path.join(tmp, f"{tag}.npz"), npz_path)
                os.replace(os.path.join(tmp, f"{tag}.spec.json"), spec_path)
        spec, params = load_spec(spec_path, npz_path)
        _MODEL_CACHE[key] = model_from_spec(tag, spec, params, device=device)
    return _MODEL_CACHE[key]


def load_model(name: str, device=None,
               models_dir: Optional[str] = None) -> CNNModel:
    """The converted model `name` on `device` (None: the card), from
    `models_dir` (None: the repository's gnina_tpu/data/models); a path to
    an existing `.pt` file is a user's checkpoint (load_model_from_file)."""
    if name.endswith(".pt") and os.path.exists(name):
        return load_model_from_file(name, device)
    device = resolve_device(device)
    name = name.replace(".", "_")
    models_dir = os.path.abspath(models_dir or MODELS_DIR)
    key = (name, models_dir, str(device))
    if key not in _MODEL_CACHE:
        spec_path = os.path.join(models_dir, f"{name}.spec.json")
        npz_path = os.path.join(models_dir, f"{name}.npz")
        if not (os.path.exists(spec_path) and os.path.exists(npz_path)):
            known = "" if name in MODEL_NAMES else " (not a built-in name)"
            raise FileNotFoundError(
                f"CNN model {name!r}{known}: no converted {name}.spec.json + "
                f"{name}.npz under {models_dir}; converting a name from its "
                f"TorchScript source is not ported (a .pt path converts)")
        spec, params = load_spec(spec_path, npz_path)
        _MODEL_CACHE[key] = model_from_spec(name, spec, params, device=device)
    return _MODEL_CACHE[key]
