"""TorchScript import (models/torchscript_import.py) and --cnn_model in the
port, against the JAX package's on the CPU.

A toy checkpoint is made in the test: a 3D convolution over the default
typers' 28 channels, relu, a max pool, and a log-softmax pose head plus an
affinity head, traced with torch.jit.trace and saved with a `metadata`
extra file (resolution 1 A, dimension 12 A: a 13^3 grid).  The two
packages' importers give the same spec and parameters; the port's
SpecModule replays it as torch.jit.load's module computes it (1e-5); the
registry loads a `.pt` path; `--score_only --cnn_model` scores as the JAX
command line does (CNNscore and CNNaffinity within 1e-4, the system near
the origin, where JAX's voxelizer is good to 1e-4); an op outside the
supported set raises naming it.
"""

import json
import re

import numpy as np
import pytest
import torch

from gnina_tpu import cli as jcli
from gnina_tpu.models import registry as jregistry
from gnina_tpu.models import torchscript_import as jimport
from gnina_tpu_torch import cli as tcli
from gnina_tpu_torch.models import registry as tregistry
from gnina_tpu_torch.models import torchscript_import as timport
from gnina_tpu_torch.models.runtime import SpecModule, normalize_spec
from test_torch_gninagrid import write_origin_system

META = {"resolution": 1.0, "dimension": 12.0}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class ToyNet(torch.nn.Module):
    def __init__(self, width: int = 4, act=torch.relu):
        super().__init__()
        self.act = act
        self.conv = torch.nn.Conv3d(28, width, 3, padding=1)
        self.pool = torch.nn.MaxPool3d(2)
        self.pose = torch.nn.Linear(width * 6 ** 3, 2)
        self.affinity = torch.nn.Linear(width * 6 ** 3, 1)

    def forward(self, x):
        f = torch.flatten(self.pool(self.act(self.conv(x))), 1)
        return (torch.log_softmax(self.pose(f), dim=1),
                self.affinity(f).squeeze(-1))


def save_toy(path, seed: int = 0, act=torch.relu, meta=META):
    """Trace a ToyNet made from `seed` and save it with its metadata."""
    torch.manual_seed(seed)
    net = ToyNet(act=act).eval()
    x = torch.randn(2, 28, 13, 13, 13)
    traced = torch.jit.trace(net, x)
    traced.save(str(path), _extra_files={"metadata": json.dumps(meta)})
    return str(path)


@pytest.fixture(scope="module")
def toy_pt(tmp_path_factory):
    return save_toy(tmp_path_factory.mktemp("toy_pt") / "toy.pt")


def _jsonable(spec):
    """The spec as it is stored (tuples become lists)."""
    return json.loads(json.dumps(spec, default=list))


def test_import_equals_jax(toy_pt):
    tspec, tparams = timport.import_torchscript(toy_pt)
    jspec, jparams = jimport.import_torchscript(toy_pt)
    assert _jsonable(tspec) == _jsonable(jspec)
    assert tspec["metadata"] == META
    assert [op["op"] for op in tspec["ops"]] == [
        "aten::_convolution", "aten::relu", "aten::max_pool3d",
        "aten::flatten", "aten::linear", "aten::log_softmax", "aten::linear",
        "aten::squeeze"]
    assert sorted(tparams) == sorted(jparams)
    for k in tparams:
        assert tparams[k].dtype == np.float32
        assert np.array_equal(tparams[k], jparams[k]), k


def test_convert_and_save_files_equal_jax(toy_pt, tmp_path):
    a = timport.convert_and_save(toy_pt, str(tmp_path / "t"), "toy")
    b = jimport.convert_and_save(toy_pt, str(tmp_path / "j"), "toy")
    assert open(a).read() == open(b).read()
    ta, tb = np.load(a.replace(".spec.json", ".npz")), \
        np.load(b.replace(".spec.json", ".npz"))
    assert ta.files == tb.files
    for k in ta.files:
        assert np.array_equal(ta[k], tb[k])


@pytest.mark.parametrize("batch", [1, 3])
def test_spec_module_equals_torchscript(toy_pt, batch):
    spec, params = timport.import_torchscript(toy_pt)
    module = SpecModule(normalize_spec(_jsonable(spec)), params, device="cpu")
    x = torch.as_tensor(np.random.default_rng(batch).normal(
        size=(batch, 28, 13, 13, 13)).astype(np.float32))
    with torch.no_grad():
        got = module(x)
        want = torch.jit.load(toy_pt)(x)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert (g - w).abs().max().item() <= 1e-5


def test_registry_loads_a_pt_path(toy_pt, tmp_path, monkeypatch):
    monkeypatch.setattr(tregistry, "CACHE_DIR", str(tmp_path / "cache"))
    m = tregistry.load_model(toy_pt, device="cpu")
    assert m.grid_points == 13 and m.num_channels == 28
    assert m.resolution == 1.0 and m.dimension == 12.0
    assert all(b.device.type == "cpu" for b in m.module.buffers())
    files = sorted(p.name for p in (tmp_path / "cache").iterdir())
    assert len(files) == 2 and files[0].endswith(".npz") \
        and files[1].endswith(".spec.json")
    # cached: the same object, and no second conversion
    assert tregistry.load_model(toy_pt, device="cpu") is m
    assert tregistry.load_model_from_file(toy_pt, device="cpu") is m
    # the CNNScorer takes the path among its model names
    from gnina_tpu_torch.models.scorer import CNNScorer

    sc = CNNScorer([toy_pt], device="cpu")
    assert len(sc.models) == 1 and sc.models[0] is m


def test_registry_pt_without_card_raises(toy_pt, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(tregistry, "CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tregistry.load_model(toy_pt)


def test_unsupported_op_raises_naming_it(tmp_path):
    pt = save_toy(tmp_path / "tanh.pt", act=torch.tanh)
    for mod in (timport, jimport):
        with pytest.raises(NotImplementedError, match="aten::tanh"):
            mod.import_torchscript(pt)


_TAG = re.compile(r">  <(CNNscore|CNNaffinity)>\n(\S+)")


def test_cli_cnn_model_score_only_equals_jax(toy_pt, tmp_path, monkeypatch):
    """--score_only --cnn_model toy.pt: the SDF's CNNscore and CNNaffinity
    within 1e-4 of the JAX command line's on the same files; conversions go
    to each package's cache, here under the test's directory."""
    monkeypatch.setattr(tregistry, "CACHE_DIR", str(tmp_path / "tcache"))
    monkeypatch.setattr(jregistry, "_CACHE_DIR", str(tmp_path / "jcache"))
    lig, rec = write_origin_system(tmp_path, n_ligs=2)
    argv = ["-r", rec, "-l", lig, "--score_only", "--cnn_model", toy_pt,
            "-q"]
    t_out, j_out = tmp_path / "t.sdf", tmp_path / "j.sdf"
    assert tcli.main(argv + ["--device", "cpu", "-o", str(t_out)]) == 0
    assert jcli.main(argv + ["-o", str(j_out)]) == 0
    t = [(k, float(v)) for k, v in _TAG.findall(t_out.read_text())]
    j = [(k, float(v)) for k, v in _TAG.findall(j_out.read_text())]
    assert [k for k, _ in t] == [k for k, _ in j] == ["CNNscore",
                                                      "CNNaffinity"] * 2
    assert np.allclose([v for _, v in t], [v for _, v in j], rtol=0,
                       atol=1e-4)
    assert all(0.0 < v < 1.0 for k, v in t if k == "CNNscore")
    assert len(list((tmp_path / "tcache").iterdir())) == 2
