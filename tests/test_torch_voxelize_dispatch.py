"""Where the rescore's grids come from: the CUDA voxeliser
(ops/voxelize.voxelize_cuda) on a card outside autograd, the plain
voxeliser everywhere else.  On the CPU, with the device test made to say
"card" where a case needs it and the kernel replaced by a recorder; the
kernel itself is held against the plain voxeliser in
test_torch_voxelize_cuda.py, on a card."""

import os
import re

import numpy as np
import pytest
import torch

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.models import scorer as tscorer
from gnina_tpu_torch.ops import _cuda
from gnina_tpu_torch.ops import voxelize as vox

SENTINEL = 7.0


@pytest.fixture(scope="module")
def chunk():
    """A toy-model scorer (13^3 grid at 1 A) and one rescore chunk of 4
    poses: (scorer, prep, tensors)."""
    spec, params = fx.toy_cnn(0)
    model = convert.cnn_model_from_numpy(spec, params, name="toy",
                                         device="cpu")
    sc = tscorer.CNNScorer(models=[model], device="cpu")
    lig = fx.ligand()
    rec = fx.receptor(fx.ligand_center(lig), 0, cube=20.0)
    rng = np.random.default_rng(0)
    coords = (lig.orig_coords[None]
              + rng.normal(scale=0.5, size=(4, 1, 3))).astype(np.float32)
    prep = sc.prepare_multi(rec, [(lig, coords)])
    a = [torch.as_tensor(v) for v in prep["rec"]] + [
        torch.as_tensor(prep[k]) for k in ("coords", "types", "mask",
                                           "centers")]
    return sc, prep, a


def _plain_grids(sc, prep, a):
    """The receptor through the x-sorted window plus the ligand, written
    out with the plain functions."""
    m0 = sc.models[0]
    rc, rt, rm, lc, lt, lm, centers = a
    kw = dict(num_channels=m0.num_channels, npoints=m0.grid_points,
              resolution=m0.resolution, radius_scale=m0.radius_scale)
    rch, rr = tscorer._rec_typing(m0, rt)
    lch, lr = tscorer._lig_typing(m0, lt)
    return (vox.voxelize_windowed(rc, rch, rr, rm, centers,
                                  window=prep["win"], **kw)
            + vox.voxelize_batch(lc, lch, lr, lm, centers, **kw))


@pytest.fixture
def kernel(monkeypatch):
    """The kernel replaced by a recorder that returns grids of SENTINEL."""
    calls = []

    def fake(rec_coords, rec_channels, rec_radii, rec_mask, centers,
             num_channels, npoints=48, resolution=0.5, radius_scale=1.0,
             ligand=None):
        calls.append(dict(k=rec_coords.shape[0], ligand=ligand,
                          channels=num_channels, npoints=npoints,
                          resolution=resolution))
        n = npoints
        return torch.full((centers.shape[0], num_channels, n, n, n),
                          SENTINEL)

    monkeypatch.setattr(tscorer, "voxelize_cuda", fake)
    return calls


@pytest.fixture
def on_card(monkeypatch):
    monkeypatch.setattr(vox, "on_card", lambda t: True)


def test_cpu_grids_are_the_plain_voxelisers_bit_for_bit(chunk, kernel):
    """On the CPU the rescore's grids are the plain functions' own, to the
    bit, and the kernel is never asked."""
    sc, prep, a = chunk
    with torch.no_grad():
        got = sc.voxelize_group(sc.models[0], *a, prep["win"])
    assert kernel == []
    assert torch.equal(got, _plain_grids(sc, prep, a))


def test_on_a_card_outside_autograd_one_kernel_call(chunk, kernel, on_card):
    """The rescore's chunk goes to the kernel once, with the receptor, the
    ligand poses and the model's grid settings."""
    sc, prep, a = chunk
    m0 = sc.models[0]
    with torch.no_grad():
        got = sc.voxelize_group(m0, *a, prep["win"])
    assert len(kernel) == 1
    call = kernel[0]
    assert call["k"] == len(prep["rec"][0])
    assert call["ligand"][0].shape == a[3].shape
    assert (call["channels"], call["npoints"], call["resolution"]) == (
        m0.num_channels, m0.grid_points, m0.resolution)
    assert bool((got == SENTINEL).all())


def test_the_receptor_alone_on_a_card(chunk, kernel, on_card):
    """receptor_grids outside autograd on a card: the kernel with no
    ligand."""
    sc, prep, a = chunk
    rc, rt, rm, *_rest, centers = a
    with torch.no_grad():
        sc.receptor_grids(sc.models[0], rc, rt, rm, centers, prep["win"])
    assert len(kernel) == 1 and kernel[0]["ligand"] is None


@pytest.mark.parametrize("case", ["autograd", "rotation", "unsorted"])
def test_the_plain_path_stays(chunk, kernel, on_card, case):
    """Even on a card: under autograd (the kernel has no backward), with a
    rotation, and for a receptor not sorted by x (win 0), the plain
    voxeliser makes the grids."""
    sc, prep, a = chunk
    m0 = sc.models[0]
    b = a[-1].shape[0]
    win, rot = prep["win"], None
    if case == "rotation":
        rot = torch.eye(3).expand(b, 3, 3)
    if case == "unsorted":
        win = 0
    with torch.set_grad_enabled(case == "autograd"):
        got = sc.voxelize_group(m0, *a, win, rot)
    assert kernel == []
    want = _plain_grids(sc, prep, a)
    if case == "autograd":
        assert torch.equal(got, want)
    else:
        assert float((got - want).abs().max()) <= 1e-5


def test_the_cnn_objective_keeps_its_gradient(chunk, kernel, on_card):
    """The split CNN objective on a card: the receptor grids from the
    kernel (no gradient), the ligand's through the plain voxeliser, whose
    gradient reaches the coordinates."""
    sc, prep, a = chunk
    rc, rt, rm, lc, lt, lm, centers = a
    prep_fn, loss_fn = sc.make_loss_fn_split(rc, rt, rm)
    rec_grids = prep_fn(centers)
    assert len(kernel) == 1 and kernel[0]["ligand"] is None
    x = lc.clone().requires_grad_(True)
    loss_fn(rec_grids, x, lt, lm, centers).sum().backward()
    assert len(kernel) == 1
    assert x.grad is not None and float(x.grad.abs().sum()) > 0.0


def test_the_kernel_refuses_cpu_tensors(chunk):
    sc, prep, a = chunk
    rc, rt, rm, *_rest, centers = a
    with pytest.raises(ValueError):
        vox.voxelize_cuda(rc, rt, rc[:, 0], rm, centers, num_channels=28)


def test_kernel_applies_only_on_a_card_outside_autograd(monkeypatch):
    t = torch.zeros(1)
    with torch.no_grad():
        assert not vox.kernel_applies(t)
    monkeypatch.setattr(vox, "on_card", lambda t: True)
    with torch.no_grad():
        assert vox.kernel_applies(t)
    with torch.enable_grad():
        assert not vox.kernel_applies(t)


def test_the_sources_name_the_voxeliser():
    assert _cuda.SOURCES["voxelize"].endswith(
        os.path.join("csrc", "voxelize.cu"))
    assert os.path.exists(_cuda.SOURCES["voxelize"])
    assert _cuda._BIND["voxelize"] is _cuda._bind_voxelize


@pytest.mark.parametrize("name", ["gt_voxelize", "gt_voxelize_error_string"])
def test_bound_signature_matches_the_cuda_entry_point(name):
    """ctypes binds each entry point with as many arguments as the C
    function takes."""
    class Lib:
        pass

    lib = Lib()
    for fn in ("gt_voxelize", "gt_voxelize_error_string"):
        setattr(lib, fn, type("Fn", (), {})())
    _cuda._bind_voxelize(lib)
    with open(_cuda.SOURCES["voxelize"]) as f:
        m = re.search(rf"\b{name}\((.*?)\)\s*\{{", f.read(), re.S)
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(getattr(lib, name).argtypes) == len(params)
