"""The port's CNN rescore against the JAX package on the CPU: the
voxelizer, every op kind of the op-list runtime, one real model forward,
the batched ensemble scorer, and the engine's rescore and sort.

Inputs come from a numpy seed (or the in-repo fixtures) and go through the
JAX function and its port counterpart; each tolerance is stated where it
is checked.  The JAX scorer's ensemble program runs un-jitted here (its
jitted form compiles for minutes on a CPU); the arithmetic is the same."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.models import registry as jregistry
from gnina_tpu.models import runtime as jruntime
from gnina_tpu.models import scorer as jscorer
from gnina_tpu.ops import voxelize as jvox
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.models import registry as tregistry
from gnina_tpu_torch.models import runtime as truntime
from gnina_tpu_torch.models import scorer as tscorer
from gnina_tpu_torch.models.typer import ChannelTyper as TTyper
from gnina_tpu_torch.ops import voxelize as tvox

FAST = "all_default_to_default_1_3_1"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ voxelize ----

def _atoms(seed, a=40, nchan=6, spread=4.0, offset=12.0):
    """Atoms `offset` angstroms from the origin, some masked, some with
    channel -1.  The JAX voxelizer takes the squared distance by expansion,
    whose float32 rounding grows with the square of the coordinates: its
    grids are good to 1e-4 only within ~30 A of the origin, so the
    comparisons with it stay there."""
    rng = np.random.default_rng(seed)
    center = np.asarray([offset, -offset / 2, offset / 3], np.float32)
    coords = (center + rng.normal(scale=spread, size=(a, 3))).astype(
        np.float32)
    channels = rng.integers(-1, nchan, a).astype(np.int32)
    radii = rng.uniform(1.2, 2.2, a).astype(np.float32)
    mask = rng.random(a) > 0.1
    return coords, channels, radii, mask, center


@pytest.mark.parametrize("binary", [False, True])
def test_voxelize_matches_jax(binary):
    """(C, 12, 12, 12) grids within atol 1e-4 of the JAX voxelizer (the
    reference's grid-parity bar); binary occupancy grids equal except at
    cells whose distance lies within float32 rounding of a radius."""
    coords, channels, radii, mask, center = _atoms(1)
    kw = dict(num_channels=6, npoints=12, resolution=0.75, radius_scale=1.1,
              binary=binary)
    want = np.asarray(jvox.voxelize(
        jnp.asarray(coords), jnp.asarray(channels), jnp.asarray(radii),
        jnp.asarray(mask), jnp.asarray(center), **kw))
    got = tvox.voxelize(torch.as_tensor(coords), torch.as_tensor(channels),
                        torch.as_tensor(radii), torch.as_tensor(mask),
                        torch.as_tensor(center), **kw).numpy()
    assert got.shape == want.shape == (6, 12, 12, 12)
    assert want.max() > 0.5
    if binary:
        assert (got != want).mean() < 1e-3
    else:
        np.testing.assert_allclose(got, want, atol=1e-4)


def test_voxelize_far_from_the_origin_matches_float64():
    """60 A from the origin the port's grid is still within 1e-5 of the
    density formula in float64 (it sums squared coordinate differences;
    the expansion |p|^2 + |a|^2 - 2 p.a is ~3e-4 off there)."""
    coords, channels, radii, mask, center = _atoms(6, offset=60.0)
    n, res = 12, 0.5
    got = tvox.voxelize(torch.as_tensor(coords), torch.as_tensor(channels),
                        torch.as_tensor(radii), torch.as_tensor(mask),
                        torch.as_tensor(center), num_channels=6, npoints=n,
                        resolution=res).numpy()
    ax = [np.float64(center[i]) - res * (n - 1) / 2 + res * np.arange(n)
          for i in range(3)]
    pts = np.stack(np.meshgrid(*ax, indexing="ij"), -1).reshape(-1, 3)
    d = np.linalg.norm(pts[:, None] - coords[None].astype(np.float64),
                       axis=-1)
    r = radii.astype(np.float64)
    dens = np.where(d <= r, np.exp(-2 * d * d / (r * r)),
                    np.where(d <= 1.5 * r,
                             np.exp(-2.0) * (2 * d / r - 3) ** 2, 0.0))
    want = np.zeros((6, n ** 3))
    for j in range(len(coords)):
        if mask[j] and channels[j] >= 0:
            want[channels[j]] += dens[:, j]
    np.testing.assert_allclose(got.reshape(6, -1), want, atol=1e-5)
    assert want.max() > 0.5


def test_voxelize_batch_is_voxelize_per_item(monkeypatch):
    """Three x slabs per chunk for the batch (a chunk boundary that does
    not divide the grid), nine for each single item."""
    sets = [_atoms(s, a=24) for s in (2, 3, 4)]
    stack = [torch.as_tensor(np.stack([s[i] for s in sets]))
             for i in range(5)]
    kw = dict(num_channels=6, npoints=10, resolution=0.5)
    monkeypatch.setattr(tvox, "SLAB_BUDGET", 3 * 3 * 10 * 10 * 24)
    got = tvox.voxelize_batch(*stack, **kw)
    for i, s in enumerate(sets):
        one = tvox.voxelize(*[torch.as_tensor(x) for x in s], **kw)
        np.testing.assert_allclose(got[i].numpy(), one.numpy(), atol=1e-6)


def test_voxelize_windowed_matches_jax():
    """The x-sorted windowed voxelizer at two grid centers: within atol
    1e-4 of JAX's windowed voxelizer and of the plain voxelizer; the window
    width is JAX's."""
    coords, channels, radii, mask, center = _atoms(5, a=300, spread=9.0,
                                                   offset=8.0)
    order = np.argsort(coords[:, 0], kind="stable")
    coords, channels, radii, mask = (x[order] for x in (coords, channels,
                                                        radii, mask))
    reach = 1.5 * float(radii.max()) + 0.5
    win = tvox.slab_window_size(coords[:, 0], reach, pad_to=16)
    assert win == jvox.slab_window_size(coords[:, 0], reach, pad_to=16)
    assert win < len(coords)
    centers = np.stack([center, center + np.asarray([1.3, -0.7, 2.1],
                                                    np.float32)])
    kw = dict(num_channels=6, npoints=12, resolution=0.5)
    t = [torch.as_tensor(x) for x in (coords, channels, radii, mask)]
    got = tvox.voxelize_windowed(*t, torch.as_tensor(centers), window=win,
                                 **kw).numpy()
    for i, c in enumerate(centers):
        want = np.asarray(jvox.voxelize_windowed(
            jnp.asarray(coords), jnp.asarray(channels), jnp.asarray(radii),
            jnp.asarray(mask), jnp.asarray(c), window=win, **kw))
        np.testing.assert_allclose(got[i], want, atol=1e-4)
        plain = tvox.voxelize(*t, torch.as_tensor(c), **kw).numpy()
        np.testing.assert_allclose(got[i], plain, atol=1e-4)


def test_typer_tables_match_jax():
    from gnina_tpu.models.typer import ChannelTyper as JTyper, \
        DEFAULT_LIGMAP, DEFAULT_RECMAP

    for text in (DEFAULT_RECMAP, DEFAULT_LIGMAP):
        j, t = JTyper(text), TTyper(text)
        np.testing.assert_array_equal(j.table, t.table)
        np.testing.assert_array_equal(j.radii, t.radii)
        assert j.num_channels == t.num_channels
        assert j.channel_names == t.channel_names


# ------------------------------------------------------------- runtime ----

def _ref(n):
    return ("ref", n)


def _c(v):
    return ("const", v)


def _p(n):
    return ("param", n)


# op kind -> (ops after the input "x", params shapes); the input is
# (2, 3, 6, 6, 6) unless the case names another
_OP_CASES = {
    "max_pool3d": ([("aten::max_pool3d", [_ref("x"), _c([2, 2, 2]), _c([]),
                                          _c([0, 0, 0])])], {}),
    "max_pool3d_padded": ([("aten::max_pool3d", [_ref("x"), _c([3, 3, 3]),
                                                 _c([2, 2, 2]),
                                                 _c([1, 1, 1])])], {}),
    "avg_pool3d": ([("aten::avg_pool3d", [_ref("x"), _c([2, 2, 2]),
                                          _c([2, 2, 2]), _c([0, 0, 0])])],
                   {}),
    "avg_pool3d_padded": ([("aten::avg_pool3d", [_ref("x"), _c([3, 3, 3]),
                                                 _c([]), _c([1, 1, 1])])],
                          {}),
    "_convolution": ([("aten::_convolution", [
        _ref("x"), _p("w"), _p("b"), _c([1, 1, 1]), _c([1, 1, 1]),
        _c([1, 1, 1])])], {"w": (4, 3, 3, 3, 3), "b": (4,)}),
    "_convolution_strided_nobias": ([("aten::_convolution", [
        _ref("x"), _p("w"), _c(None), _c([2, 2, 2]), _c([0, 0, 0]),
        _c([1, 1, 1])])], {"w": (4, 3, 2, 2, 2)}),
    "batch_norm": ([("aten::batch_norm", [
        _ref("x"), _p("w"), _p("b"), _p("mean"), _p("var+"), _c(0), _c(0.1),
        _c(1e-3), _c(1)])], {"w": (3,), "b": (3,), "mean": (3,),
                             "var+": (3,)}),
    "relu": ([("aten::relu", [_ref("x")])], {}),
    "relu_": ([("aten::relu_", [_ref("x")])], {}),
    "sigmoid": ([("aten::sigmoid", [_ref("x")])], {}),
    "cat": ([("aten::relu", [_ref("x")]),
             ("aten::cat", [("list", [_ref("x"), _ref("o0")]), _c(1)])], {}),
    "view": ([("aten::view", [_ref("x"), _c([-1, 648])])], {}),
    "reshape": ([("aten::reshape", [_ref("x"), _c([2, 3, 216])])], {}),
    "flatten": ([("aten::flatten", [_ref("x"), _c(1), _c(-1)])], {}),
    "linear": ([("aten::view", [_ref("x"), _c([-1, 648])]),
                ("aten::linear", [_ref("o0"), _p("w"), _p("b")])],
               {"w": (5, 648), "b": (5,)}),
    "t_matmul": ([("aten::view", [_ref("x"), _c([-1, 648])]),
                  ("aten::t", [_p("w")]),
                  ("aten::matmul", [_ref("o0"), _ref("o1")])],
                 {"w": (5, 648)}),
    "addmm": ([("aten::view", [_ref("x"), _c([-1, 648])]),
               ("aten::addmm", [_p("b"), _ref("o0"), _p("w")])],
              {"w": (648, 5), "b": (5,)}),
    "size_view": ([("aten::size", [_ref("x"), _c(0)]),
                   ("aten::Int", [_ref("o0")]),
                   ("aten::view", [_ref("x"), ("list", [_ref("o1"),
                                                        _c(-1)])])], {}),
    "add": ([("aten::relu", [_ref("x")]),
             ("aten::add", [_ref("x"), _ref("o0")])], {}),
    "log_softmax": ([("aten::view", [_ref("x"), _c([-1, 648])]),
                     ("aten::log_softmax", [_ref("o0"), _c(1)])], {}),
    "softmax": ([("aten::view", [_ref("x"), _c([-1, 648])]),
                 ("aten::softmax", [_ref("o0"), _c(1)])], {}),
    "squeeze": ([("aten::slice", [_ref("x"), _c(1), _c(0), _c(1), _c(1)]),
                 ("aten::squeeze", [_ref("o0"), _c(1)])], {}),
    "dropout": ([("aten::dropout", [_ref("x"), _c(0.5), _c(False)])], {}),
    "slice": ([("aten::slice", [_ref("x"), _c(2), _c(-4), _c(None),
                                _c(2)])], {}),
    "select": ([("aten::select", [_ref("x"), _c(1), _c(2)])], {}),
    "mul_sub_div": ([("aten::sigmoid", [_ref("x")]),
                     ("aten::mul", [_ref("x"), _ref("o0")]),
                     ("aten::sub", [_ref("o1"), _ref("x")]),
                     ("aten::div", [_ref("o2"), _c(3.0)])], {}),
    "exp": ([("aten::exp", [_ref("x")])], {}),
    "where_gt_lt_zeros_like": ([
        ("aten::gt", [_ref("x"), _c(0.2)]),
        ("aten::lt", [_ref("x"), _c(1.0)]),
        ("aten::zeros_like", [_ref("x")]),
        ("aten::where", [_ref("o0"), _ref("x"), _ref("o2")]),
        ("aten::where", [_ref("o1"), _ref("o3"), _ref("o2")])], {}),
    "zeros_ones_hstack": ([
        ("aten::view", [_ref("x"), _c([-1, 648])]),
        ("aten::zeros", [_c([2, 3])]),
        ("aten::ones", [_c([2, 2])]),
        ("aten::hstack", [("list", [_ref("o0"), _ref("o1"),
                                    _ref("o2")])])], {}),
    "unsqueeze": ([("aten::unsqueeze", [_ref("x"), _c(1)])], {}),
}


@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_runtime_op_matches_jax(case):
    """Each op kind of runtime.execute on a small synthetic spec: the same
    input and parameters through the JAX executor and the port's, within
    1e-5."""
    ops, shapes = _OP_CASES[case]
    rng = np.random.default_rng(sorted(_OP_CASES).index(case))
    x = rng.normal(size=(2, 3, 6, 6, 6)).astype(np.float32)
    params = {}
    for k, shp in shapes.items():
        v = rng.normal(size=shp).astype(np.float32) * 0.3
        params[k] = np.abs(v) + 0.5 if k.endswith("+") else v
    spec = {"input": "x",
            "ops": [{"op": kind, "in": list(args), "out": f"o{i}"}
                    for i, (kind, args) in enumerate(ops)],
            "output": [("ref", f"o{len(ops) - 1}")]}
    want = jruntime.execute(spec, {k: jnp.asarray(v)
                                   for k, v in params.items()},
                            jnp.asarray(x))[0]
    mod = truntime.SpecModule(spec, params, device="cpu")
    got = mod(torch.as_tensor(x))[0]
    assert tuple(got.shape) == tuple(np.shape(want))
    np.testing.assert_allclose(got.numpy().astype(np.float32),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-5)


def test_runtime_unknown_op_raises():
    spec = {"input": "x", "ops": [{"op": "aten::nope", "in": [("ref", "x")],
                                   "out": "y"}], "output": ["y"]}
    with pytest.raises(NotImplementedError, match="aten::nope"):
        truntime.SpecModule(spec, {}, device="cpu")(torch.zeros(1, 1, 2, 2, 2))


# -------------------------------------------------------- real models ----

def test_registry_names_match_jax():
    assert tregistry.ALL_MODEL_FILES == jregistry.ALL_MODEL_FILES
    assert tregistry.DEFAULT_ENSEMBLE == jregistry.DEFAULT_ENSEMBLE
    for names in ([], ["fast"], ["default"], ["default1.0"],
                  ["dense_1_3_PT_KD_ensemble"], ["dense", "default2017"]):
        assert tregistry.expand_model_names(names) == \
            jregistry.expand_model_names(names)
    with pytest.raises(KeyError):
        tregistry.expand_model_names(["nothing_ensemble"])


def test_registry_missing_model_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="not ported"):
        tregistry.load_model("dense", device="cpu", models_dir=str(tmp_path))


def test_registry_reads_the_repository_models_in_place():
    """Every model of the default ensemble and the fast model load from
    gnina_tpu/data/models with the JAX loader's settings."""
    for name in tregistry.DEFAULT_ENSEMBLE + [tregistry.FAST_MODEL]:
        t = tregistry.load_model(name, device="cpu")
        j = jregistry.load_model(name)
        assert (t.resolution, t.dimension, t.radius_scale, t.skip_softmax,
                t.apply_logistic_loss) == (
            j.resolution, j.dimension, j.radius_scale, j.skip_softmax,
            j.apply_logistic_loss)
        assert t.grid_points == 48 and t.num_channels == 28
        tp = t.module.params()
        assert set(tp) == set(j.params)
        for k in tp:
            np.testing.assert_array_equal(tp[k].numpy(),
                                          np.asarray(j.params[k]))


@pytest.fixture(scope="module")
def fast_models():
    j = jregistry.load_model(FAST)
    t = convert.cnn_model_from_numpy(
        j.spec, {k: np.asarray(v) for k, v in j.params.items()}, name=FAST,
        device="cpu")
    return j, t


def test_fast_model_forward_matches_jax(fast_models):
    """One real forward of the fast model (48^3 x 28 channels, batch 2) on
    a sparse non-negative grid, the same .npz on both sides through
    convert.cnn_model_from_numpy: outputs within rtol 1e-4 (atol 1e-5)."""
    j, t = fast_models
    rng = np.random.default_rng(0)
    x = (rng.random((2, 28, 48, 48, 48), dtype=np.float32)
         * (rng.random((2, 28, 48, 48, 48)) < 0.05)).astype(np.float32)
    want = jruntime.execute(j.spec, j.params, jnp.asarray(x))
    with torch.no_grad():
        got = t.module(torch.as_tensor(x))
    assert len(got) == len(want) == 2
    assert tuple(got[0].shape) == (2, 2) and tuple(got[1].shape) == (2,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


# ------------------------------------------------------------- scorer ----

@pytest.fixture(scope="module")
def system(tmp_path_factory):
    ligs = list(tingest.iter_ligands(fx.LIGAND_SDF))[:2]
    jligs = list(jingest.iter_ligands(fx.LIGAND_SDF))[:2]
    path = os.path.join(str(tmp_path_factory.mktemp("cnn")), "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(ligs[0]), seed=6,
                                     cube=24.0))
    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    return dict(ligs=ligs, jligs=jligs, rec=tingest.Receptor.from_file(path),
                jrec=jingest.Receptor.from_file(path),
                center=np.asarray(center, np.float32),
                size=np.full(3, 12.0, np.float32))


@pytest.fixture(scope="module")
def scorers(fast_models):
    j, t = fast_models
    js = jscorer.CNNScorer(["fast"])
    ts = tscorer.CNNScorer(models=[t], device="cpu")
    return js, ts


def _jax_scores(js, jrec, items):
    """The JAX scorer's score_poses_multi with its ensemble program run
    un-jitted (the same arithmetic without the long CPU compile)."""
    orig = js._get_program
    js._get_program = lambda b, n, k, win=0: js._build_program(win)
    try:
        return js.score_poses_multi(jrec, items)
    finally:
        js._get_program = orig


def _poses(lig, seed, n):
    rng = np.random.default_rng(seed)
    return (lig.orig_coords[None] + rng.normal(
        scale=0.4, size=(n, 1, 3))).astype(np.float32)


def test_score_poses_multi_matches_jax(system, scorers):
    """Two ligands x 2 poses with the fast model: score, affinity, loss
    and variance within 1e-3 of the JAX scorer (one model, no rotations:
    the variance is 0 on both sides)."""
    js, ts = scorers
    poses = [_poses(l, 10 + i, 2) for i, l in enumerate(system["ligs"])]
    got = ts.score_poses_multi(system["rec"],
                               list(zip(system["ligs"], poses)))
    want = _jax_scores(js, system["jrec"], list(zip(system["jligs"], poses)))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.shape == (2,)
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)
    assert 0.0 < float(got[0][0][0]) < 1.0


def test_scorer_prepares_what_jax_prepares(system, scorers):
    """The host-side preparation: pose padding by repeating the last pose,
    receptor pruned, sorted by x with padding last, and JAX's window."""
    js, ts = scorers
    poses = _poses(system["ligs"][0], 12, 3)
    prep = ts.prepare_multi(system["rec"], [(system["ligs"][0], poses)])
    assert prep["b"] == 3 and prep["bp"] == 4
    assert prep["coords"].shape[0] == 4
    np.testing.assert_array_equal(prep["coords"][3], prep["coords"][2])
    rc, rt, rm = prep["rec"]
    jc, jt, jm = js._receptor_arrays(system["jrec"], prep["centers"][:3])
    assert rc.shape == jc.shape and rm.sum() == jm.sum()
    real = rc[rm]
    assert (np.diff(real[:, 0]) >= 0).all() and not rm[rm.sum():].any()
    want = jvox.slab_window_size(
        np.sort(jc[jm][:, 0]).tolist() + [1e9] * int((~jm).sum()),
        1.5 * float(np.max(js.models[0].rec_typer.radii)) + 0.5)
    assert prep["win"] == want


def test_rotations_and_ensemble_variance(system, fast_models):
    """Two copies of one model give variance 0 without rotations; with
    rotations the affinities differ across rotations (variance > 0), the
    same seed gives the same scores, and rotation 0 is the unrotated
    pass."""
    _, t = fast_models
    lig = system["ligs"][0]
    poses = _poses(lig, 13, 1)
    plain = tscorer.CNNScorer(models=[t, t], device="cpu")
    s0, a0, l0, v0 = plain.score_poses(system["rec"], lig, poses)
    np.testing.assert_allclose(v0, 0.0, atol=1e-10)
    rot = tscorer.CNNScorer(models=[t], rotations=2, seed=3, device="cpu")
    s1, a1, l1, v1 = rot.score_poses(system["rec"], lig, poses)
    s2, a2, _, v2 = rot.score_poses(system["rec"], lig, poses)
    np.testing.assert_array_equal(a1, a2)
    assert (v1 > 0).all()
    # mean over (identity, rotated): the identity half is the plain
    # score, so the rotated half follows, and its spread is the variance
    rotated = 2 * a1 - a0
    assert np.isfinite(rotated).all() and not np.allclose(a1, a0)
    np.testing.assert_allclose(v1, ((a0 - rotated) / 2) ** 2, rtol=1e-3,
                               atol=1e-6)


def test_engine_rescores_and_sorts_by_cnnscore(system, scorers):
    """dock_batch with a scorer and the default cnn_scoring='rescore':
    poses come back sorted by CNNscore, and cnnscore, cnnaffinity and
    cnnvariance are within 1e-3 of the JAX scorer on the same
    coordinates."""
    js, ts = scorers
    eng = DockingEngine(DockSettings(num_mc_steps=32, exhaustiveness=2,
                                     num_mc_saved=4, num_modes=4),
                        cnn_scorer=ts, device="cpu")
    lig = system["ligs"][0]
    res = eng.dock_batch(system["rec"], [lig], system["center"],
                         system["size"], seed=1)[0]
    assert 2 <= len(res) <= 4
    sc = [p.cnnscore for p in res]
    assert sc == sorted(sc, reverse=True) and sc[0] > 0.0
    coords = np.stack([p.coords for p in res])
    want = _jax_scores(js, system["jrec"], [(system["jligs"][0], coords)])[0]
    np.testing.assert_allclose(sc, np.asarray(want[0]), atol=1e-3)
    np.testing.assert_allclose([p.cnnaffinity for p in res],
                               np.asarray(want[1]), atol=1e-3)
    np.testing.assert_allclose([p.cnnvariance for p in res],
                               np.asarray(want[3]), atol=1e-3)
    # sort_order overrides: by affinity, and by energy
    for order, key in (("CNNaffinity", lambda p: -p.cnnaffinity),
                       ("Energy", lambda p: p.energy)):
        eng2 = DockingEngine(dataclasses.replace(eng.settings,
                                                 sort_order=order),
                             cnn_scorer=ts, device="cpu")
        vals = [key(p) for p in eng2._sort(list(res))]
        assert vals == sorted(vals)


def test_score_only_carries_cnn_scores(system, scorers):
    js, ts = scorers
    lig = system["ligs"][0]
    eng = DockingEngine(DockSettings(), cnn_scorer=ts, device="cpu")
    got = eng.score_only(system["rec"], lig)
    s, a, v = ts.score_pose(system["rec"], lig, lig.orig_coords)
    assert (got.cnnscore, got.cnnaffinity, got.cnnvariance) == (s, a, v)
    assert got.cnnscore > 0.0
    none = DockingEngine(DockSettings(cnn_scoring="none"), cnn_scorer=ts,
                         device="cpu").score_only(system["rec"], lig)
    assert (none.cnnscore, none.cnnaffinity) == (0.0, 0.0)
