"""Gradients of the port's CNN pieces against jax.grad of the JAX
package's, on the CPU: the voxelizer with respect to atom coordinates,
every op kind of the op-list runtime with respect to its input, the fast
model with respect to a 48^3 grid, and the scorer's CNN losses
(make_loss_fn_split, make_loss_fn_generic) with respect to ligand
coordinates.

Each gradient is of a weighted sum of the outputs (weights from a numpy
seed), the same inputs through the JAX function (un-jitted) and the
port's.  Bounds are stated per test.  The voxelizer's bound, 1e-3 of the
largest component, holds near the origin: both sides differentiate the
same density of the squared distance, but the JAX voxelizer takes that
distance by expansion, whose float32 rounding grows with the square of the
coordinates (ROADMAP Queue 3, closed; tests/test_torch_cnn.py), so the
inputs sit within ~20 A of the origin.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.models import registry as jregistry
from gnina_tpu.models import runtime as jruntime
from gnina_tpu.models import scorer as jscorer
from gnina_tpu.ops import voxelize as jvox
from gnina_tpu_torch import convert
from gnina_tpu_torch.models import runtime as truntime
from gnina_tpu_torch.models import scorer as tscorer
from gnina_tpu_torch.ops import voxelize as tvox
from test_torch_cnn import FAST, _OP_CASES, _atoms
from test_torch_cnn_objective import grad_close, load_system, write_system


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ voxelize ----

VOX = dict(num_channels=6, npoints=12, resolution=0.5, radius_scale=1.1)


def _on_nodes(coords, center):
    """The first four atoms moved onto grid nodes (d2 = 0 there)."""
    n, res = VOX["npoints"], VOX["resolution"]
    origin = center - res * (n - 1) / 2
    out = coords.copy()
    for i, node in enumerate([(3, 4, 5), (6, 6, 6), (0, 11, 2), (9, 1, 7)]):
        out[i] = origin + res * np.asarray(node, np.float32)
    return out


@pytest.mark.parametrize("case", ["voxelize", "voxelize_batch", "on_nodes"])
def test_voxelize_coordinate_gradient_matches_jax(case):
    """d(sum w * grid)/d(coords) within 1e-3 of its largest component;
    atoms on grid nodes give finite gradients (the clamp of d2 at 1e-12
    in density_at passes none)."""
    sets = [_atoms(s, a=30, spread=2.5, offset=6.0) for s in (11, 12)]
    if case == "on_nodes":
        sets = [(_on_nodes(c, ctr), ch, r, m, ctr)
                for c, ch, r, m, ctr in sets]
    rng = np.random.default_rng(3)
    w = rng.normal(size=(len(sets), 6, 12, 12, 12)).astype(np.float32)
    want = []
    for (c, ch, r, m, ctr), wi in zip(sets, w):
        def f(x):
            return jnp.sum(wi * jvox.voxelize(
                x, jnp.asarray(ch), jnp.asarray(r), jnp.asarray(m),
                jnp.asarray(ctr), **VOX))
        want.append(np.asarray(jax.grad(f)(jnp.asarray(c))))
    if case == "voxelize":
        got = []
        for (c, ch, r, m, ctr), wi in zip(sets, w):
            x = torch.tensor(c, requires_grad=True)
            g = tvox.voxelize(x, torch.as_tensor(ch), torch.as_tensor(r),
                              torch.as_tensor(m), torch.as_tensor(ctr),
                              **VOX)
            (gx,) = torch.autograd.grad((torch.as_tensor(wi) * g).sum(), x)
            got.append(gx.numpy())
        got = np.stack(got)
    else:
        x = torch.tensor(np.stack([s[0] for s in sets]), requires_grad=True)
        rest = [torch.as_tensor(np.stack([s[i] for s in sets]))
                for i in range(1, 5)]
        g = tvox.voxelize_batch(x, *rest, **VOX)
        (gx,) = torch.autograd.grad((torch.as_tensor(w) * g).sum(), x)
        got = gx.numpy()
    assert np.isfinite(got).all()
    grad_close(got, np.stack(want))


# ------------------------------------------------------------- runtime ----

@pytest.mark.parametrize("case", sorted(_OP_CASES))
def test_runtime_op_input_gradient_matches_jax(case):
    """d(sum w * output)/d(input) of each op kind of runtime.execute on the
    synthetic specs of test_torch_cnn.py: rtol 1e-4 (atol 1e-6 for the
    entries that are zero on one side)."""
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
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out_shape = np.shape(jruntime.execute(spec, jp, jnp.asarray(x))[0])
    w = rng.normal(size=out_shape).astype(np.float32)
    want = jax.grad(lambda xx: jnp.sum(
        w * jruntime.execute(spec, jp, xx)[0]))(jnp.asarray(x))
    mod = truntime.SpecModule(spec, params, device="cpu")
    xt = torch.tensor(x, requires_grad=True)
    (got,) = torch.autograd.grad((torch.as_tensor(w) * mod(xt)[0]).sum(),
                                 xt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-6)


@pytest.fixture(scope="module")
def fast_models():
    j = jregistry.load_model(FAST)
    t = convert.cnn_model_from_numpy(
        j.spec, {k: np.asarray(v) for k, v in j.params.items()}, name=FAST,
        device="cpu")
    return j, t


def test_fast_model_input_gradient_matches_jax(fast_models):
    """The fast model's loss (the scorer's, _pose_from_outputs) plus its
    affinity, differentiated with respect to a sparse non-negative 48^3
    grid of 28 channels: within 1e-3 of the largest component."""
    j, t = fast_models
    rng = np.random.default_rng(1)
    x = (rng.random((1, 28, 48, 48, 48), dtype=np.float32)
         * (rng.random((1, 28, 48, 48, 48)) < 0.05)).astype(np.float32)

    def jf(g):
        out = jruntime.execute(j.spec, j.params, g)
        _p, aff, loss = jscorer._pose_from_outputs(j, out)
        return jnp.sum(loss) + 0.1 * jnp.sum(aff)

    want = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    _p, aff, loss = tscorer._pose_from_outputs(t, t.module(xt))
    (got,) = torch.autograd.grad(loss.sum() + 0.1 * aff.sum(), xt)
    grad_close(got.numpy(), want)


# ------------------------------------------------------------ CNN loss ----

@pytest.fixture(scope="module")
def loss_system(tmp_path_factory):
    return load_system(*write_system(tmp_path_factory.mktemp("grad")))


@pytest.mark.parametrize("kind", ["split", "generic"])
def test_cnn_loss_and_coordinate_gradient_match_jax(loss_system,
                                                    fast_models, kind):
    """make_loss_fn_split (receptor grids prepared at each pose's centre)
    and make_loss_fn_generic on the fast model for 2 poses: the losses
    within 1e-4 relative, their ligand-coordinate gradients within 1e-3
    of the largest component.  make_loss_fn is make_loss_fn_generic with
    the ligand's types bound."""
    j, t = fast_models
    js = jscorer.CNNScorer(["fast"])
    js.models = [j]
    ts = tscorer.CNNScorer(models=[t], device="cpu")
    lig = loss_system["tlig"]
    rng = np.random.default_rng(7)
    poses = (lig.orig_coords[None]
             + rng.normal(scale=0.3, size=(2, 1, 3))).astype(np.float32)
    centers = poses.mean(axis=1)
    rc, rt, rm = ts._receptor_arrays(loss_system["trec"], centers)
    mask = np.ones(lig.num_atoms, bool)
    want_v, want_g = [], []
    for p, c in zip(poses, centers):
        if kind == "split":
            prep, jloss = js.make_loss_fn_split(rc, rt.astype(np.int32), rm)
            grids = prep(jnp.asarray(c))
            f = lambda x: jloss(grids, x, lig.types, mask, jnp.asarray(c))
        else:
            jloss = js.make_loss_fn_generic(rc, rt.astype(np.int32), rm)
            f = lambda x: jloss(x, lig.types, mask, jnp.asarray(c))
        v, g = jax.value_and_grad(f)(jnp.asarray(p))
        want_v.append(float(v))
        want_g.append(np.asarray(g))
    x = torch.tensor(poses, requires_grad=True)
    ct = torch.as_tensor(centers)
    if kind == "split":
        prep, tloss = ts.make_loss_fn_split(rc, rt, rm)
        v = tloss(prep(ct), x, lig.types, mask, ct)
    else:
        v = ts.make_loss_fn_generic(rc, rt, rm)(x, lig.types, mask, ct)
        bound = ts.make_loss_fn(rc, rt, rm, lig.types)(x.detach(), mask, ct)
        np.testing.assert_allclose(bound.numpy(), v.detach().numpy(),
                                   rtol=1e-6)
    (g,) = torch.autograd.grad(v.sum(), x)
    np.testing.assert_allclose(v.detach().numpy(), want_v, rtol=1e-4)
    grad_close(g.numpy(), np.stack(want_g))
