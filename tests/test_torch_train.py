"""CNN training (gnina_tpu_torch/models/train.py) against the JAX package's
optax step, on the CPU.

Two networks: __graft_entry__._tiny_cnn_spec (8 channels, 8^3 grids, batch
4; its heads are 1,024 features wide) and the default ensemble's
crossdock_default2018_KD_4 at its own 48^3 x 28-channel grids (batch 2),
whose two heads are 27,648 features wide: the weights that "tp" splits.  Grids are random densities from a seed,
labels one good and one poor pose each pair, affinities around 6.

- loss_fn equals JAX's loss_fn within 1e-5 relative;
- one SGD step (learning rate 1e-3, momentum 0.9) from the same
  parameters gives JAX's loss and updated parameters within 1e-5, and two
  steps (the momentum carried) within 1e-5 too;
- a step over a mesh that names the CPU twice, as dp = 2 (the batch split
  in two, the gradients summed) and as tp = 2 (the wide heads split by
  columns), equals the one-device step within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_cnn_spec
from gnina_tpu.models import registry as jregistry
from gnina_tpu.models import train as jtrain
from gnina_tpu.parallel.mesh import make_mesh as jmake_mesh
from gnina_tpu_torch.models import registry as tregistry
from gnina_tpu_torch.models import train as ttrain
from gnina_tpu_torch.models.runtime import normalize_spec
from gnina_tpu_torch.parallel.mesh import Mesh

LR = 1e-3            # train_setup's default in both packages
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _batch(b, nchan, npts, seed=0):
    rng = np.random.RandomState(seed)
    grids = (rng.rand(b, nchan, npts, npts, npts) ** 4).astype(np.float32)
    labels = np.array([1, 0] * (b // 2), np.int32)
    aff = (6.0 + rng.randn(b)).astype(np.float32)
    return grids, labels, aff


@pytest.fixture(scope="module", params=["tiny", "crossdock_KD_4"])
def net(request):
    if request.param == "tiny":
        spec, params = _tiny_cnn_spec(nchan=8, npts=8)
        batch = _batch(4, 8, 8)
    else:
        jm = jregistry.load_model("crossdock_default2018_KD_4")
        tm = tregistry.load_model("crossdock_default2018_KD_4", device="cpu")
        spec = tm.spec
        params = {k: v.numpy().copy() for k, v in tm.module.params().items()}
        for k, v in jm.params.items():
            np.testing.assert_array_equal(params[k], np.asarray(v))
        batch = _batch(2, 28, 48)
        jspec = jm.spec
        return dict(name=request.param, spec=spec, jspec=jspec,
                    params=params, batch=batch)
    return dict(name=request.param, spec=spec, jspec=spec, params=params,
                batch=batch)


@pytest.fixture(scope="module")
def jax_steps(net):
    """JAX's loss at the start and after one and two optax steps."""
    grids, labels, aff = net["batch"]
    params = {k: jnp.asarray(v) for k, v in net["params"].items()}
    loss0 = float(jtrain.loss_fn(net["jspec"], params, jnp.asarray(grids),
                                 jnp.asarray(labels), jnp.asarray(aff)))
    p, opt, step = jtrain.train_setup(jmake_mesh(1), net["jspec"], params,
                                      LR)
    out = []
    for _ in range(2):
        p, opt, loss = step(p, opt, jnp.asarray(grids), jnp.asarray(labels),
                            jnp.asarray(aff))
        # copies: the next step donates (and may reuse) these buffers
        out.append((float(loss), {k: np.array(v, copy=True)
                                  for k, v in p.items()}))
    return loss0, out


def _port_steps(net, mesh, steps=2):
    grids, labels, aff = net["batch"]
    p, opt, step = ttrain.train_setup(mesh, net["spec"], net["params"], LR)
    out = []
    for _ in range(steps):
        p, opt, loss = step(p, opt, torch.as_tensor(grids),
                            torch.as_tensor(labels), torch.as_tensor(aff))
        out.append((float(loss), {k: v.numpy() for k, v in
                                  ttrain.gather_params(p).items()}))
    return p, out


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=TOL, atol=TOL)


def test_loss_equals_jax(net, jax_steps):
    grids, labels, aff = net["batch"]
    params = {k: torch.as_tensor(v) for k, v in net["params"].items()}
    with torch.no_grad():
        got = float(ttrain.loss_fn(
            normalize_spec(net["spec"]),
            params, torch.as_tensor(grids), torch.as_tensor(labels),
            torch.as_tensor(aff)))
    assert got == pytest.approx(jax_steps[0], rel=TOL)


def test_sgd_steps_equal_optax(net, jax_steps):
    _p, port = _port_steps(net, Mesh.of(["cpu"]))
    for (lt, pt), (lj, pj) in zip(port, jax_steps[1]):
        assert lt == pytest.approx(lj, rel=TOL)
        assert set(pt) == set(pj)
        for k in pt:
            _close(pt[k], pj[k])
    # the steps moved the weights
    moved = max(np.abs(port[1][1][k] - net["params"][k]).max()
                for k in port[1][1])
    assert moved > 1e-4


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2)], ids=["dp2", "tp2"])
def test_sharded_step_equals_one_device(net, dp, tp):
    _p1, one = _port_steps(net, Mesh.of(["cpu"]))
    placed, two = _port_steps(net, Mesh.of(["cpu", "cpu"], dp=dp, tp=tp))
    split = [k for k, v in placed.items()
             if isinstance(v, ttrain.ColumnShards)]
    if tp == 2:
        # the heads: 1,024 features wide in the tiny net, 27,648 in KD_4
        assert sorted(split) == (["wa", "wp"] if net["name"] == "tiny"
                                 else ["p0", "p2"])
    for (l1, p1), (l2, p2) in zip(one, two):
        assert l2 == pytest.approx(l1, rel=TOL)
        for k in p1:
            _close(p2[k], p1[k])


def test_param_shardings_rule():
    mesh = Mesh.of(["cpu"] * 4, dp=2, tp=2)
    shapes = {"wide": (2, 27648), "narrow": (2, 224), "odd": (1, 1025),
              "conv": (16, 8, 3, 3, 3), "bias": (2,)}
    params = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    assert ttrain.param_shardings(mesh, params) == {
        "wide": (None, "tp"), "narrow": (), "odd": (), "conv": (),
        "bias": ()}
    jmesh = jmake_mesh(1)
    jsh = jtrain.param_shardings(jmesh, {k: jnp.zeros(s) for k, s in
                                         shapes.items()})
    assert jsh["wide"].spec == jax.sharding.PartitionSpec(None, "tp")
