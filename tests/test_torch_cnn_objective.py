"""The port's CNN objective (DockingEngine._build_cnn_objective) and the
minimisations over it against the JAX package's, on the CPU, with a toy CNN.

The toy model (_fixtures.toy_cnn: one 3^3 convolution, relu, a max pool,
the pose and affinity heads, on the default typers' 28 channels at 13^3
points 1 A apart) is made from one numpy seed and placed on both sides: a
JAX CNNModel in a JAX CNNScorer's models, and the port's through
convert.cnn_model_from_numpy.  The system is the minout.sdf ligand moved so
that its heavy centroid sits at the origin, in a synthetic receptor around
it: the JAX voxelizer takes squared distances by expansion, good to 1e-4
only within ~30 A of the origin (tests/test_torch_cnn.py).

Bounds: objective values within 1e-4 relative, DOF gradients within 1e-3 of
their largest component; the minimisations (a few BFGS iterations, whose
float32 trajectories part slowly) within 1e-3 of JAX's objective.  The JAX
functions run un-jitted where they can; the stage program is JAX's own
jitted stage_fn_xla.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu.models import registry as jregistry
from gnina_tpu.models import scorer as jscorer
from gnina_tpu.models.typer import ChannelTyper as JTyper, DEFAULT_LIGMAP, \
    DEFAULT_RECMAP
from gnina_tpu.ops import fk as jfk
from gnina_tpu.ops.bfgs import MinimizeParams as JMinimizeParams
from gnina_tpu.types import Conf as JConf
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch import docking as tdocking
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.models import scorer as tscorer
from gnina_tpu_torch.ops import fk as tfk
from gnina_tpu_torch.ops.bfgs import MinimizeParams
from gnina_tpu_torch.ops.energy import lane_ligands
from gnina_tpu_torch.types import Conf as TConf

BOX = 10.0
SLOPE = 10.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ shared helpers ----

def toy_scorers(seed: int = 0):
    """(JAX CNNScorer, port CNNScorer) over the same toy model."""
    spec, params = fx.toy_cnn(seed)
    meta = spec["metadata"]
    jm = jregistry.CNNModel(
        name="toy", spec=spec,
        params={k: jnp.asarray(v) for k, v in params.items()},
        rec_typer=JTyper(DEFAULT_RECMAP), lig_typer=JTyper(DEFAULT_LIGMAP),
        resolution=meta["resolution"], dimension=meta["dimension"],
        radius_scale=1.0, skip_softmax=False, apply_logistic_loss=False)
    js = jscorer.CNNScorer(["fast"])
    js.models = [jm]
    tm = convert.cnn_model_from_numpy(spec, params, name="toy", device="cpu")
    return js, tscorer.CNNScorer(models=[tm], device="cpu")


def write_system(directory, seed: int = 2, cube: float = 16.0):
    """The first minout.sdf record moved so that its heavy centroid lies at
    the origin, and a synthetic receptor around it: (ligand path,
    receptor path)."""
    text = open(fx.LIGAND_SDF).read().split("$$$$\n")[0] + "$$$$\n"
    shift = fx.ligand_center(fx.ligand())
    lines = text.splitlines()
    na = int(lines[3][:3])
    for i in range(4, 4 + na):
        xyz = [float(lines[i][10 * k:10 * k + 10]) - shift[k]
               for k in range(3)]
        lines[i] = "".join(f"{v:10.4f}" for v in xyz) + lines[i][30:]
    lig_path = str(directory / "lig.sdf")
    rec_path = str(directory / "rec.pdb")
    with open(lig_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(rec_path, "w") as f:
        f.write(fx.receptor_pdb_text(np.zeros(3), seed=seed, cube=cube))
    return lig_path, rec_path


def load_system(lig_path, rec_path):
    return dict(jlig=next(jingest.iter_ligands(lig_path)),
                tlig=next(tingest.iter_ligands(lig_path)),
                jrec=jingest.Receptor.from_file(rec_path),
                trec=tingest.Receptor.from_file(rec_path),
                center=np.zeros(3, np.float32),
                size=np.full(3, BOX, np.float32))


def random_confs(lig, t: int, b: int, seed: int, spread: float = 0.8):
    """b numpy confs (position, quaternion, torsions (b, t)) around the
    input pose; the last one 4 A along x, partly outside the box."""
    rng = np.random.default_rng(seed)
    pos = lig.orig_coords[0][None] + spread * rng.normal(size=(b, 3))
    pos[-1, 0] += 4.0
    axis = 0.4 * rng.normal(size=(b, 3))
    ang = np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang], 1)
    tors = 0.5 * rng.normal(size=(b, t))
    tors[:, lig.num_torsions:] = 0.0
    return [np.asarray(a, np.float32) for a in (pos, q, tors)]


def engines(system, scorers, **kw):
    js, ts = scorers
    je = JEngine(JSettings(**kw), cnn_scorer=js)
    te = DockingEngine(DockSettings(**kw), cnn_scorer=ts, device="cpu")
    jl, jr, jbox, layers, _ = je._prepare(system["jrec"], system["jlig"],
                                          system["center"], system["size"])
    tl, tr, tbox, tlayers = te._prepare(system["trec"], system["tlig"],
                                        system["center"], system["size"])
    assert layers == tlayers
    return dict(je=je, te=te, jl=jl, jr=jr, jbox=jbox, tl=tl, tr=tr,
                tbox=tbox, layers=layers,
                jobj=je._build_cnn_objective(system["jrec"], jbox, layers),
                tobj=te._build_cnn_objective(system["trec"], tbox, layers))


def grad_close(got, want, frac=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * scale)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    return load_system(*write_system(tmp_path_factory.mktemp("cnn_obj")))


@pytest.fixture(scope="module")
def scorers():
    return toy_scorers(0)


# ---------------------------------------------------------- objective ----

MIXES = {"off": {}, "force": dict(cnn_mix_emp_force=True),
         "energy": dict(cnn_mix_emp_energy=True),
         "both": dict(cnn_mix_emp_force=True, cnn_mix_emp_energy=True)}


@pytest.mark.parametrize("mix", list(MIXES))
def test_objective_matches_jax(system, scorers, mix):
    """center_of, value_p, deriv_p and value_on_coords at 3 random confs
    (one partly out of the box), the mix at weight 0.5: centres within
    1e-5 A, values 1e-4 relative, DOF gradients 1e-3 of the largest
    component.  value and deriv (grids prepared inside) equal value_p and
    deriv_p on prepared grids, and value_p on a subset of rows equals
    those rows."""
    e = engines(system, scorers, cnn_scoring="refinement",
                cnn_empirical_weight=0.5, **MIXES[mix])
    jl, tl, layers = e["jl"], e["tl"], e["layers"]
    t = jl.num_torsion_slots
    pos, q, tors = random_confs(system["tlig"], t, 3, seed=4)
    jo, to = e["jobj"], e["tobj"]
    want = []
    for i in range(3):
        c = JConf(jnp.asarray(pos[i]), jnp.asarray(q[i]), jnp.asarray(tors[i]))
        cen = jo["center_of"](jl, c)
        g = jo["prep"](cen)
        v, dv = jo["deriv_p"](g, jl, c, cen, SLOPE)
        want.append([np.asarray(x) for x in (
            cen, jo["value_p"](g, jl, c, cen, SLOPE), v, dv,
            jo["value_on_coords"](jl, jfk.fk_coords(jl, c, layers), SLOPE))])
    cen_w, val_w, dval_w, grad_w, metro_w = (np.stack([w[k] for w in want])
                                             for k in range(5))
    lig = lane_ligands([tl], torch.zeros(3, dtype=torch.long))
    conf = TConf(*[torch.as_tensor(x) for x in (pos, q, tors)])
    with torch.no_grad():
        cen = to["center_of"](lig, conf)
        g = to["prep"](cen)
        val = to["value_p"](g, lig, conf, cen, SLOPE)
        metro = to["value_on_coords"](lig, tfk.fk_coords(lig, conf, layers),
                                      SLOPE)
        sub = to["value_p"](g, lig, TConf(*[x[[2, 0]] for x in conf]), cen,
                            SLOPE, torch.tensor([2, 0]))
        whole = to["value"](lig, conf, cen, SLOPE)
    dval, grad = to["deriv_p"](g, lig, conf, cen, SLOPE)
    dval2, grad2 = to["deriv"](lig, conf, cen, SLOPE)
    np.testing.assert_allclose(cen.numpy(), cen_w, rtol=0, atol=1e-5)
    np.testing.assert_allclose(val.numpy(), val_w, rtol=1e-4)
    np.testing.assert_allclose(dval.numpy(), dval_w, rtol=1e-4)
    np.testing.assert_allclose(metro.numpy(), metro_w, rtol=1e-4)
    grad_close(grad.numpy(), grad_w)
    np.testing.assert_allclose(sub.numpy(), val.numpy()[[2, 0]], rtol=1e-6)
    np.testing.assert_allclose(whole.numpy(), val.numpy(), rtol=1e-6)
    np.testing.assert_allclose(dval2.numpy(), dval.numpy(), rtol=1e-6)
    np.testing.assert_allclose(grad2.numpy(), grad.numpy(), rtol=1e-5,
                               atol=1e-7)
    # the out-of-box conf pays the box penalty; the mix moves what it says
    assert val_w[2] > val_w[:2].max()
    if mix in ("energy", "both"):
        assert not np.allclose(val.numpy(), metro.numpy(), rtol=1e-3)


# --------------------------------------------------------- _cnn_refine ----

def test_cnn_refine_matches_jax(system, scorers, monkeypatch):
    """_cnn_refine from the same start (4 accurate-line-search iterations a
    stage): each stage's BFGS ends no higher than it started (restore if
    not improved), and the final objective, at the fixed centre and the
    first stage's slope, lies within 1e-3 of JAX's."""
    e = engines(system, scorers, cnn_scoring="refinement")
    jl, tl, layers = e["jl"], e["tl"], e["layers"]
    t = jl.num_torsion_slots
    pos, q, tors = random_confs(system["tlig"], t, 1, seed=9, spread=0.5)
    pos[0, 0] -= 4.0      # back inside the box
    jpar = JMinimizeParams(maxiters=4, type="accurate")
    c0 = JConf(jnp.asarray(pos[0]), jnp.asarray(q[0]), jnp.asarray(tors[0]))
    jc = e["je"]._cnn_refine(e["jobj"], jl, c0, e["jbox"], jpar, layers)
    jcen = e["jobj"]["center_of"](jl, c0)
    jv = float(e["jobj"]["value_p"](e["jobj"]["prep"](jcen), jl, jc, jcen,
                                    SLOPE))

    stages = []
    real = tdocking.bfgs

    def spy(f, x0, params, *a, **kw):
        res = real(f, x0, params, *a, **kw)
        stages.append((float(f(x0)[0][0]), float(res.f0[0])))
        return res

    monkeypatch.setattr(tdocking, "bfgs", spy)
    lig = lane_ligands([tl], torch.zeros(1, dtype=torch.long))
    conf = TConf(*[torch.as_tensor(x) for x in (pos, q, tors)])
    with torch.no_grad():
        tc = e["te"]._cnn_refine(e["tobj"], lig, conf, e["tbox"],
                                 MinimizeParams(maxiters=4, type="accurate"),
                                 layers)
        cen = e["tobj"]["center_of"](lig, conf)
        tv = float(e["tobj"]["value_p"](e["tobj"]["prep"](cen), lig, tc,
                                        cen, SLOPE)[0])
    assert stages and all(end <= start + 1e-6 for start, end in stages)
    assert stages[-1][1] < stages[0][0]
    assert abs(tv - jv) <= 1e-3, (tv, jv)


def test_minimize_under_refinement_matches_jax(system, scorers):
    """minimize with cnn_scoring='refinement' (6 accurate-line-search
    iterations a stage): the energy and the CNN loss of the minimised pose
    within 1e-3 of JAX's."""
    js, ts = scorers
    kw = dict(cnn_scoring="refinement", minimize_iters=6)
    jr = JEngine(JSettings(**kw), cnn_scorer=js).minimize(system["jrec"],
                                                          system["jlig"])
    tr = DockingEngine(DockSettings(**kw), cnn_scorer=ts,
                       device="cpu").minimize(system["trec"], system["tlig"])
    assert abs(tr.energy - jr.energy) <= 1e-3, (tr.energy, jr.energy)
    tl = ts.score_poses(system["trec"], system["tlig"], tr.coords)[2]
    jl = ts.score_poses(system["trec"], system["tlig"], jr.coords)[2]
    l0 = ts.score_poses(system["trec"], system["tlig"],
                        system["tlig"].orig_coords)[2]
    assert abs(float(tl[0]) - float(jl[0])) <= 1e-3, (tl, jl)
    assert float(tl[0]) < float(l0[0])
    assert abs(tr.cnnscore - jr.cnnscore) <= 1e-3


# ------------------------------------------------------------- stages ----

def test_cnn_stages_match_stage_fn_xla(system, scorers):
    """The CNN refinement branch of _stages against JAX's stage_fn_xla
    (its five stages called as dock_batch calls them) on the same 3 saved
    poses, one partly outside the box, 3 BFGS iterations a stage: the
    refined poses' CNN objective (each at its own final heavy centroid,
    slope 10) within 1e-3 of JAX's, the poses within 2e-2 A."""
    e = engines(system, scorers, cnn_scoring="refinement", minimize_iters=3)
    jl, tl, layers = e["jl"], e["tl"], e["layers"]
    t = jl.num_torsion_slots
    pos, q, tors = random_confs(system["tlig"], t, 3, seed=5)
    je, jbox = e["je"], e["jbox"]
    _, _, (_, stage_fn, _) = je._build_dock_program(
        layers, 8, 3, 3, e["jobj"], True, True, False, False)
    mconf = JConf(*[jnp.asarray(x)[None] for x in (pos, q, tors)])
    mdone = jnp.zeros((1, 3), bool)
    lig_batch = jax.tree_util.tree_map(lambda x: x[None], jl)
    for i in range(5):
        mconf, mdone = stage_fn(mconf, mdone, lig_batch, e["jr"], jbox.lo,
                                jbox.hi, jnp.float32(10.0 ** (i + 1)))
    want = [np.array(x)[0] for x in mconf]

    te = e["te"]
    lig = lane_ligands([tl], torch.zeros(3, dtype=torch.long))
    with torch.no_grad():
        got = te._stages(te._make_efn(layers), lig, e["tr"], e["tbox"],
                         MinimizeParams(maxiters=3), [1000.0] * 3,
                         TConf(*[torch.as_tensor(x) for x in (pos, q, tors)]),
                         e["tobj"])
        wconf = TConf(*[torch.as_tensor(x) for x in want])
        obj = e["tobj"]
        vals = [obj["value"](lig, c, obj["center_of"](lig, c), SLOPE)
                for c in (got, wconf)]
        xyz = [tfk.fk_coords(lig, c, layers) for c in (got, wconf)]
    np.testing.assert_allclose(vals[0].numpy(), vals[1].numpy(), rtol=0,
                               atol=1e-3)
    assert float((xyz[0] - xyz[1]).abs().max()) <= 2e-2
    # the pose that started partly outside the box was pulled toward it
    start = TConf(*[torch.as_tensor(x) for x in (pos, q, tors)])
    with torch.no_grad():
        v0 = obj["value"](lig, start, obj["center_of"](lig, start), SLOPE)
    assert float(vals[0][2]) < float(v0[2])
