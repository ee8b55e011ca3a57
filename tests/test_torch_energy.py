"""Scoring, FK and the plain energy of the port against the JAX package.

Both sides get the very same inputs: the ligand, receptor and scoring
function are carried over with gnina_tpu_torch.convert, and poses are made
from a numpy seed.  Tolerances are stated at each comparison."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.ops import energy as jenergy
from gnina_tpu.ops import fk as jfk
from gnina_tpu.ops import pallas_dock as jpd
from gnina_tpu.scoring import terms as jterms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import Conf as JConf
from gnina_tpu.types import pad_ligand as jpad_ligand
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.ops import energy as tenergy
from gnina_tpu_torch.ops import fk as tfk
from gnina_tpu_torch.ops import fused_dock as tfd
from gnina_tpu_torch.scoring import terms as tterms
from gnina_tpu_torch.types import Conf as TConf
from gnina_tpu_torch.types import pad_ligand as tpad_ligand
from gnina_tpu_torch.types import pad_receptor as tpad_receptor

N_PAD, M_PAD, P_PAD, K_PAD, LAYERS = 24, 4, 96, 1024, 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_sf(jsf):
    """The JAX scoring function carried over through convert."""
    terms = [(jterms.describe_term(t), w)
             for t, w in zip(jsf.pair_terms, jsf.pair_weights)]
    terms += [(t.name, w) for t, w in zip(jsf.conf_terms, jsf.conf_weights)]
    table = {f.name: getattr(jsf.table, f.name)
             for f in dataclasses.fields(jsf.table)}
    return convert.scoring_from_numpy(jsf.name, terms, table)


def port_ligand(jlig):
    return convert.ligand_from_numpy(
        {f.name: getattr(jlig, f.name) for f in dataclasses.fields(jlig)
         if f.name not in ("mol", "other_pairs", "flex_meta")})


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    center = fx.ligand_center(jlig)
    path = tmp_path_factory.mktemp("rec") / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=2, cube=22.0))
    jrec = jingest.Receptor.from_file(str(path))
    pr = jrec.pruned(center, np.full(3, 6.0), margin=8.0)
    assert len(pr.types) <= K_PAD
    lo = (center - 6.0).astype(np.float32)
    hi = (center + 6.0).astype(np.float32)
    tlig = port_ligand(jlig)
    trec = convert.receptor_from_numpy(pr.coords, pr.types, pr.charges)
    return dict(jlig=jlig, tlig=tlig, pr=pr, trec=trec, lo=lo, hi=hi,
                center=center)


def random_confs(n, lo, hi, t, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tors = rng.uniform(-np.pi, np.pi, (n, t)).astype(np.float32)
    return pos, q, tors


def perturbed_confs(lig, n, t, seed):
    """Small jitters of the crystal pose: energies in the physical range."""
    rng = np.random.default_rng(seed)
    pos = (lig.orig_coords[0][None] + 0.5 * rng.normal(size=(n, 3))
           ).astype(np.float32)
    axis = 0.2 * rng.normal(size=(n, 3))
    ang = np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang],
                       axis=1).astype(np.float32)
    tors = (0.3 * rng.normal(size=(n, t))).astype(np.float32)
    return pos, q, tors


@pytest.mark.parametrize("name", ["vina", "vinardo"])
def test_pair_terms_on_r_grid(name):
    """Every pair term, every type pair, r in [0, 8]: within 1e-5."""
    jsf = jget_sf(name)
    tsf = port_sf(jsf)
    assert len(jsf.pair_terms) == len(tsf.pair_terms)
    types = np.arange(len(jsf.table.xs_radius))
    ta, tb = np.meshgrid(types, types, indexing="ij")
    ta, tb = ta.reshape(-1), tb.reshape(-1)
    r = np.linspace(0.0, 8.0, 161, dtype=np.float32)
    jpa = {k: jnp.asarray(v)[:, None] for k, v in
           jterms.gather_type_params(jsf.table, ta).items()}
    jpb = {k: jnp.asarray(v)[:, None] for k, v in
           jterms.gather_type_params(jsf.table, tb).items()}
    tpa = {k: v[:, None] for k, v in
           tterms.gather_type_params(tsf.table, ta).items()}
    tpb = {k: v[:, None] for k, v in
           tterms.gather_type_params(tsf.table, tb).items()}
    for jt, tt in zip(jsf.pair_terms, tsf.pair_terms):
        assert type(jt).__name__ == type(tt).__name__
        ej = np.asarray(jt.eval(jpa, jpb, jnp.asarray(r)[None, :]))
        et = tt.eval(tpa, tpb, torch.as_tensor(r)[None, :]).numpy()
        np.testing.assert_allclose(et, ej, rtol=1e-5, atol=1e-5,
                                   err_msg=type(jt).__name__)
    np.testing.assert_allclose(
        tsf.conf_independent({"num_tors": 3.0, "num_heavy_atoms": 13.0,
                              "num_hydrophobic_atoms": 6.0,
                              "ligand_lengths_sum": 7.0, "num_ligands": 1.0},
                             np.float32(-9.0)),
        np.asarray(jsf.conf_independent(
            {"num_tors": 3.0, "num_heavy_atoms": 13.0,
             "num_hydrophobic_atoms": 6.0, "ligand_lengths_sum": 7.0,
             "num_ligands": 1.0}, np.float32(-9.0))), rtol=1e-6)


def _pads(system):
    jlig, tlig, pr = system["jlig"], system["tlig"], system["pr"]
    jl = jpad_ligand(jlig, N_PAD, M_PAD, P_PAD)
    tl = tpad_ligand(tlig, N_PAD, M_PAD, P_PAD, device="cpu")
    jr = jpad_receptor(pr.coords, pr.types, pr.charges, K_PAD)
    tr = tpad_receptor(pr.coords, pr.types, pr.charges, K_PAD,
                       device="cpu")
    return jl, tl, jr, tr


def test_pad_ligand_and_receptor_match(system):
    jl, tl, jr, tr = _pads(system)
    for f in tl._fields:
        a, b = getattr(jl, f), getattr(tl, f)
        if torch.is_tensor(b):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=f)
        else:
            assert float(a) == float(b), f
    for f in tr._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jr, f)),
                                      getattr(tr, f).numpy(), err_msg=f)


@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_fk_coords_match(system, kind):
    """fk_coords within 1e-4 A of the JAX FK."""
    jl, tl, _, _ = _pads(system)
    t = M_PAD - 1
    if kind == "random":
        pos, q, tors = random_confs(16, system["lo"], system["hi"], t, 11)
    else:
        pos, q, tors = perturbed_confs(system["jlig"], 16, t, 12)
    cj = jax.vmap(lambda p, o, s: jfk.fk_coords(jl, JConf(p, o, s), LAYERS))(
        pos, q, tors)
    ct = tfk.fk_coords(tl, TConf(torch.as_tensor(pos), torch.as_tensor(q),
                                 torch.as_tensor(tors)), LAYERS)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-4)


@pytest.mark.parametrize("name", ["vina", "vinardo"])
@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_energy_and_gradient_match(system, name, kind):
    """make_energy_fn: value within 1e-4 relative (1e-3 absolute), the
    autograd gradient against jax.grad within 1e-3 relative of the
    gradient's scale (f32 sums over ~600 receptor atoms in another
    order)."""
    jl, tl, jr, tr = _pads(system)
    jsf = jget_sf(name)
    tsf = port_sf(jsf)
    jefn = jenergy.make_energy_fn(jsf, LAYERS)
    tefn = tenergy.make_energy_fn(tsf, LAYERS)
    t = M_PAD - 1
    if kind == "random":
        pos, q, tors = random_confs(12, system["lo"], system["hi"], t, 21)
    else:
        pos, q, tors = perturbed_confs(system["jlig"], 12, t, 22)
    lo, hi = system["lo"], system["hi"]
    jbox = jenergy.Box(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    tbox = tenergy.Box(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi))
    v = np.array([10.0, 10.0, 10.0], np.float32)
    ej, gj = jax.vmap(lambda p, o, s: jefn.eval_deriv(
        jl, jr, JConf(p, o, s), jbox, 1e3, jnp.asarray(v)))(pos, q, tors)
    conf = TConf(torch.as_tensor(pos), torch.as_tensor(q),
                 torch.as_tensor(tors))
    et, gt = tefn.eval_deriv(tl, tr, conf, tbox, 1e3, torch.as_tensor(v))
    ej, gj = np.asarray(ej), np.asarray(gj)
    np.testing.assert_allclose(et.numpy(), ej, rtol=1e-4, atol=1e-3)
    scale = max(1.0, float(np.abs(gj).max()))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-3, atol=1e-3 * scale)
    # the value-only and split paths agree with the JAX ones too
    ev = tefn.eval_energy(tl, tr, conf, tbox, 1e3, torch.as_tensor(v))
    np.testing.assert_allclose(ev.numpy(), ej, rtol=1e-4, atol=1e-3)
    inter_j = jax.vmap(lambda p, o, s: jefn.eval_inter(
        jl, jr, JConf(p, o, s), jbox, 1e3, 1000.0))(pos, q, tors)
    inter_t = tefn.eval_inter(tl, tr, conf, tbox, 1e3, 1000.0)
    np.testing.assert_allclose(inter_t.numpy(), np.asarray(inter_j),
                               rtol=1e-4, atol=1e-3)


def _packs(system, exhaustiveness=3):
    jlig, tlig, pr = system["jlig"], system["tlig"], system["pr"]
    jsf = jget_sf("vina")
    kr = len(pr.types)
    jp = jpd.build_pack([jlig, jlig], pr.coords, pr.types, pr.charges,
                        np.ones(kr, np.float32), exhaustiveness, jsf.table,
                        m_pad=M_PAD)
    tp = tfd.build_pack([tlig, tlig], pr.coords, pr.types,
                        np.ones(kr, np.float32), exhaustiveness,
                        port_sf(jsf).table, m_pad=M_PAD, device="cpu")
    return jp, tp


def test_build_pack_matches_after_transpose(system):
    """The port's pose-major pack (topology once per ligand + lane index)
    holds exactly the JAX lane-minor pack's values."""
    jp, tp = _packs(system)
    n, m, ly, k, lanes = tp.dims
    assert (n, m, ly) == jpd._static_dims(jp)[:3]
    np.testing.assert_array_equal(np.asarray(jp.rec), tp.rec.numpy())
    np.testing.assert_array_equal(jp.heavy_idx, tp.heavy_idx)
    lig = tp.lane_lig.long().numpy()
    assert lanes == 6 and list(lig) == [0, 0, 0, 1, 1, 1]
    g = lig  # the lane's ligand
    np.testing.assert_array_equal(np.transpose(np.asarray(jp.lc)[..., :lanes],
                                               (2, 1, 0)), tp.lc.numpy()[g])
    np.testing.assert_array_equal(np.transpose(np.asarray(jp.ap)[..., :lanes],
                                               (2, 1, 0)), tp.ap.numpy()[g])
    for f in ("relax", "relo"):
        np.testing.assert_array_equal(
            np.transpose(np.asarray(getattr(jp, f))[..., :lanes], (2, 1, 0)),
            getattr(tp, f).numpy()[g], err_msg=f)
    np.testing.assert_array_equal(
        np.transpose(np.asarray(jp.imask)[..., :lanes], (2, 0, 1)),
        tp.imask.numpy()[g])
    np.testing.assert_array_equal(np.asarray(jp.dofmask)[:, :lanes].T,
                                  tp.dofmask.numpy()[g])
    # one-hot tree matrices vs parent / node / layer indices
    nh = tp.nheavy.numpy()[g]
    node = tp.node.numpy()[g]
    nodeoh = np.asarray(jp.nodeoh)[..., :lanes]           # (M, N, L)
    for l in range(lanes):
        want = np.zeros((m, n), np.float32)
        want[node[l, :nh[l]], np.arange(nh[l])] = 1.0
        np.testing.assert_array_equal(nodeoh[..., l], want)
    parent = tp.parent.numpy()[g]
    layer = tp.layer.numpy()[g]
    parentoh = np.asarray(jp.parentoh)[..., :lanes]       # (child, parent, L)
    laymask = np.asarray(jp.laymask)[..., :lanes]         # (LY, M, L)
    for l in range(lanes):
        want = np.zeros((m, m), np.float32)
        kids = np.nonzero(layer[l] > 0)[0]
        want[kids, parent[l, kids]] = 1.0
        np.testing.assert_array_equal(parentoh[..., l], want)
        for y in range(ly):
            np.testing.assert_array_equal(laymask[y, :, l],
                                          (layer[l] == y + 1).astype(
                                              np.float32))


@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_fk_packed_matches(system, kind):
    """fk_packed of the port vs the JAX fk_packed, within 1e-4 A."""
    jp, tp = _packs(system)
    lanes = tp.lanes
    t = M_PAD - 1
    if kind == "random":
        pos, q, tors = random_confs(lanes, system["lo"], system["hi"], t, 31)
    else:
        pos, q, tors = perturbed_confs(system["jlig"], lanes, t, 32)
    jr, jt = jpd.conf_to_packed(JConf(jnp.asarray(pos), jnp.asarray(q),
                                      jnp.asarray(tors)), M_PAD)
    l_pad = jp.lc.shape[-1]
    jr = jnp.pad(jr, ((0, 0), (0, l_pad - lanes)))
    jt = jnp.pad(jt, ((0, 0), (0, l_pad - lanes)))
    cj = np.transpose(np.asarray(jpd.fk_packed(jr, jt, jp))[..., :lanes],
                      (2, 1, 0))
    tr, tt = tfd.conf_to_packed(TConf(torch.as_tensor(pos),
                                      torch.as_tensor(q),
                                      torch.as_tensor(tors)), M_PAD)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[:, :lanes].T)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt)[:, :lanes].T)
    ct = tfd.fk_packed(tr, tt, tp).numpy()
    nh = int(tp.nheavy[0])
    np.testing.assert_allclose(ct[:, :nh], cj[:, :nh], atol=1e-4)
