"""The general path's minimiser and the engine entry points built on it
(ops/bfgs.py; DockingEngine.minimize, term_values, score_only, randomize;
scoring/atom_terms.py and output.py) against the JAX package on the same
inputs: the in-repo ligand in a synthetic receptor made from a seed.

Tolerances are stated at each check.  The JAX side runs jitted on the CPU;
its programs compile once per module (fixtures).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu import output as joutput
from gnina_tpu.chem import ingest as jingest
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu.ops import bfgs as jbfgs
from gnina_tpu.ops import energy as jenergy
from gnina_tpu.ops import fk as jfk
from gnina_tpu.scoring import atom_terms as jatom
from gnina_tpu.scoring import terms as jterms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import Conf as JConf
from gnina_tpu.types import pad_ligand as jpad_ligand
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import output as toutput
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine as TEngine
from gnina_tpu_torch.docking import DockSettings as TSettings
from gnina_tpu_torch.ops import bfgs as tbfgs
from gnina_tpu_torch.ops import energy as tenergy
from gnina_tpu_torch.ops import mc as tmc
from gnina_tpu_torch.scoring import atom_terms as tatom
from gnina_tpu_torch.scoring import terms as tterms
from gnina_tpu_torch.scoring.builtin import get_scoring_function as tget_sf
from gnina_tpu_torch.types import Conf as TConf
from gnina_tpu_torch.types import pad_ligand as tpad_ligand
from gnina_tpu_torch.types import pad_receptor as tpad_receptor

N_PAD, M_PAD, P_PAD, K_PAD, LAYERS = 24, 4, 96, 768, 4
B = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("min")
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    tlig = next(tingest.iter_ligands(fx.LIGAND_SDF))
    center = fx.ligand_center(tlig)
    rec_path = d / "rec.pdb"
    rec_path.write_text(fx.receptor_pdb_text(center, seed=4, cube=22.0))
    jrec = jingest.Receptor.from_file(str(rec_path))
    trec = tingest.Receptor.from_file(str(rec_path))
    pr = jrec.pruned(center, np.full(3, 6.0), margin=8.0)
    lo = (center - 6.0).astype(np.float32)
    hi = (center + 6.0).astype(np.float32)
    jl = jpad_ligand(jlig, N_PAD, M_PAD, P_PAD)
    jr = jpad_receptor(pr.coords, pr.types, pr.charges, K_PAD)
    tl = tpad_ligand(tlig, N_PAD, M_PAD, P_PAD, device="cpu")
    tr = tpad_receptor(pr.coords, pr.types, pr.charges, K_PAD, device="cpu")
    jefn = jenergy.make_energy_fn(jget_sf("vina"), LAYERS)
    tefn = tenergy.make_energy_fn(tget_sf("vina"), LAYERS)
    jbox = jenergy.Box(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    tbox = tenergy.Box(lo=torch.as_tensor(lo), hi=torch.as_tensor(hi))
    v = [10.0, 10.0, 10.0]
    jv = jnp.asarray(v, jnp.float32)
    slope = 1e3

    def jf(c):
        return jefn.eval_deriv(jl, jr, c, jbox, slope, jv)

    def jfv(c):
        return jefn.eval_energy(jl, jr, c, jbox, slope, jv)

    def tf(c):
        return tefn.eval_deriv(tl, tr, c, tbox, slope, v)

    def tfv(c):
        with torch.no_grad():
            return tefn.eval_energy(tl, tr, c, tbox, slope, v)

    return dict(jlig=jlig, tlig=tlig, jrec=jrec, trec=trec, lo=lo, hi=hi,
                jf=jf, jfv=jfv, tf=tf, tfv=tfv, jl=jl, tl=tl, dir=d,
                mask=np.arange(6 + M_PAD - 1) < 6 + tlig.num_torsions)


def confs(system, seed):
    """B small jitters of the crystal pose (numpy seed), for both sides."""
    rng = np.random.default_rng(seed)
    pos = system["tlig"].orig_coords[0][None] + 0.5 * rng.normal(size=(B, 3))
    axis = 0.2 * rng.normal(size=(B, 3))
    ang = np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang], 1)
    tors = 0.3 * rng.normal(size=(B, M_PAD - 1))
    a = [x.astype(np.float32) for x in (pos, q, tors)]
    return (JConf(*[jnp.asarray(x) for x in a]),
            TConf(*[torch.as_tensor(x) for x in a]))


def direction(system, jc):
    """Steepest descent from the JAX gradient, masked: one p for both."""
    if "jf_jit" not in system:
        system["jf_jit"] = jax.jit(jax.vmap(system["jf"]))
    f0, g = system["jf_jit"](jc)
    g = np.where(system["mask"], np.asarray(g), 0.0).astype(np.float32)
    return np.asarray(f0), g, -g


# -------------------------------------------------------- ops/bfgs.py ----

def test_energy_and_gradient_agree(system):
    """The objective both minimisers see: value within rtol 1e-4 / atol
    1e-3, gradient within rtol 1e-3 / atol 1e-2 (float32 sums in another
    order)."""
    jc, tc = confs(system, 1)
    f0, g, _ = direction(system, jc)
    tf0, tg = system["tf"](tc)
    np.testing.assert_allclose(tf0.numpy(), f0, rtol=1e-4, atol=1e-3)
    tg = np.where(system["mask"], tg.numpy(), 0.0)
    np.testing.assert_allclose(tg, g, rtol=1e-3, atol=1e-2)


@pytest.mark.parametrize("which", ["fast", "accurate"])
def test_line_search_matches_jax(system, which):
    """From the same point along the same direction: alpha equal (fast:
    exactly, a power of 0.5; accurate: rtol 1e-3, it interpolates on
    float32 energies), f1 within 1e-4 relative / 1e-3 absolute, the new
    position within 1e-4 A."""
    jc, tc = confs(system, 2)
    f0, g, p = direction(system, jc)
    jls = getattr(jbfgs, f"{which}_line_search")
    tls = getattr(tbfgs, f"{which}_line_search")
    jr = jax.jit(jax.vmap(
        lambda c, gg, ff, pp: jls(system["jfv"], c, gg, ff, pp)))(
        jc, jnp.asarray(g), jnp.asarray(f0), jnp.asarray(p))
    tr = tls(system["tfv"], tc, torch.as_tensor(g.copy()),
             torch.as_tensor(f0.copy()), torch.as_tensor(p.copy()))
    if which == "fast":
        np.testing.assert_array_equal(tr.alpha.numpy(), np.asarray(jr.alpha))
    else:
        np.testing.assert_allclose(tr.alpha.numpy(), np.asarray(jr.alpha),
                                   rtol=1e-3)
    np.testing.assert_allclose(tr.f1.numpy(), np.asarray(jr.f1), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(tr.x_new.position.numpy(),
                               np.asarray(jr.x_new.position), atol=1e-4)


@pytest.mark.parametrize("which", ["fast", "accurate"])
def test_bfgs_three_iterations_match_jax(system, which):
    """Three iterations of bfgs on the same energy function.  Fast line
    search (alphas are powers of 0.5, so both sides take the same steps):
    energy within rtol 1e-4 / atol 2e-3, position within 1e-3 A.  Accurate
    line search (alpha is interpolated from float32 energies, so the steps
    differ in their last digits and the next iteration amplifies that):
    energy within rtol 1e-3 / atol 5e-3 (measured 3.5e-3), position within
    5e-3 A."""
    jc, tc = confs(system, 3)
    jpar = jbfgs.MinimizeParams(maxiters=3, type=which, fused_trials=False)
    tpar = tbfgs.MinimizeParams(maxiters=3, type=which)
    jmask = jnp.asarray(system["mask"])
    jres = jax.jit(jax.vmap(lambda c: jbfgs.bfgs(
        system["jf"], c, jpar, jmask, f_val=system["jfv"])))(jc)
    tres = tbfgs.bfgs(system["tf"], tc, tpar, torch.as_tensor(system["mask"]),
                      f_val=system["tfv"])
    rtol, atol, xtol = ((1e-4, 2e-3, 1e-3) if which == "fast"
                        else (1e-3, 5e-3, 5e-3))
    np.testing.assert_allclose(tres.f0.numpy(), np.asarray(jres.f0),
                               rtol=rtol, atol=atol)
    np.testing.assert_allclose(tres.x.position.numpy(),
                               np.asarray(jres.x.position), atol=xtol)
    # descent, and the restore-if-not-improved guard
    f0 = system["tfv"](tc)
    assert (tres.f0 <= f0 + 1e-6).all()


def test_bfgs_early_term_and_frozen_poses(system):
    """early_term stops a pose whose energy moved by less than 1e-5; a pose
    with every DOF masked comes back unchanged with its start energy."""
    _, tc = confs(system, 4)
    none = torch.zeros(6 + M_PAD - 1, dtype=torch.bool)
    res = tbfgs.bfgs(system["tf"], tc, tbfgs.MinimizeParams(maxiters=4),
                     none, f_val=system["tfv"])
    assert torch.equal(res.x.position, tc.position)
    assert torch.equal(res.f0, system["tfv"](tc))
    par = tbfgs.MinimizeParams(maxiters=30, early_term=True)
    a = tbfgs.bfgs(system["tf"], tc, par, torch.as_tensor(system["mask"]),
                   f_val=system["tfv"])
    assert (a.f0 <= system["tfv"](tc)).all()
    # type "simple" is the legacy steepest descent (ops/ssd.py)
    from gnina_tpu_torch.ops.ssd import SSDParams, ssd

    simple = tbfgs.bfgs(system["tf"], tc, tbfgs.MinimizeParams(
        maxiters=5, type="simple"))
    direct = ssd(system["tf"], tc, SSDParams(evals=5))
    assert torch.equal(simple.f0, direct.f0)
    assert all(torch.equal(x, y) for x, y in zip(simple.x, direct.x))
    row = tbfgs._conf_store(tc)
    back = tbfgs.conf_unstore(row, M_PAD - 1)
    assert all(torch.equal(x, y) for x, y in zip(back, tc))
    flat = tbfgs.flatten_conf(tc)
    jflat = jax.vmap(jbfgs.flatten_conf)(confs(system, 4)[0])
    np.testing.assert_allclose(flat.numpy(), np.asarray(jflat), atol=1e-5)


# ------------------------------------------------------ engine, end to end ----

@pytest.fixture(scope="module")
def engines(system):
    def pair(**kw):
        return (JEngine(JSettings(cnn_scoring="none", **kw)),
                TEngine(TSettings(cnn_scoring="none", **kw), device="cpu"))

    return pair


def test_score_only_and_term_values_match_jax(system, engines):
    """--score_only: affinity and intramolecular energy within 1e-3
    kcal/mol; the unweighted term values within 1e-3 relative."""
    je, te = engines()
    jr = je.score_only(system["jrec"], system["jlig"])
    tr = te.score_only(system["trec"], system["tlig"])
    assert abs(tr.energy - jr.energy) <= 1e-3
    assert abs(tr.intramol - jr.intramol) <= 1e-3
    np.testing.assert_allclose(tr.coords, jr.coords, atol=1e-4)
    jv = je.term_values(system["jrec"], system["jlig"])
    tv = te.term_values(system["trec"], system["tlig"])
    assert len(tv) == len(jv) == 5
    np.testing.assert_allclose(tv, jv, rtol=1e-3, atol=1e-3)


def test_local_only_few_iterations_match_jax(system, engines):
    """--local_only at 3 iterations (fast line search) in each of the five
    slope stages, 15 iterations in all: affinity within 1e-3 kcal/mol,
    intramolecular energy within 3e-3 (measured 1.5e-3: it is steep in the
    torsions), RMSD within 1e-3 A, coordinates 2e-3 A."""
    je, te = engines(local_only=True, minimize_iters=3)
    jr = je.minimize(system["jrec"], system["jlig"])
    tr = te.minimize(system["trec"], system["tlig"])
    assert abs(tr.energy - jr.energy) <= 1e-3
    assert abs(tr.intramol - jr.intramol) <= 3e-3
    assert abs(tr.rmsd - jr.rmsd) <= 1e-3
    np.testing.assert_allclose(tr.coords, jr.coords, atol=2e-3)
    assert tr.within_box == jr.within_box


def test_converged_minimize_matches_jax_loosely(system, engines):
    """--minimize (accurate line search to convergence, force cap 10): two
    float32 searches of some hundred iterations end in the same basin but
    not at the same point: energy within 0.05 kcal/mol, RMSD within 0.1 A
    (measured 1.4e-3 and 1.0e-2)."""
    je, te = engines(forcecap=10.0)
    jr = je.minimize(system["jrec"], system["jlig"])
    tr = te.minimize(system["trec"], system["tlig"])
    assert abs(tr.energy - jr.energy) <= 0.05
    assert abs(tr.rmsd - jr.rmsd) <= 0.1
    assert tr.energy <= te.score_only(system["trec"],
                                      system["tlig"]).energy + 1e-3


def test_unported_minimizers_raise(system, tmp_path):
    """Every minimizer variant runs (none is left to port): the testing
    minimizers (general path): simple_ascent minimises by the steepest
    descent, minimize_single_full leaves --minimize as it is; the
    minimization trajectory (--outputmin 2, 20 iterations) holds to JAX's:
    3 frames a step, the frames of the first four steps within 1e-3 A (two
    float32 codes of the accurate line search part further with every
    step); and the CNN refinement (cnn_scoring='refinement' with a scorer,
    the toy CNN of test_torch_cnn_objective.py, 6 iterations a stage)
    holds to JAX's: the energy and the minimised pose's CNN loss within
    1e-3, on that file's system near the origin (the JAX voxelizer's
    expanded squared distances part from the port's by 1e-4 at this
    file's 40 A, and 6 iterations of a CNN minimisation magnify that)."""
    base = TEngine(TSettings(cnn_scoring="none", minimize_iters=20),
                   device="cpu").minimize(system["trec"], system["tlig"])
    for kw in (dict(simple_ascent=True), dict(minimize_single_full=True)):
        te = TEngine(TSettings(cnn_scoring="none", minimize_iters=20, **kw),
                     device="cpu")
        r = te.minimize(system["trec"], system["tlig"])
        assert np.isfinite(r.energy)
        assert (r.energy == base.energy) == ("minimize_single_full" in kw)
    kw = dict(cnn_scoring="none", minimize_iters=20, outputmin_frames=2)
    tt = TEngine(TSettings(**kw), device="cpu").minimize_trajectory(
        system["trec"], system["tlig"])
    jt = JEngine(JSettings(**kw)).minimize_trajectory(system["jrec"],
                                                      system["jlig"])
    assert len(tt) % 3 == 0 and len(jt) % 3 == 0 and len(tt) >= 12
    np.testing.assert_allclose(tt[:12], jt[:12], rtol=0, atol=1e-3)
    from test_torch_cnn_objective import load_system, toy_scorers, \
        write_system

    near = load_system(*write_system(tmp_path))
    js, ts = toy_scorers(0)
    kw = dict(cnn_scoring="refinement", minimize_iters=6)
    tr = TEngine(TSettings(**kw), cnn_scorer=ts, device="cpu").minimize(
        near["trec"], near["tlig"])
    jr = JEngine(JSettings(**kw), cnn_scorer=js).minimize(near["jrec"],
                                                          near["jlig"])
    assert abs(tr.energy - jr.energy) <= 1e-3, (tr.energy, jr.energy)
    loss = [float(ts.score_poses(near["trec"], near["tlig"], c)[2][0])
            for c in (tr.coords, jr.coords, near["tlig"].orig_coords)]
    assert abs(loss[0] - loss[1]) <= 1e-3, loss
    assert loss[0] < loss[2]


def test_randomize_on_supplied_draws(system, engines):
    """--randomize_only: the port's draws come from a torch.Generator, JAX's
    from its keys, so the draws are supplied: the same generator state
    gives the confs, their clash penalty is recomputed with the JAX FK and
    the reference formula (model.cpp:1173-1201), and the engine must return
    the conf of least penalty.  Penalty within 1e-4, coordinates 1e-4 A."""
    je, te = engines()
    center = fx.ligand_center(system["tlig"])
    size = np.full(3, 12.0, np.float32)
    gen = torch.Generator().manual_seed(5)
    res = te.randomize(system["trec"], system["tlig"], center, size,
                       generator=gen, attempts=20)
    lo, hi = center - 6.0, center + 6.0
    gen = torch.Generator().manual_seed(5)
    pos, quat, tors = tmc.randomize_conf(20, lo, hi, M_PAD - 1, gen,
                                         device="cpu")
    jl = system["jl"]
    coords = np.asarray(jax.vmap(lambda p, q, t: jfk.fk_coords(
        jl, JConf(p, q, t), LAYERS))(jnp.asarray(pos.numpy()),
                                     jnp.asarray(quat.numpy()),
                                     jnp.asarray(tors.numpy())))
    pa, pb = np.asarray(jl.pair_a), np.asarray(jl.pair_b)
    cov = np.asarray(je.sf.table.covalent_radius)[np.asarray(jl.types)]
    r = np.linalg.norm(coords[:, pa] - coords[:, pb], axis=-1)
    x = r / np.maximum(cov[pa] + cov[pb], 1e-6)
    pen = np.where(x > 2.0, 0.0, 1.0 - x * x / 4.0)
    pen = np.where(np.asarray(jl.pair_mask), pen, 0.0).sum(-1)
    best = int(np.argmin(pen))
    assert abs(res.energy - pen[best]) <= 1e-4
    np.testing.assert_allclose(res.coords,
                               coords[best, :system["tlig"].num_atoms],
                               atol=1e-4)
    assert res.cnnscore == -1.0
    # seeded: the same seed gives the same pose, another seed another
    a = te.randomize(system["trec"], system["tlig"], center, size, seed=3)
    b = te.randomize(system["trec"], system["tlig"], center, size, seed=3)
    c = te.randomize(system["trec"], system["tlig"], center, size, seed=4)
    assert np.array_equal(a.coords, b.coords)
    assert not np.array_equal(a.coords, c.coords)


# ------------------------------------------------------------ reports ----

def _pose_results(system, engines, mod):
    """The same three poses as PoseResults of either package."""
    je, te = engines()
    base = te.score_only(system["trec"], system["tlig"])
    rng = np.random.default_rng(6)
    out = []
    for i in range(3):
        out.append(mod.PoseResult(
            energy=-5.0 - i, intramol=0.25 * i, cnnscore=0.9 - 0.1 * i,
            cnnaffinity=5.0 + i, cnnvariance=0.01 * i,
            coords=(base.coords + 0.1 * rng.normal(size=base.coords.shape)
                    ).astype(np.float32),
            conf_position=base.conf_position,
            conf_orientation=base.conf_orientation,
            conf_torsions=base.conf_torsions, rmsd=1.5 if i == 1 else -1.0))
    return out


@pytest.mark.parametrize("cnn_enabled", [False, True])
def test_writers_equal_jax_text(system, engines, cnn_enabled):
    """SDF and PDBQT pose text, and the properties, equal the JAX writers'
    character for character on the same PoseResults."""
    import gnina_tpu.docking as jd
    import gnina_tpu_torch.docking as td

    jres = _pose_results(system, engines, jd)
    tres = _pose_results(system, engines, td)
    assert (toutput.pose_properties(tres[1], cnn_enabled)
            == joutput.pose_properties(jres[1], cnn_enabled))
    jt = joutput.write_poses_sdf(system["jlig"], jres, cnn_enabled)
    tt = toutput.write_poses_sdf(system["tlig"], tres, cnn_enabled)
    assert tt == jt and tt.count("$$$$") == 3
    assert "minimizedAffinity" in tt and ("CNNscore" in tt) == cnn_enabled
    jp = joutput.write_poses_pdbqt(system["jlig"], jres, cnn_enabled)
    tp = toutput.write_poses_pdbqt(system["tlig"], tres, cnn_enabled)
    assert tp == jp and tp.count("ENDMDL") == 3
    # no flex residues: no flex PDB, as in the JAX package
    assert toutput.write_flex_pdb(system["tlig"], tres) == \
        joutput.write_flex_pdb(system["jlig"], jres) == ""


def test_atom_terms_table_equals_jax(system):
    """--atom_terms: per-atom weighted term sums within 1e-5 relative, the
    table text equal line by line after rounding to 4 significant digits,
    embedded in the SDF under atomic_interaction_terms."""
    jsf, tsf = jget_sf("vina"), tget_sf("vina")
    jl, tl = system["jlig"], system["tlig"]
    jrec, trec = system["jrec"], system["trec"]
    jv = jatom.per_atom_term_values(jsf, jl.types, jl.orig_coords,
                                    jl.charges, jrec.types, jrec.coords,
                                    jrec.charges)
    tv = tatom.per_atom_term_values(tsf, tl.types, tl.orig_coords,
                                    tl.charges, trec.types, trec.coords,
                                    trec.charges, device="cpu")
    assert tv.shape == jv.shape == (tl.num_atoms, 5)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6)
    jt = jatom.atom_terms_table(jsf, jl, jrec).splitlines()
    tt = tatom.atom_terms_table(tsf, tl, trec, device="cpu").splitlines()
    assert tt[0] == jt[0] and tt[-1] == jt[-1] == "END"
    assert len(tt) == len(jt) == tl.num_atoms + 2
    for a, b in zip(tt[1:-1], jt[1:-1]):
        fa, fb = a.split(), b.split()
        assert fa[:5] == fb[:5]
        np.testing.assert_allclose([float(x) for x in fa[5:]],
                                   [float(x) for x in fb[5:]], rtol=1e-4,
                                   atol=1e-6)
    assert [tterms.describe_term(t) for t in tsf.pair_terms] \
        == [jterms.describe_term(t) for t in jsf.pair_terms]
    assert tterms.available_term_names() == jterms.available_term_names()
