"""The plain versions of the fused kernels (K1 eval_fg, K2 bfgs_minimize
and its async_ls mode K4, K3 async_mc_window and its warm_ls mode K6, K5
lockstep_mc_window, and K7's gradient layout) against the JAX package's
plain references: ops/energy.make_energy_fn and ops/bfgs.bfgs.

The JAX side runs through its plain references, as its own fast tier does,
not through Pallas interpret mode.  Inputs come from a numpy seed and are
handed to both sides; every tolerance is stated where it is checked.  The
CUDA kernels themselves are held against these plain versions in
test_torch_kernels_cuda.py, on a card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.ops import energy as jenergy
from gnina_tpu.ops.bfgs import MinimizeParams, bfgs
from gnina_tpu.scoring import terms as jterms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import Conf as JConf
from gnina_tpu.types import pad_ligand as jpad_ligand
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.types import Conf as TConf

N_PAD, M_PAD, P_PAD, K_PAD, LAYERS = 24, 4, 96, 1024, 4
LANES = 8
HUNT = (10.0, 10.0, 1e3, 1000.0)   # v_intra, v_inter, slope, v_metro


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_sf(jsf):
    terms = [(jterms.describe_term(t), w)
             for t, w in zip(jsf.pair_terms, jsf.pair_weights)]
    terms += [(t.name, w) for t, w in zip(jsf.conf_terms, jsf.conf_weights)]
    table = {f.name: getattr(jsf.table, f.name)
             for f in dataclasses.fields(jsf.table)}
    return convert.scoring_from_numpy(jsf.name, terms, table)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    tlig = convert.ligand_from_numpy(
        {f.name: getattr(jlig, f.name) for f in dataclasses.fields(jlig)
         if f.name not in ("mol", "other_pairs", "flex_meta")})
    center = fx.ligand_center(jlig)
    path = tmp_path_factory.mktemp("rec") / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=4, cube=22.0))
    jrec = jingest.Receptor.from_file(str(path))
    pr = jrec.pruned(center, np.full(3, 6.0), margin=8.0)
    lo = (center - 6.0).astype(np.float32)
    hi = (center + 6.0).astype(np.float32)
    jsf = jget_sf("vina")
    tsf = port_sf(jsf)
    kr = len(pr.types)
    pack = fd.build_pack([tlig], pr.coords, pr.types, np.ones(kr, np.float32),
                         LANES, tsf.table, m_pad=M_PAD, device="cpu")
    jl = jpad_ligand(jlig, N_PAD, M_PAD, P_PAD)
    jr = jpad_receptor(pr.coords, pr.types, pr.charges, K_PAD)
    efn = jenergy.make_energy_fn(jsf, LAYERS)
    box = jenergy.Box(lo=jnp.asarray(lo), hi=jnp.asarray(hi))
    return dict(jlig=jlig, tlig=tlig, pack=pack, jl=jl, jr=jr, efn=efn,
                box=box, lo=lo, hi=hi, terms=fd.extract_vina_terms(tsf))


def scal(system, v=HUNT):
    return fd.scal_vector(v[0], v[1], v[2], v[3], system["lo"], system["hi"],
                          device="cpu")


def random_confs(system, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(system["lo"], system["hi"], (LANES, 3))
    q = rng.normal(size=(LANES, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    tors = rng.uniform(-np.pi, np.pi, (LANES, M_PAD - 1))
    return (pos.astype(np.float32), q.astype(np.float32),
            tors.astype(np.float32))


def perturbed_confs(system, seed):
    """Small jitters of the crystal pose: energies in the physical range,
    where minimisation trajectories are comparable across frameworks."""
    rng = np.random.default_rng(seed)
    pos = system["jlig"].orig_coords[0][None] + 0.5 * rng.normal(
        size=(LANES, 3))
    axis = 0.2 * rng.normal(size=(LANES, 3))
    ang = np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang], 1)
    tors = 0.3 * rng.normal(size=(LANES, M_PAD - 1))
    return (pos.astype(np.float32), q.astype(np.float32),
            tors.astype(np.float32))


def packed(confs):
    pos, q, tors = confs
    return fd.conf_to_packed(TConf(torch.as_tensor(pos), torch.as_tensor(q),
                                   torch.as_tensor(tors)), M_PAD)


def jax_objective(system, v=HUNT):
    efn, jl, jr, box = system["efn"], system["jl"], system["jr"], system["box"]
    vv = jnp.asarray([v[0], v[1], v[1]], jnp.float32)

    def f(c):
        return efn.eval_deriv(jl, jr, c, box, v[2], vv)

    def fv(c):
        return efn.eval_energy(jl, jr, c, box, v[2], vv)

    return f, fv


def jax_fns(system):
    """Jitted, vmapped JAX references over LANES poses, built once per
    module: (value+grad, metro energy, bfgs by iteration count)."""
    if "jfns" not in system:
        f, fv = jax_objective(system)
        efn, jl, jr, box = (system["efn"], system["jl"], system["jr"],
                            system["box"])
        mask = dof_mask(system)

        def bfgs_fn(iters):
            minpar = MinimizeParams(maxiters=iters, type="fast",
                                    fused_trials=False)
            return jax.jit(jax.vmap(lambda c: bfgs(f, c, minpar, mask,
                                                   f_val=fv)))

        system["jfns"] = dict(
            deriv=jax.jit(jax.vmap(f)),
            metro=jax.jit(jax.vmap(lambda c: efn.eval_inter(
                jl, jr, c, box, 1e3, jnp.float32(1000.0)))),
            bfgs={it: bfgs_fn(it) for it in (1, 3)})
    return system["jfns"]


def jconfs(confs):
    pos, q, tors = confs
    return JConf(jnp.asarray(pos), jnp.asarray(q), jnp.asarray(tors))


def dof_mask(system):
    return jnp.arange(6 + M_PAD - 1) < 6 + system["jlig"].num_torsions


# ---------------------------------------------------------------- K1 ----

@pytest.mark.parametrize("kind,seed", [("random", 1), ("perturbed", 2)])
def test_eval_fg_plain_matches_jax(system, kind, seed):
    """e and e_metro within rtol 2e-4 / atol 2e-3 (the JAX kernel test's
    bound); the analytic DOF gradient against JAX autograd within rtol
    1e-3 / atol 1e-2 on physical poses and 1e-3 of the gradient's scale on
    clashing random poses (f32 sums in another order)."""
    confs = (random_confs if kind == "random" else perturbed_confs)(
        system, seed)
    rigid, tors = packed(confs)
    e, em, g, coords = fd.eval_fg(system["terms"], rigid, tors,
                                  scal(system), system["pack"])
    jf = jax_fns(system)
    ej, gj = jf["deriv"](jconfs(confs))
    em_ref = jf["metro"](jconfs(confs))
    np.testing.assert_allclose(e.numpy(), np.asarray(ej), rtol=2e-4,
                               atol=2e-3)
    np.testing.assert_allclose(em.numpy(), np.asarray(em_ref), rtol=2e-4,
                               atol=2e-3)
    gj = np.where(np.asarray(dof_mask(system)), np.asarray(gj), 0.0)
    if kind == "perturbed":
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-3, atol=1e-2)
    else:
        scale = float(np.abs(gj).max())
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-3,
                                   atol=1e-3 * scale)
    # the coordinates are the heavy atoms' FK positions
    ref = fd.fk_packed(rigid, tors, system["pack"])
    np.testing.assert_allclose(coords.numpy(), ref.numpy(), atol=1e-5)


def test_eval_fg_plain_padding_rows_are_inert(system):
    """Padding atoms and padded tree nodes carry no energy or gradient: a
    pack padded wider (8 more atom rows, 2 more nodes) gives the same
    values, and the padded torsion slots' gradient is exactly zero."""
    confs = perturbed_confs(system, 3)
    rigid, tors = packed(confs)
    e0, em0, g0, _ = fd.eval_fg(system["terms"], rigid, tors, scal(system),
                                system["pack"])
    pack = system["pack"]
    wide = pack._replace(
        lc=torch.cat([pack.lc, torch.zeros(1, 8, 3)], 1),
        ap=torch.cat([pack.ap, torch.zeros(1, 8, 6)], 1),
        node=torch.cat([pack.node, torch.zeros(1, 8, dtype=torch.int32)], 1),
        parent=torch.cat([pack.parent, torch.zeros(1, 2, dtype=torch.int32)],
                         1),
        layer=torch.cat([pack.layer, torch.zeros(1, 2, dtype=torch.int32)], 1),
        relax=torch.cat([pack.relax, torch.zeros(1, 2, 3)], 1),
        relo=torch.cat([pack.relo, torch.zeros(1, 2, 3)], 1),
        imask=torch.nn.functional.pad(pack.imask, (0, 8, 0, 8)),
        dofmask=torch.cat([pack.dofmask, torch.zeros(1, 2)], 1),
        heavy_idx=np.pad(pack.heavy_idx, ((0, 0), (0, 8)),
                         constant_values=-1))
    tors_w = torch.cat([tors, torch.full((LANES, 2), 1.0)], 1)
    e1, em1, g1, _ = fd.eval_fg(system["terms"], rigid, tors_w, scal(system),
                                wide)
    np.testing.assert_allclose(e1.numpy(), e0.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(em1.numpy(), em0.numpy(), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(g1[:, :6 + M_PAD - 1].numpy(), g0.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert (g1[:, 6 + M_PAD - 1:] == 0).all()
    assert wide.dims[:2] == (pack.dims[0] + 8, M_PAD + 2)


# ---------------------------------------------------------------- K2 ----

def _jax_bfgs(system, confs, iters):
    return jax_fns(system)["bfgs"][iters](jconfs(confs))


@pytest.mark.parametrize("kind,seed", [("random", 5), ("perturbed", 6)])
def test_bfgs_plain_one_iteration(system, kind, seed):
    """One iteration: energy within rtol 5e-4 / atol 5e-3 and position
    within 2e-3 A of ops/bfgs.bfgs (the JAX kernel test's bounds)."""
    confs = (random_confs if kind == "random" else perturbed_confs)(
        system, seed)
    rigid, tors = packed(confs)
    r, t, stats, coords = fd.bfgs_minimize(system["terms"], rigid, tors,
                                           scal(system), system["pack"], 1)
    res = _jax_bfgs(system, confs, 1)
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(res.f0),
                               rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(r[:, :3].numpy(),
                               np.asarray(res.x.position), atol=2e-3)
    assert (stats[:, 3] <= 1).all()


def test_bfgs_plain_three_iterations_and_descent(system):
    """Three iterations from physical poses: energy within rtol 1e-2 /
    atol 5e-2 of ops/bfgs.bfgs (beyond that f32 Armijo accept flips make
    the trajectories formally incomparable); eight iterations never end
    above the start energy (+1e-3)."""
    confs = perturbed_confs(system, 7)
    rigid, tors = packed(confs)
    _, _, stats3, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                       scal(system), system["pack"], 3)
    res = _jax_bfgs(system, confs, 3)
    np.testing.assert_allclose(stats3[:, 0].numpy(), np.asarray(res.f0),
                               rtol=1e-2, atol=5e-2)
    e0, em0, _, _ = fd.eval_fg(system["terms"], rigid, tors, scal(system),
                               system["pack"])
    _, _, stats8, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                       scal(system), system["pack"], 8)
    assert (stats8[:, 0] <= e0 + 1e-3).all()
    # accepted iterations (row 4) never exceed those run (row 3), which
    # exceed them by at most the one that ran out of trials
    assert (stats8[:, 4] <= stats8[:, 3]).all()
    assert (stats8[:, 3] - stats8[:, 4] <= 1).all()
    assert (stats8[:, 4] >= 1).any()
    # stats row 1 is the Metropolis energy at the returned pose
    r8, t8, _, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                    scal(system), system["pack"], 8)
    _, em8, _, _ = fd.eval_fg(system["terms"], r8, t8, scal(system),
                              system["pack"])
    np.testing.assert_allclose(stats8[:, 1].numpy(), em8.numpy(), rtol=1e-5,
                               atol=1e-4)


def test_bfgs_plain_restores_when_not_improved(system):
    """A pose whose start energy is NaN-free but cannot descend (zero DOF
    mask) comes back unchanged, with its start energy."""
    confs = perturbed_confs(system, 8)
    rigid, tors = packed(confs)
    pack = system["pack"]._replace(
        dofmask=torch.zeros_like(system["pack"].dofmask))
    r, t, stats, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                      scal(system), pack, 4)
    e0, _, _, _ = fd.eval_fg(system["terms"], rigid, tors, scal(system), pack)
    assert torch.equal(r, rigid) and torch.equal(t, tors)
    assert torch.equal(stats[:, 0], e0)
    assert (stats[:, 3] == 0).all() and (stats[:, 4] == 0).all()


# ---------------------------------------------------------------- K3 ----

S_STEPS, MAXIT, TRIALS = 4, 1, 10
BUDGET = 1 + MAXIT * TRIALS       # covers any one step's ticks


def _mc(system, confs, seed, maxiters=MAXIT):
    rigid, tors = packed(confs)
    rng = np.random.default_rng(seed)
    uni = torch.as_tensor(rng.random((S_STEPS * BUDGET, fd.N_DRAWS, LANES),
                                     dtype=np.float32))
    ecur = torch.full((LANES,), 3.0e38)
    out = fd.async_mc_window_plain(system["terms"], rigid, tors,
                                   scal(system), system["pack"], ecur,
                                   S_STEPS, BUDGET, maxiters, TRIALS,
                                   uniforms=uni, trace=True)
    return rigid, tors, ecur, uni, out


def test_async_mc_plain_accounting(system):
    """With a budget covering the worst step (1 start + maxiters x trials
    ticks), every lane completes all S steps; flags are 0/1; accept only on
    completed rows; completed energies finite; the final chain state is the
    last accepted candidate."""
    confs = random_confs(system, 9)
    _, _, ecur, uni, out = _mc(system, confs, 10)
    crig, ctors, stats, coords, srig, stor, sstat, tr = out
    flags = sstat[..., 2]
    assert set(np.unique(flags.numpy())) <= {0.0, 1.0}
    assert (flags == 1).all()
    assert (stats[:, 4] == S_STEPS).all()
    acc = sstat[..., 1]
    assert set(np.unique(acc.numpy())) <= {0.0, 1.0}
    assert not ((acc > 0) & (flags == 0)).any()
    assert torch.isfinite(sstat[..., 0]).all()
    # the first step always accepts (chain energy starts at 3e38)
    assert (acc[:, 0] == 1).all()
    for l in range(LANES):
        j = int(torch.nonzero(acc[l] > 0)[-1])
        assert torch.equal(crig[l], srig[l, j])
        assert torch.equal(ctors[l], stor[l, j])
        assert stats[l, 0] == sstat[l, j, 0]
    np.testing.assert_allclose(
        coords.numpy(), fd.fk_packed(crig, ctors, system["pack"]).numpy(),
        atol=1e-6)


def test_async_mc_plain_steps_replay_with_jax(system):
    """Every completed step's candidate is JAX's bfgs (maxiters 1) from the
    mutated start the plain version reports, within the K2 bounds (rtol
    5e-4 / atol 5e-3 on the Metropolis energy, 2e-3 A on position); and
    every Metropolis decision is the one the supplied uniform gives."""
    confs = perturbed_confs(system, 11)
    _, _, ecur, uni, out = _mc(system, confs, 12)
    _, _, _, _, srig, stor, sstat, tr = out
    srig_f = srig.reshape(-1, 8)
    start = TConf(tr["start_rigid"].reshape(-1, 8)[:, 0:3],
                  tr["start_rigid"].reshape(-1, 8)[:, 3:7],
                  tr["start_tors"].reshape(-1, M_PAD)[:, 1:])
    jf = jax_fns(system)
    pos, em_ref = [], []
    for c in range(0, LANES * S_STEPS, LANES):   # LANES poses per call
        res = jf["bfgs"][1](JConf(
            jnp.asarray(start.position[c:c + LANES].numpy()),
            jnp.asarray(start.orientation[c:c + LANES].numpy()),
            jnp.asarray(start.torsions[c:c + LANES].numpy())))
        pos.append(np.asarray(res.x.position))
        em_ref.append(np.asarray(jf["metro"](res.x)))
    pos, em_ref = np.concatenate(pos), np.concatenate(em_ref)
    # rows whose line search accepted moved off their start (the rest took
    # no step; the JAX bfgs takes its fallback 2^-9 step there)
    moved = (srig_f != tr["start_rigid"].reshape(-1, 8)).any(1).numpy()
    assert moved.mean() > 0.5
    np.testing.assert_allclose(sstat.reshape(-1, 3)[moved, 0].numpy(),
                               em_ref[moved], rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(srig_f[moved, 0:3].numpy(), pos[moved],
                               atol=2e-3)
    # Metropolis, recomputed from the uniform of each completion tick
    temp = 1.2
    for l in range(LANES):
        e_cur = float(ecur[l])
        for j in range(S_STEPS):
            e_new = float(sstat[l, j, 0])
            u = float(uni[int(tr["done_tick"][l, j]), 12, l])
            want = (e_new < e_cur) or (u < np.exp(
                np.float32((e_cur - e_new) / temp)))
            assert bool(sstat[l, j, 1] > 0) == want, (l, j)
            if want:
                e_cur = e_new


def test_async_mc_plain_window_is_its_step_replay(system):
    """replay_mc_window_plain, which holds a window's rows one by one to the
    plain step from that window's own chain head, gives back the plain
    window exactly: the same energies, positions, Metropolis decisions and
    ticks.  It is the reference the CUDA window is held to on a card."""
    confs = perturbed_confs(system, 14)
    rigid, tors, ecur, uni, out = _mc(system, confs, 15)
    _, _, stats, _, srig, stor, sstat, tr = out
    e, pos, acc, ticks = fd.replay_mc_window_plain(
        system["terms"], rigid, tors, scal(system), system["pack"], ecur,
        (srig, stor, sstat), uni)
    assert torch.equal(e, sstat[..., 0])
    assert torch.equal(pos, srig[..., :3])
    assert torch.equal(acc, sstat[..., 1] > 0.5)
    assert torch.equal(ticks, stats[:, 2].long())
    assert torch.equal(ticks - 1, tr["done_tick"][:, -1])


def test_async_mc_plain_generator_is_deterministic(system):
    """Without supplied uniforms the draws come from the given generator:
    the same seed gives the same window, another seed another one."""
    rigid, tors = packed(random_confs(system, 13))
    ecur = torch.full((LANES,), 3.0e38)

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return fd.async_mc_window(system["terms"], rigid, tors, scal(system),
                                  system["pack"], ecur, 2, 8, 2,
                                  generator=g)

    a, b, c = run(1), run(1), run(2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[4], c[4])


# ---------------------------------------------------------------- K4 ----

@pytest.mark.parametrize("kind,seed,iters", [("perturbed", 20, 3),
                                             ("perturbed", 21, 8),
                                             ("random", 22, 5)])
def test_async_ls_plain_is_the_lockstep_search(system, kind, seed, iters):
    """K4's plain version ends in K2's plain state, bit for bit (each lane
    walks the same trial points; the JAX package asserts the same of its
    two modes), and its counters follow pallas_dock.py:888-889: row 2 the
    lane's active ticks, one per Armijo trial, row 3 its accepts."""
    confs = (random_confs if kind == "random" else perturbed_confs)(
        system, seed)
    rigid, tors = packed(confs)
    args = (system["terms"], rigid, tors, scal(system), system["pack"], iters)
    r2, t2, s2, c2 = fd.bfgs_minimize(*args)
    r4, t4, s4, c4 = fd.bfgs_minimize(*args, async_ls=True)
    assert torch.equal(r4, r2) and torch.equal(t4, t2)
    assert torch.equal(s4[:, :2], s2[:, :2]) and torch.equal(c4, c2)
    assert torch.equal(s4[:, 2], s2[:, 2])       # ticks == trial evals
    assert torch.equal(s4[:, 3], s2[:, 4])       # accepts
    assert torch.equal(s4[:, 4], s2[:, 4])
    assert (s4[:, 2] <= iters * fd.NUM_TRIALS + 1).all()
    assert (s4[:, 3] <= iters).all()


def test_async_ls_plain_one_iteration_matches_jax(system):
    """K4's plain version against ops/bfgs.bfgs at one iteration, within
    the K2 bounds (rtol 5e-4 / atol 5e-3, 2e-3 A)."""
    confs = perturbed_confs(system, 23)
    rigid, tors = packed(confs)
    r, _, stats, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                      scal(system), system["pack"], 1,
                                      async_ls=True)
    res = _jax_bfgs(system, confs, 1)
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(res.f0),
                               rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(r[:, :3].numpy(),
                               np.asarray(res.x.position), atol=2e-3)


def test_async_ls_plain_no_descent_is_done_at_once(system):
    """A lane with no descent direction (zero DOF mask) spends no tick."""
    rigid, tors = packed(perturbed_confs(system, 24))
    pack = system["pack"]._replace(
        dofmask=torch.zeros_like(system["pack"].dofmask))
    r, t, stats, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                      scal(system), pack, 4, async_ls=True)
    assert torch.equal(r, rigid) and torch.equal(t, tors)
    assert (stats[:, 2:5] == 0).all()


# ---------------------------------------------------------------- K5 ----

def _lockstep(system, confs, seed, maxiters=1, async_ls=False, steps=S_STEPS):
    rigid, tors = packed(confs)
    rng = np.random.default_rng(seed)
    uni = torch.as_tensor(rng.random((steps, fd.N_DRAWS, LANES),
                                     dtype=np.float32))
    ecur = torch.full((LANES,), 3.0e38)
    out = fd.lockstep_mc_window_plain(
        system["terms"], rigid, tors, scal(system), system["pack"], ecur,
        steps, maxiters, TRIALS, async_ls=async_ls, uniforms=uni, trace=True)
    return rigid, tors, ecur, uni, out


def test_lockstep_mc_plain_steps_replay_with_jax(system):
    """Every step's candidate is JAX's bfgs (maxiters 1) from the mutated
    start the plain window reports, within the K2 bounds (rtol 5e-4 / atol
    5e-3 on the Metropolis energy, 2e-3 A on position); every Metropolis
    decision is the one the step's supplied uniform gives; the chain state
    returned is the last accepted row."""
    confs = perturbed_confs(system, 30)
    _, _, ecur, uni, out = _lockstep(system, confs, 37)
    crig, ctors, stats, coords, srig, stor, sstat, tr = out
    assert sstat.shape == (LANES, S_STEPS, 3)
    jf = jax_fns(system)
    for j in range(S_STEPS):
        st = tr["start_rigid"][:, j]
        res = jf["bfgs"][1](JConf(
            jnp.asarray(st[:, 0:3].numpy()), jnp.asarray(st[:, 3:7].numpy()),
            jnp.asarray(tr["start_tors"][:, j, 1:].numpy())))
        em_ref = np.asarray(jf["metro"](res.x))
        moved = (srig[:, j] != st).any(1).numpy()
        assert moved.mean() > 0.5
        np.testing.assert_allclose(sstat[moved, j, 0].numpy(), em_ref[moved],
                                   rtol=5e-4, atol=5e-3)
        np.testing.assert_allclose(srig[moved, j, 0:3].numpy(),
                                   np.asarray(res.x.position)[moved],
                                   atol=2e-3)
    for l in range(LANES):
        e_cur = float(ecur[l])
        last = None
        for j in range(S_STEPS):
            e_new = float(sstat[l, j, 0])
            want = (e_new < e_cur) or (float(uni[j, 12, l]) < np.exp(
                np.float32((e_cur - e_new) / 1.2)))
            assert bool(sstat[l, j, 1] > 0) == want, (l, j)
            if want:
                e_cur, last = e_new, j
        assert torch.equal(crig[l], srig[l, last])
        assert torch.equal(ctors[l], stor[l, last])
        assert float(stats[l, 0]) == e_cur
    assert torch.equal(stats[:, 2], sstat[..., 2].sum(1))
    # row 4 counts accepted line-search steps: with maxiters 1, the rows
    # that left their start; row 3 counts the iterations entered
    n_moved = (srig != tr["start_rigid"]).any(2).sum(1).float()
    assert torch.equal(stats[:, 4], n_moved)
    assert (stats[:, 4] <= stats[:, 3]).all()


@pytest.mark.parametrize("async_ls", [False, True])
def test_lockstep_mc_plain_window_is_its_step_replay(system, async_ls):
    """replay_lockstep_window_plain gives back the plain window exactly
    (energies, positions, trial counts, Metropolis decisions, returned
    coordinates): it is the
    reference the CUDA window is held to on a card.  With async_ls the
    window is the same window (K4 inside K5)."""
    confs = perturbed_confs(system, 32)
    rigid, tors, ecur, uni, out = _lockstep(system, confs, 33, maxiters=3,
                                            async_ls=async_ls)
    _, _, stats, coords, srig, stor, sstat, _ = out
    e, pos, trials, acc, c_rep, gi = fd.replay_lockstep_window_plain(
        system["terms"], rigid, tors, scal(system), system["pack"], ecur,
        (srig, stor, sstat), uni, 3, TRIALS, async_ls=async_ls)
    assert torch.equal(e, sstat[..., 0])
    assert torch.equal(pos, srig[..., :3])
    assert torch.equal(trials, sstat[..., 2])
    assert torch.equal(acc, sstat[..., 1] > 0.5)
    assert torch.equal(c_rep, coords)
    assert torch.equal(gi.sum(1), stats[:, 5]) and not bool(gi.any())
    if async_ls:
        base = _lockstep(system, confs, 33, maxiters=3)[4]
        for i, (x, y) in enumerate(zip(out[:7], base[:7])):
            if i == 2:      # stats row 3 counts accepts, not iterations
                x, y = x[:, :3], y[:, :3]
            if i == 3:      # coordinates: the last tick's trial point
                continue
            assert torch.equal(x, y)


def test_lockstep_mc_plain_returns_its_last_iterate_coords(system):
    """The coordinates are the FK of the last step's last BFGS iterate
    (what the JAX kernel leaves in its coordinate scratch), which is the
    final chain state only on lanes whose last step was accepted."""
    confs = random_confs(system, 34)
    _, _, _, _, out = _lockstep(system, confs, 35, maxiters=2, steps=6)
    crig, ctors, _, coords, srig, stor, sstat, _ = out
    last = fd.fk_packed(srig[:, -1], stor[:, -1], system["pack"])
    head = fd.fk_packed(crig, ctors, system["pack"])
    np.testing.assert_allclose(coords.numpy(), last.numpy(), atol=1e-6)
    rejected = sstat[:, -1, 1] < 0.5
    assert rejected.any()
    assert not torch.allclose(coords[rejected], head[rejected], atol=1e-3)


def test_lockstep_mc_plain_async_ls_returns_its_last_trial_coords(system):
    """Under async_ls the coordinates are those of the last step's last
    tick (the JAX async loop's last FK is its trial point, accepted or
    not).  With maxiters 1 a lane's last tick is its first accept, whose
    trial point is the stream row, or its last rejected trial, the start
    moved by -g at the smallest step (atol 1e-5 A)."""
    confs = random_confs(system, 34)
    _, _, _, _, out = _lockstep(system, confs, 35, maxiters=1, async_ls=True,
                                steps=3)
    _, _, stats, coords, srig, stor, sstat, tr = out
    pack = system["pack"]
    st_r, st_t = tr["start_rigid"][:, -1], tr["start_tors"][:, -1]
    _, _, g, _ = fd._eval(system["terms"], st_r, st_t, scal(system), pack,
                          True)
    p = -g * pack.dofmask[pack.lane_lig.long()]
    alpha = torch.full((LANES,), 2.0 ** -(TRIALS - 1))
    deep = fd.fk_packed(*fd._increment(st_r, st_t, p, alpha), pack)
    row = fd.fk_packed(srig[:, -1], stor[:, -1], pack)
    stuck = (sstat[:, -1, 2] == TRIALS) & (srig[:, -1] == st_r).all(1)
    took = (srig[:, -1] != st_r).any(1)
    assert stuck.any() and took.any()
    np.testing.assert_allclose(coords[took].numpy(), row[took].numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(coords[stuck].numpy(), deep[stuck].numpy(),
                               atol=1e-5)
    assert not torch.allclose(coords[stuck], row[stuck], atol=1e-4)
    # accepted line-search steps are counted in stats row 4
    assert torch.equal(stats[:, 4], stats[:, 3])


def test_lockstep_mc_plain_generator_is_deterministic(system):
    rigid, tors = packed(random_confs(system, 36))
    ecur = torch.full((LANES,), 3.0e38)

    def run(seed):
        return fd.lockstep_mc_window(system["terms"], rigid, tors,
                                     scal(system), system["pack"], ecur, 2,
                                     2, seed=seed)

    a, b, c = run(1), run(1), run(2)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[4], c[4])


# ---------------------------------------------------------------- K6 ----

def test_warm_ls_off_is_the_cold_window(system):
    """With the flag off the window is bit-identical to the default call
    (and to the replay, as before)."""
    confs = perturbed_confs(system, 40)
    rigid, tors, ecur, uni, out = _mc(system, confs, 41, maxiters=3)
    off = fd.async_mc_window_plain(system["terms"], rigid, tors,
                                   scal(system), system["pack"], ecur,
                                   S_STEPS, BUDGET, 3, TRIALS, uniforms=uni,
                                   warm_ls=False)
    for x, y in zip(out[:7], off):
        assert torch.equal(x, y)
    ex = out[7]["exponent"]
    # cold schedule: the exponent is the trial count, 0 after every accept
    assert np.nanmax(ex.numpy()) <= TRIALS - 1


def test_warm_ls_exponent_schedule(system):
    """With the flag on, every BFGS tick's exponent is max(wa - 1, 0) +
    trial, where wa is the lane's last accepted exponent, reset to 0 at
    each new candidate (pallas_dock.py:1150-1152, :1231-1233): re-derived
    here from the traced accepts alone.  Some lane starts an iteration
    above exponent 0, which the cold schedule never does."""
    confs = perturbed_confs(system, 42)
    rigid, tors = packed(confs)
    maxit = 4
    budget = 1 + maxit * TRIALS
    rng = np.random.default_rng(43)
    uni = torch.as_tensor(rng.random((S_STEPS * budget, fd.N_DRAWS, LANES),
                                     dtype=np.float32))
    ecur = torch.full((LANES,), 3.0e38)
    out = fd.async_mc_window_plain(system["terms"], rigid, tors, scal(system),
                                   system["pack"], ecur, S_STEPS, budget,
                                   maxit, TRIALS, uniforms=uni, trace=True,
                                   warm_ls=True)
    ex, acc = out[7]["exponent"].numpy(), out[7]["accepted"].numpy()
    warm_starts = 0
    for l in range(LANES):
        wa = tl = 0.0
        for k in range(ex.shape[0]):
            if np.isnan(ex[k, l]):       # a start tick or a finished lane
                wa = tl = 0.0
                continue
            want = max(wa - 1.0, 0.0) + tl
            assert ex[k, l] == want, (l, k)
            if acc[k, l]:
                wa, tl = want, 0.0
                if k + 1 < ex.shape[0] and ex[k + 1, l] > 0:
                    warm_starts += 1
            else:
                tl += 1.0
    assert warm_starts > 0
    assert (out[6][..., 2] == 1).all()
    # and the replay under the same flag gives the window back
    e, pos, a, ticks = fd.replay_mc_window_plain(
        system["terms"], rigid, tors, scal(system), system["pack"], ecur,
        out[4:7], uni, maxiters=maxit, num_trials=TRIALS, warm_ls=True)
    assert torch.equal(e, out[6][..., 0]) and torch.equal(
        ticks, out[2][:, 2].long())


# ---------------------------------------------------------------- K7 ----

def test_debug_grad_layout_matches_jax_gradient(system):
    """K7: the DOF gradient K1 returns, in the debug_grad mode's row layout
    (DOF row r at coords[l, r % N, r // N], pallas_dock.py:969-973),
    against jax.grad of the JAX exact energy within the K1 gradient bound
    (rtol 1e-3 / atol 1e-2); rows past D are zero; the energy rides in
    stats row 0."""
    confs = perturbed_confs(system, 50)
    rigid, tors = packed(confs)
    r, t, stats, gc = fd.debug_grad(system["terms"], rigid, tors,
                                    scal(system), system["pack"])
    n = system["pack"].dims[0]
    d = 6 + M_PAD - 1
    assert gc.shape == (LANES, n, 3)
    ej, gj = jax_fns(system)["deriv"](jconfs(confs))
    gj = np.where(np.asarray(dof_mask(system)), np.asarray(gj), 0.0)
    rows = gc.permute(0, 2, 1).reshape(LANES, 3 * n).numpy()   # gd rows
    np.testing.assert_allclose(rows[:, :d], gj, rtol=1e-3, atol=1e-2)
    assert (rows[:, d:] == 0).all()
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(ej),
                               rtol=2e-4, atol=2e-3)
    assert (stats[:, 1:] == 0).all()
    assert torch.equal(r, rigid) and torch.equal(t, tors)


def test_wrappers_use_plain_versions_on_cpu_without_counting(system):
    """On CPU tensors the wrappers run the plain versions; launches count
    kernel launches only."""
    before = [k.launches for k in fd.KERNELS]
    rigid, tors = packed(perturbed_confs(system, 14))
    fd.eval_fg(system["terms"], rigid, tors, scal(system), system["pack"])
    fd.bfgs_minimize(system["terms"], rigid, tors, scal(system),
                     system["pack"], 1)
    assert [k.launches for k in fd.KERNELS] == before
