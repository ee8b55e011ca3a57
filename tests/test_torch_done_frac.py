"""K8, the group stop (done_frac < 1): the port's plain version against the
JAX package's Pallas kernel run in interpret mode on the CPU.

The JAX kernel pads its block to 128 lanes with inert lanes, which read
done and count toward the stop; with 12 real lanes the padding decides when
the loops end, and the port must add it.  Inputs come from a numpy seed and
go to both sides.  Bounds are those of the K2 tests: after one iteration
energy rtol 5e-4 / atol 5e-3 and position 2e-3 A; after three, energy rtol
1e-2 / atol 5e-2 (beyond that float32 Armijo decisions differ between two
correct searches).  The iteration counters are integers and must be equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.ops import pallas_dock as pd
from gnina_tpu.scoring import terms as jterms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.ops import fused_dock as fd

LANES, M_PAD = 12, 4
HUNT = (10.0, 10.0, 1e3, 1000.0)
TRIALS, FACTOR = 4, 4.0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
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
    """The in-repo ligand in a small synthetic receptor (interpret-mode cost
    grows with the receptor), packed for both sides."""
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    tlig = convert.ligand_from_numpy(
        {f.name: getattr(jlig, f.name) for f in dataclasses.fields(jlig)
         if f.name not in ("mol", "other_pairs", "flex_meta")})
    center = fx.ligand_center(jlig)
    path = tmp_path_factory.mktemp("rec") / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=4, cube=22.0))
    jrec = jingest.Receptor.from_file(str(path))
    pr = jrec.pruned(center, np.full(3, 6.0), margin=2.0)
    lo = (center - 6.0).astype(np.float32)
    hi = (center + 6.0).astype(np.float32)
    jsf = jget_sf("vina")
    tsf = port_sf(jsf)
    kr = len(pr.types)
    ones = np.ones(kr, np.float32)
    tpack = fd.build_pack([tlig], pr.coords, pr.types, ones, LANES,
                          tsf.table, m_pad=M_PAD, device="cpu")
    # the JAX kernel tiles the receptor in blocks of pd.KB rows
    rd = jpad_receptor(pr.coords, pr.types, pr.charges,
                       -(-kr // pd.KB) * pd.KB)
    jpack = pd.build_pack([jlig], np.asarray(rd.coords), np.asarray(rd.types),
                          np.asarray(rd.charges), np.asarray(rd.mask),
                          exhaustiveness=LANES, table=jsf.table)
    return dict(jlig=jlig, tlig=tlig, tpack=tpack, jpack=jpack, jsf=jsf,
                lo=lo, hi=hi, terms=fd.extract_vina_terms(tsf), kr=kr)


def starts(system, seed, kind):
    rng = np.random.default_rng(seed)
    return fx.packed_poses(rng, LANES, system["lo"], system["hi"],
                           system["tlig"], M_PAD, "cpu", kind)


def scal(system):
    return fd.scal_vector(*HUNT, system["lo"], system["hi"], device="cpu")


def mixed_starts(system, seed):
    """Six lanes already minimised (they converge, or run out of trials, in
    their first iteration) and six jittered ones that go on for several:
    the lanes finish at different iterations, so the group's count moves."""
    rigid, tors = starts(system, seed, "perturbed")
    r2, t2, _, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                    scal(system), system["tpack"], 40, True,
                                    TRIALS, FACTOR)
    return torch.cat([r2[:6], rigid[6:]]), torch.cat([t2[:6], tors[6:]])


def jax_bfgs(system, rigid, tors, maxiters, done_frac, async_ls):
    """The JAX kernel in interpret mode on the same packed poses, padded to
    the pack's 128 lanes: (rigid (L, 8), tors (L, M), stats (L, 8))."""
    fused = pd.FusedBfgs(system["jsf"], system["jpack"], maxiters=maxiters,
                         want_metro=True, interpret=True,
                         done_frac=done_frac, num_trials=TRIALS,
                         ls_factor=FACTOR, async_ls=async_ls)
    assert fused.m == M_PAD
    l_pad = system["jpack"].lc.shape[-1]
    jr = jnp.pad(jnp.asarray(rigid.numpy().T), ((0, 0), (0, l_pad - LANES)))
    jt = jnp.pad(jnp.asarray(tors.numpy().T), ((0, 0), (0, l_pad - LANES)))
    jscal = fused.scal(*HUNT, system["lo"], system["hi"])
    org, otr, stats, _ = fused(jr, jt, jscal)
    return (np.asarray(org)[:, :LANES].T, np.asarray(otr)[:, :LANES].T,
            np.asarray(stats)[:, :LANES].T)


def port_bfgs(system, rigid, tors, maxiters, done_frac, async_ls):
    return fd.bfgs_minimize(system["terms"], rigid, tors, scal(system),
                            system["tpack"], maxiters, True, TRIALS, FACTOR,
                            async_ls=async_ls, done_frac=done_frac)


def test_pack_is_one_padded_block(system):
    """The comparison rests on it: 12 real lanes in one block of 128."""
    assert system["jpack"].lc.shape[-1] == fd.GROUP == pd.LB
    assert system["tpack"].lanes == LANES


@pytest.mark.parametrize("async_ls", [False, True],
                         ids=["lockstep", "async_ls"])
@pytest.mark.parametrize("done_frac", [0.93, 0.95, 0.97])
def test_group_stop_matches_jax_kernel(system, async_ls, done_frac):
    """12 real lanes, 116 padding lanes: int(0.93 * 128) = 119 needs 3 real
    lanes done, 0.95 needs 5 and 0.97 needs 8, so the stop falls at
    different iterations (measured: 1, 6, 6 lockstep iterations and 4, 8, 10
    async ticks).  The group's iteration (tick) count equals the JAX
    kernel's, every lane of the group reports the same count, and the final
    state is within the K2 bounds for the iterations run (one: tight; more:
    the three-iteration bound; measured 5.1e-4 kcal/mol, 1.9e-4 A)."""
    rigid, tors = mixed_starts(system, 11)
    maxit = 6
    jr, jt, js = jax_bfgs(system, rigid, tors, maxit, done_frac, async_ls)
    r, t, st, _ = port_bfgs(system, rigid, tors, maxit, done_frac, async_ls)
    g_iters = st[:, 5].numpy()
    assert (g_iters == g_iters[0]).all()
    if async_ls:
        # stats rows 2, 3: the lane's active ticks and accepts, both cut by
        # the group stop; no lane can be active for more ticks than ran
        np.testing.assert_array_equal(st[:, 2].numpy(), js[:, 2])
        np.testing.assert_array_equal(st[:, 3].numpy(), js[:, 3])
        assert (st[:, 2].numpy() <= g_iters).all()
    else:
        # the JAX lockstep loop counts the block's iterations in row 3
        np.testing.assert_array_equal(g_iters, js[:, 3])
    tight = g_iters[0] <= 1
    np.testing.assert_allclose(st[:, 0].numpy(), js[:, 0],
                               rtol=5e-4 if tight else 1e-2,
                               atol=5e-3 if tight else 5e-2)
    np.testing.assert_allclose(r[:, :3].numpy(), jr[:, :3],
                               atol=2e-3 if tight else 2e-2)


def test_padding_lanes_count_from_the_first_iteration(system):
    """done_frac = 0.9 with 116 padding lanes: the target 115 is met by the
    padding alone, so both sides stop after ONE iteration (one tick),
    whatever the real lanes do; at 1.0 they run on."""
    rigid, tors = starts(system, 12, "perturbed")
    for async_ls in (False, True):
        _, _, st, _ = port_bfgs(system, rigid, tors, 3, 0.9, async_ls)
        assert (st[:, 5] == 1).all()
        _, _, js = jax_bfgs(system, rigid, tors, 3, 0.9, async_ls)
        if async_ls:
            assert (js[:, 2] <= 1).all()
        else:
            assert (js[:, 3] == 1).all()
        _, _, st1, _ = port_bfgs(system, rigid, tors, 3, 1.0, async_ls)
        assert (st1[:, 3] > 1).any()
        # the votes: one group that met once, with fewer real lanes done
        # than the target asks for (the padding made up the rest)
        votes = []
        fd.bfgs_minimize(system["terms"], rigid, tors, scal(system),
                         system["tpack"], 3, True, TRIALS, FACTOR,
                         async_ls=async_ls, done_frac=0.9, votes=votes)
        v = votes[0]
        assert v.shape == (1, 3 * TRIALS + 1 if async_ls else 3)
        assert 0 <= int(v[0, 0]) <= LANES and bool((v[0, 1:] == -1).all())


@pytest.mark.parametrize("async_ls", [False, True],
                         ids=["lockstep", "async_ls"])
def test_done_frac_one_is_the_uncoupled_search(system, async_ls):
    """done_frac = 1.0 is bit-equal to the call without the argument, and
    its stats row 5 stays zero."""
    rigid, tors = starts(system, 13, "random")
    a = fd.bfgs_minimize(system["terms"], rigid, tors, scal(system),
                         system["tpack"], 3, True, TRIALS, FACTOR,
                         async_ls=async_ls)
    b = port_bfgs(system, rigid, tors, 3, 1.0, async_ls)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert (a[2][:, 5] == 0).all()


@pytest.mark.parametrize("async_ls", [False, True],
                         ids=["lockstep", "async_ls"])
def test_target_zero_runs_no_iteration(system, async_ls):
    """done_frac below 1/128 gives the target int(done_frac * 128) = 0,
    which the JAX loop's test meets before its first iteration: both sides
    return the start poses with their energies (1e-4 kcal/mol: one
    evaluation) and count no iteration, trial or tick."""
    rigid, tors = starts(system, 14, "perturbed")
    jr, jt, js = jax_bfgs(system, rigid, tors, 3, 0.005, async_ls)
    r, t, st, _ = port_bfgs(system, rigid, tors, 3, 0.005, async_ls)
    assert torch.equal(r, rigid) and torch.equal(t, tors)
    np.testing.assert_array_equal(jr, rigid.numpy())
    assert (st[:, 2:6] == 0).all()
    assert (js[:, 2:4] == 0).all()
    np.testing.assert_allclose(st[:, 0].numpy(), js[:, 0], rtol=1e-5,
                               atol=1e-4)
    e0 = fd.eval_fg(system["terms"], rigid, tors, scal(system),
                    system["tpack"])[0]
    assert torch.equal(st[:, 0], e0)


def test_group_stop_freezes_whole_groups(system):
    """140 lanes = one full group and one of 12 real lanes: with 0.5 the
    full group needs 64 done lanes of its own, the second group is stopped
    by its 116 padding lanes after one iteration; each group reports one
    count, and a lane's own iterations never exceed its group's."""
    lanes = fd.GROUP + 12
    rng = np.random.default_rng(14)
    rigid, tors = fx.packed_poses(rng, lanes, system["lo"], system["hi"],
                                  system["tlig"], M_PAD, "cpu", "perturbed")
    pack = system["tpack"].with_lanes(torch.zeros(lanes, dtype=torch.int32))
    _, _, st, _ = fd.bfgs_minimize(system["terms"], rigid, tors,
                                   scal(system), pack, 4, True, TRIALS,
                                   FACTOR, done_frac=0.5)
    gi = st[:, 5]
    assert (gi[:fd.GROUP] == gi[0]).all() and (gi[fd.GROUP:] == 1).all()
    assert gi[0] >= 1
    assert (st[:, 3] <= gi).all()


def test_lockstep_mc_step_runs_the_coupled_bfgs(system):
    """K5 with done_frac < 1 on supplied uniforms: one step's stream row is
    the coupled BFGS from the step's mutated start, so it is held to the
    JAX kernel's coupled BFGS from that same start (the JAX MC kernel draws
    its own random numbers and cannot be fed ours).  One iteration: energy
    rtol 5e-4 / atol 5e-3."""
    rigid, tors = starts(system, 15, "perturbed")
    rng = np.random.default_rng(16)
    uni = torch.as_tensor(rng.random((2, fd.N_DRAWS, LANES), dtype=np.float32))
    ecur = torch.full((LANES,), 3.0e38)
    out = fd.lockstep_mc_window_plain(
        system["terms"], rigid, tors, scal(system), system["tpack"], ecur, 2,
        1, TRIALS, FACTOR, uniforms=uni, trace=True, done_frac=0.95)
    stats, sstat, tr = out[2], out[6], out[7]
    assert (stats[:, 5] == 2).all()          # two steps, one iteration each
    _, _, js = jax_bfgs(system, tr["start_rigid"][:, 0],
                        tr["start_tors"][:, 0], 1, 0.95, False)
    np.testing.assert_allclose(sstat[:, 0, 0].numpy(), js[:, 1], rtol=5e-4,
                               atol=5e-3)
    # the wrapper passes the setting through
    w = fd.lockstep_mc_window(
        system["terms"], rigid, tors, scal(system), system["tpack"], ecur, 2,
        1, TRIALS, FACTOR, uniforms=uni, done_frac=0.95)
    assert torch.equal(w[6], sstat)
    h = fd.FusedBfgs(port_sf(system["jsf"]), system["tpack"], 1, mc_steps=2,
                     num_trials=TRIALS, ls_factor=FACTOR, async_mc=False,
                     done_frac=0.95)
    assert torch.equal(h.run_mc(rigid, tors, scal(system), 0, ecur,
                                uniforms=uni)[6], sstat)
    with pytest.raises(ValueError):
        fd.FusedBfgs(port_sf(system["jsf"]), system["tpack"], 1,
                     done_frac=0.0)
