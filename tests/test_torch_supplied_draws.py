"""The port's MC windows and MC driver against JAX's own Pallas kernel on
non-zero draws.

JAX's Mosaic interpreter returns zeros for the TPU PRNG
(test_torch_interpret_draws.py), so on the CPU the kernel's MC modes had
been held to the port on the all-zero draw only.  scripts/
jax_supplied_draws.py swaps `gnina_tpu.ops.pallas_dock.pltpu` for a proxy
whose `prng_random_bits` serves chosen uniforms through an ordered
`io_callback`, in the kernel's own draw order: 12 mutation draws (`which`,
two spheres of u1, u2, u3, u4, rad, the new torsion;
pallas_dock.py:1009-1078) and the Metropolis draw (:1238, :1296) per tick
or step.  That is the port's layout of a window's uniforms
(`uniforms[k, 0:12]`, `[k, 12]`), so one seeded buffer drives both sides
row for row.

Bounds are those of test_torch_interpret_draws.py, on its small system:
stream rows at rtol 5e-4 / atol 5e-3 on energies and 2e-3 A on positions
and torsions, with the accept and completed flags equal; the final chain
state at rtol 1e-2 / atol 5e-2 and 2e-2 A.  Each row is held against the
port's plain step from JAX's own chain head on that row's uniforms, as
chip_smoke.py [4] holds the CUDA kernel to the plain version: a one-ulp
change of a start moves the port's own window by up to hundreds of
kcal/mol a few rows on (the box penalty's slope of 1e3 kcal/mol/A and the
Armijo and Metropolis tests amplify float32 differences from row to row),
so two implementations' whole windows part the same way.  The windows
contain what the zero draw never reached: orientation mutations, torsion
redraws, Metropolis rejections and (K3) rows a lane never completed
within its tick budget.

JAX's interpreted kernel takes 25-45 s a window here, so the three JAX
runs (K3, K5, the driver) go to three processes at the module's start.
"""

import concurrent.futures
import multiprocessing
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnina_tpu.ops import pallas_dock as pd
from gnina_tpu_torch.constants import MAX_FL
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.ops import mc as tmc
from gnina_tpu_torch.ops import mc_fused as tmcf
from test_torch_interpret_draws import (HUNT, LANES, M_PAD, _torch_threads,
                                        make_system)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import jax_supplied_draws as sd  # noqa: E402

S_STEPS, MAXIT, TRIALS = 8, 2, 4
BUDGET = 4          # ticks a step: below the worst step's 1 + 2 x 4
WORST = 1 + MAXIT * TRIALS
SEED = 5
REFINE_SUBS, N_SAVED, WINDOWS = 2, 4, 2

__all__ = ["_torch_threads"]


# ---------------------------------------------------------------- stand-in

def two_block_kernel(draws: int):
    """test_interpreter_draws_only_zeros's kernel: two blocks, each seeding
    the TPU PRNG (seed + block) and drawing (8, 128) bits, `draws` times;
    its `pltpu` is pallas_dock's, so the proxy serves it."""
    def kernel(seed_ref, out_ref):
        pd.pltpu.prng_seed(seed_ref[0, 0] + pl.program_id(0))
        for i in range(draws):
            out_ref[pl.ds(8 * i, 8), :] = pd.pltpu.prng_random_bits(
                out_ref[pl.ds(8 * i, 8), :].shape)

    return pl.pallas_call(
        kernel, grid=(2,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((8 * draws, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((16 * draws, 128), jnp.int32),
        interpret=pltpu.InterpretParams())


def test_stand_in_serves_supplied_bits_in_order_and_runs_out():
    """Two calls of the two-block kernel, two (8, 128) draws a block, on
    four buffers of (2, 13, 128): block b of call c gets buffer 2c + b,
    its slabs in order (draw 0 = rows 0-7, draw 1 = rows 8-12 and 13-15 of
    the flattened buffer), exactly as uniforms; the real module is back
    afterwards.  A fifth block has no buffer and a block that draws past
    its buffer's end raises."""
    rng = np.random.default_rng(SEED)
    bufs = [sd.uniforms(rng, (2, sd.ROWS, 128)) for _ in range(4)]
    seed = jnp.full((1, 1), 12345, jnp.int32)
    with sd.supplied_draws(bufs) as feed:
        fn = two_block_kernel(2)
        calls = [np.asarray(pd.u01_from_bits(fn(seed))) for _ in range(2)]
        assert feed.served == [16] * 4
        for c, u in enumerate(calls):
            for b in range(2):
                np.testing.assert_array_equal(
                    u[16 * b:16 * (b + 1)],
                    bufs[2 * c + b].reshape(2 * sd.ROWS, 128)[:16])
        with pytest.raises(Exception, match="has no supplied buffer"):
            fn(seed).block_until_ready()
    assert pd.pltpu is pltpu
    short = [sd.uniforms(rng, (1, sd.ROWS, 128))] * 2
    with sd.supplied_draws(short):
        fn = two_block_kernel(2)
        with pytest.raises(Exception, match="past the end of its buffer"):
            fn(seed).block_until_ready()
    # bits map back onto the grid's uniforms, the sign bit included
    u = np.array([0.0, 0.5, 1.0 - 2.0 ** -24, 0.25], np.float32)
    np.testing.assert_array_equal(
        np.asarray(pd.u01_from_bits(jnp.asarray(sd.to_bits(u)))), u)


def test_stand_in_generator_serves_its_seeded_stream():
    """With a numpy Generator as the source (the quality sweep's
    jax_fused_drawn route), every draw is the generator's next block of
    uniforms on the kernel's grid, in block and call order, without end;
    the Feed counts the slabs of each block."""
    seed = jnp.full((1, 1), 7, jnp.int32)
    with sd.supplied_draws(np.random.default_rng(11)) as feed:
        fn = two_block_kernel(2)
        got = [np.asarray(pd.u01_from_bits(fn(seed))) for _ in range(3)]
    assert feed.served == [16] * 6
    ref = np.random.default_rng(11)
    want = [np.concatenate([sd.uniforms(ref, (8, 128)) for _ in range(4)])
            for _ in range(3)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (np.concatenate(got) > 0).mean() > 0.99


# -------------------------------------------------- JAX's side (processes)

def window_uniforms(draws: int, seed: int = SEED) -> np.ndarray:
    return sd.uniforms(np.random.default_rng(seed), (draws, sd.ROWS, LANES))


def driver_uniforms():
    """Two windows' uniforms, (S x budget, 13, L) each."""
    rng = np.random.default_rng(SEED + 1)
    return [sd.uniforms(rng, (S_STEPS * BUDGET, sd.ROWS, LANES))
            for _ in range(WINDOWS)]


def start_energy(system):
    """The starts' Metropolis energies (the port's K1 plain), handed to
    both sides as the driver's chain energies."""
    return fd.eval_fg_plain(system["terms"], system["rigid"],
                            system["tors"], scal_port(system, HUNT),
                            system["tpack"])[1].numpy()


def unpack_window(out, async_mc):
    """JAX kernel outputs (frig, ftor, fstats, fcoords, srig, stor, sstat)
    in the (rows, 128) layout -> the port's: rigid (L, 8), tors (L, M),
    stats (L, 8), srig (L, S, 8), stor (L, S, M), sstat (L, S, 3 or 2)."""
    frig, ftor, fstats, _, srig, stor, sstat = [np.asarray(x) for x in out]
    l_pad = frig.shape[-1]

    def stream(a, width):
        # async: component-major rows (c * S + j); lockstep: step-major
        # (j * width + c), pallas_dock.py:1303-1306
        if async_mc:
            a = a.reshape(width, S_STEPS, l_pad).transpose(1, 0, 2)
        return np.ascontiguousarray(a.reshape(S_STEPS, width, l_pad)
                                    [..., :LANES].transpose(2, 0, 1))

    return dict(rigid=frig[:, :LANES].T, tors=ftor[:, :LANES].T,
                stats=fstats[:, :LANES].T, srig=stream(srig, 8),
                stor=stream(stor, M_PAD),
                sstat=stream(sstat, 3 if async_mc else 2))


def lanes_to_jax(t, l_pad):
    """(L, C) -> the kernel's (C, 128) block layout."""
    a = np.asarray(t, np.float32).T
    return jnp.pad(jnp.asarray(a), ((0, 0), (0, l_pad - a.shape[1])))


def jax_window(system, async_mc):
    """JAX's kernel in an MC mode under the stand-in, from the system's
    starts, on window_uniforms: unpack_window's dict plus the slabs
    served."""
    u = window_uniforms(S_STEPS * BUDGET if async_mc else S_STEPS)
    l_pad = system["jpack"].lc.shape[-1]
    with sd.supplied_draws([u]) as feed:
        fused = pd.FusedBfgs(system["jsf"], system["jpack"], maxiters=MAXIT,
                             want_metro=True, interpret=True,
                             mc_steps=S_STEPS, async_mc=async_mc,
                             tick_budget=BUDGET, num_trials=TRIALS)
        scal = fused.scal(*HUNT, system["lo"], system["hi"])
        ecur = jnp.full((1, l_pad), 3.0e38, jnp.float32)
        out = fused.run_mc(lanes_to_jax(system["rigid"], l_pad),
                           lanes_to_jax(system["tors"], l_pad), scal, 7,
                           ecur)
        res = unpack_window(out, async_mc)
    res["served"] = feed.served
    return res


def jax_driver(system):
    """Two windows of JAX's fused_mc_chunk_inkernel (async, refine_subs 2)
    under the stand-in on driver_uniforms, from the system's starts and
    start_energy with empty containers.  Returns the final carry (numpy)
    and, per window, the kernel's inputs (rigid, tors, ecur in the port's
    layout) and unpack_window's dict, recorded by an ordered io_callback
    as the scan runs."""
    from gnina_tpu.ops import mc as jmc
    from gnina_tpu.ops import mc_fused as jmcf

    jsf, jpack, jlig = system["jsf"], system["jpack"], system["jlig"]
    l_pad = jpack.lc.shape[-1]
    tp, n_full = M_PAD - 1, jlig.num_atoms
    windows = []

    def record(rigid, tors, ecur, *out):
        w = unpack_window(out, True)
        w.update(rigid_in=rigid[:, :LANES].T, tors_in=tors[:, :LANES].T,
                 ecur_in=ecur[0, :LANES])
        windows.append(w)

    with sd.supplied_draws(driver_uniforms()):
        fused_mc = pd.FusedBfgs(jsf, jpack, maxiters=MAXIT, want_metro=True,
                                interpret=True, mc_steps=S_STEPS,
                                async_mc=True, tick_budget=BUDGET,
                                num_trials=TRIALS)
        fused_ref = pd.FusedBfgs(jsf, jpack, maxiters=MAXIT,
                                 want_metro=True, interpret=True,
                                 num_trials=TRIALS)

        class Recorded:
            m, mc_steps, async_mc = fused_mc.m, S_STEPS, True

            def run_mc(self, rigid, tors, scal, seed, ecur, pack=None):
                out = fused_mc.run_mc(rigid, tors, scal, seed, ecur,
                                      pack=pack)
                io_callback(record, None, rigid, tors, ecur, *out,
                            ordered=True)
                return out

        rigid, tors = (lanes_to_jax(system[k], l_pad) for k in ("rigid",
                                                                "tors"))
        conf = pd.packed_to_conf(rigid[:, :LANES], tors[:, :LANES], tp)
        e = jnp.asarray(start_energy(system))
        cont = jax.tree_util.tree_map(
            lambda a: jnp.broadcast_to(a, (LANES,) + a.shape),
            jmc.empty_container(N_SAVED, tp, n_full))
        carry = jmc.MCCarry(
            conf=conf, e=e, best_e=e, cont=cont,
            coords=jnp.zeros((LANES, n_full, 3), jnp.float32), pending=conf,
            pending_valid=jnp.zeros(LANES, bool),
            pending_is_current=jnp.zeros(LANES, bool))
        params = jmc.MCParams()
        hc = params.hunt_cap
        scal_h = fused_mc.scal(hc[0], hc[1], HUNT[2], HUNT[3], system["lo"],
                               system["hi"], params.mutation_amplitude,
                               params.temperature)
        scal_f = fused_mc.scal(1000.0, 1000.0, HUNT[2], 1000.0,
                               system["lo"], system["hi"])
        meta = jmcf.lane_meta([jlig], LANES, jpack, n_full)
        final = jmcf.fused_mc_chunk_inkernel(
            carry, jax.random.PRNGKey(0), WINDOWS * S_STEPS, Recorded(),
            fused_ref, jpack, scal_h, scal_f, meta, params, tp,
            refine_subs=REFINE_SUBS)
        final = jax.tree_util.tree_map(np.asarray, final)
    return dict(final=final, windows=windows,
                heavy_idx=np.asarray(meta.heavy_idx))


def jax_side(kind: str, rec_dir: str):
    """One JAX run, in a process of its own: "K3", "K5" or "driver"."""
    torch.set_num_threads(1)
    system = make_system(rec_dir)
    if kind == "driver":
        return jax_driver(system)
    return jax_window(system, kind == "K3")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The three JAX runs, started at once in three processes."""
    rec_dir = str(tmp_path_factory.mktemp("rec"))
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=ctx) as ex:
        futs = {k: ex.submit(jax_side, k, rec_dir)
                for k in ("K3", "K5", "driver")}
        yield futs


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    return make_system(tmp_path_factory.mktemp("rec"))


# ------------------------------------------------------------ port's side

def scal_port(system, v=HUNT):
    return fd.scal_vector(*v, system["lo"], system["hi"], device="cpu")


def replay_rows(system, async_mc, rigid0, tors0, ecur, stream, u,
                nudge=None):
    """Each row of a JAX window, from JAX's own chain head: the port's
    plain one-step window on the uniforms of the ticks (K3) or the step
    (K5) the row began at, as fd.replay_mc_window_plain /
    replay_lockstep_window_plain replay a kernel's window.  A K3 lane's
    ticks run on from row to row; its row completes within the window if
    its last tick is below S x BUDGET.  stream = JAX's (srig, stor, sstat)
    as tensors.  Returns per row (L, S): energy, position, torsions, the
    Metropolis decision JAX's energy and the row's uniform give,
    completion tick (-1: never), the mutated start and the chain head it
    was mutated from.  nudge = c moves every row's chain head one ulp
    along position axis c first (the rows' float32 conditioning)."""
    srig, stor, sstat = stream
    scal = scal_port(system)
    temp = scal[11]
    ix = torch.arange(LANES)
    crig, ctors, e_cur = rigid0, tors0, ecur.clone()
    tick = torch.zeros(LANES, dtype=torch.long)
    rows = {k: [] for k in ("e", "pos", "tors", "acc", "done", "start_rigid",
                            "start_tors", "head_rigid", "head_tors")}
    for j in range(S_STEPS):
        head = crig
        if nudge is not None:
            head = crig.clone()
            head[:, nudge] = torch.nextafter(head[:, nudge],
                                             torch.full_like(head[:, 0], 1e9))
        if async_mc:
            tk = torch.clamp(tick[None, :] + torch.arange(WORST)[:, None],
                             max=u.shape[0] - 1)
            u_j = u[tk, :, ix[None, :]].permute(0, 2, 1).contiguous()
            out = fd.async_mc_window_plain(
                system["terms"], head, ctors, scal, system["tpack"], e_cur,
                1, WORST, MAXIT, TRIALS, uniforms=u_j, trace=True)
            done = tick + out[2][:, 2].long() - 1
            u_met = u[torch.clamp(done, max=u.shape[0] - 1), 12, ix]
            complete = done < S_STEPS * BUDGET
        else:
            out = fd.lockstep_mc_window_plain(
                system["terms"], head, ctors, scal, system["tpack"], e_cur,
                1, MAXIT, TRIALS, uniforms=u[j:j + 1], trace=True)
            done = torch.full((LANES,), j)
            u_met = u[j, 12]
            complete = torch.ones(LANES, dtype=torch.bool)
        ek = sstat[:, j, 0]
        rows["e"].append(out[6][:, 0, 0])
        rows["pos"].append(out[4][:, 0, :3])
        rows["tors"].append(out[5][:, 0])
        rows["acc"].append(complete & ((ek < e_cur) | (
            u_met < torch.exp((e_cur - ek) / temp))))
        rows["done"].append(torch.where(complete, done, -1))
        rows["start_rigid"].append(out[-1]["start_rigid"][:, 0])
        rows["start_tors"].append(out[-1]["start_tors"][:, 0])
        rows["head_rigid"].append(head)
        rows["head_tors"].append(ctors)
        kacc = (sstat[:, j, 1] > 0.5) & complete
        crig = torch.where(kacc[:, None], srig[:, j], crig)
        ctors = torch.where(kacc[:, None], stor[:, j], ctors)
        e_cur = torch.where(kacc, ek, e_cur)
        tick = done + 1
    return {k: torch.stack(v, 1) for k, v in rows.items()}


def conditioning(system, async_mc, rigid0, tors0, ecur, stream, u, rep):
    """Per row (L, S), how far the port's own step moves when its chain
    head moves one ulp along each position axis: the largest change of
    energy, position and torsions over the three moves."""
    moved = [replay_rows(system, async_mc, rigid0, tors0, ecur, stream, u,
                         nudge=c) for c in range(3)]
    return {k: np.max([(m[k] - rep[k]).abs().reshape(
        rep[k].shape[:2] + (-1,)).amax(-1).numpy() for m in moved], 0)
        for k in ("e", "pos", "tors")}


def assert_rows_close(got, want, cond, done, rtol, atol):
    """got ~ want on the completed rows at rtol/atol widened by twice the
    row's conditioning (cond (L, S)); a well-conditioned row keeps the
    stated bound."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).reshape(got.shape[:2] + (-1,)).max(-1)
    bound = atol + rtol * np.abs(want).reshape(
        want.shape[:2] + (-1,)).max(-1) + 2.0 * cond
    bad = done & ~(err <= bound)
    assert not bad.any(), (
        f"rows {np.argwhere(bad).tolist()}: |diff| {err[bad]} over "
        f"{bound[bad]} (conditioning {cond[bad]})")


def check_rows(system, async_mc, rigid0, tors0, ecur, w, u):
    """Every row of JAX's window w (unpack_window's dict) against the
    port's replay from JAX's chain heads: completion flags and the lanes'
    active ticks (K3) and Metropolis decisions equal; energies, positions
    and torsions at the one-iteration bound, widened by twice the row's
    float32 conditioning (a row whose chain head, moved by one ulp, moves
    the port's own step by c is held at bound + 2c); JAX's final chain
    state is its last accepted row at the three-iteration bound.  Returns
    the replay and the completed rows (L, S)."""
    t = lambda a: torch.as_tensor(np.array(a))
    args = (system, async_mc, t(rigid0), t(tors0), t(ecur),
            (t(w["srig"]), t(w["stor"]), t(w["sstat"])), t(u))
    rep = replay_rows(*args)
    cond = conditioning(*args, rep)
    sstat = w["sstat"]
    if async_mc:
        done = sstat[..., 2] > 0.5
        np.testing.assert_array_equal(done, (rep["done"] >= 0).numpy())
        # a lane is active until its last step completes or the budget ends
        last = torch.where(torch.as_tensor(done.all(1)),
                           rep["done"][:, -1] + 1, S_STEPS * BUDGET)
        np.testing.assert_array_equal(w["stats"][:, 2], last.numpy())
    else:
        done = np.ones(sstat.shape[:2], bool)
    np.testing.assert_array_equal(sstat[..., 1] > 0.5, rep["acc"].numpy())
    assert_rows_close(sstat[..., 0], rep["e"].numpy(), cond["e"], done,
                      5e-4, 5e-3)
    assert_rows_close(w["srig"][..., :3], rep["pos"].numpy(), cond["pos"],
                      done, 0.0, 2e-3)
    assert_rows_close(w["stor"], rep["tors"].numpy(), cond["tors"], done,
                      0.0, 2e-3)
    accd = (sstat[..., 1] > 0.5) & done
    has = accd.any(1)
    last_acc = np.where(has, S_STEPS - 1 - np.argmax(accd[:, ::-1], 1), 0)
    lane = np.arange(LANES)
    np.testing.assert_allclose(w["stats"][has, 0],
                               rep["e"].numpy()[lane, last_acc][has],
                               rtol=1e-2, atol=5e-2)
    np.testing.assert_allclose(w["rigid"][has, :3],
                               rep["pos"].numpy()[lane, last_acc][has],
                               atol=2e-2)
    np.testing.assert_allclose(w["tors"][has],
                               rep["tors"].numpy()[lane, last_acc][has],
                               atol=2e-2)
    return rep, done


def check_first_rows(own, rep, w, async_mc):
    """The port's whole window from JAX's start: its first rows are the
    replay's first rows bit for bit, flags included."""
    s = own[6]
    if async_mc:
        np.testing.assert_array_equal(s[:, 0, 2].numpy(), w["sstat"][:, 0, 2])
    np.testing.assert_array_equal(s[:, 0, 1].numpy(), w["sstat"][:, 0, 1])
    assert torch.equal(s[:, 0, 0], rep["e"][:, 0])
    assert torch.equal(own[4][:, 0, :3], rep["pos"][:, 0])
    assert torch.equal(own[5][:, 0], rep["tors"][:, 0])


def mutation_kinds(rep, done):
    """Per stream row, what its mutation moved: the start the row's BFGS
    ran from against the chain head it was mutated from.  Boolean (L, S)
    arrays pos, ori, tor; rows never completed (`done` False) are
    False."""
    hr, sr = rep["head_rigid"], rep["start_rigid"]
    pos = done & (sr[..., :3] != hr[..., :3]).any(-1).numpy()
    ori = done & (sr[..., 3:7] != hr[..., 3:7]).any(-1).numpy()
    tor = done & (rep["start_tors"] != rep["head_tors"]).any(-1).numpy()
    return pos, ori, tor


def check_coverage(rep, done, sstat):
    """What the zero draw never reached: orientation mutations, torsion
    redraws, Metropolis rejections; every completed row moved one kind of
    degree of freedom."""
    pos, ori, tor = mutation_kinds(rep, done)
    assert ori.any(), "no orientation mutation"
    assert tor.any(), "no torsion redraw"
    assert ((sstat[..., 1] < 0.5) & done).any(), "no Metropolis rejection"
    assert ((pos.astype(int) + ori + tor) == done).all()


@pytest.mark.parametrize("async_mc", [True, False], ids=["K3", "K5"])
def test_plain_window_on_supplied_draws_is_the_interpreted_kernel(
        system, jax_runs, async_mc):
    """K3 (async_mc, a tick budget of 4 a step that lanes run out of) and
    K5 (lockstep): the port against JAX's interpreted kernel on the same
    seeded non-zero uniforms, S = 8 steps of up to 2 BFGS iterations.
    Every row JAX streamed against the port's plain step from JAX's own
    chain head (check_rows); the port's whole window from the same starts
    gives JAX's first rows; the kernel drew 13 uniforms a tick while any
    lane was active (K3) or a step (K5)."""
    w = jax_runs["K3" if async_mc else "K5"].result()
    draws = S_STEPS * BUDGET if async_mc else S_STEPS
    u = window_uniforms(draws)
    ecur = np.full(LANES, 3.0e38, np.float32)
    rep, done = check_rows(system, async_mc, system["rigid"].numpy(),
                           system["tors"].numpy(), ecur, w, u)
    ticks = int(w["stats"][:, 2].max()) if async_mc else S_STEPS
    assert w["served"] == [ticks * sd.ROWS]
    if async_mc:
        assert not done.all(), "no lane ran out of its budget"
    ut, et = torch.as_tensor(u), torch.as_tensor(ecur)
    if async_mc:
        own = fd.async_mc_window_plain(
            system["terms"], system["rigid"], system["tors"],
            scal_port(system), system["tpack"], et, S_STEPS, BUDGET, MAXIT,
            TRIALS, uniforms=ut)
    else:
        own = fd.lockstep_mc_window_plain(
            system["terms"], system["rigid"], system["tors"],
            scal_port(system), system["tpack"], et, S_STEPS, MAXIT, TRIALS,
            uniforms=ut)
    check_first_rows(own, rep, w, async_mc)
    check_coverage(rep, done, w["sstat"])


class FedWindows:
    """The port driver's fused_mc: run_mc runs the port's own window
    (FusedBfgs.run_mc on window k's uniforms), keeps it, and hands the
    driver JAX's window k, so the host bookkeeping runs on the stream
    JAX's bookkeeping ran on."""

    def __init__(self, fused, jax_windows, uniforms, pack):
        self.fused, self.jw, self.u, self.pack = (fused, jax_windows,
                                                  uniforms, pack)
        self.m, self.mc_steps, self.async_mc = fused.m, S_STEPS, True
        self.own = []

    def run_mc(self, rigid, tors, scal, seed, ecur):
        k = len(self.own)
        self.own.append(self.fused.run_mc(rigid, tors, scal, seed, ecur,
                                          uniforms=torch.as_tensor(
                                              self.u[k])))
        t = lambda a: torch.as_tensor(np.array(a))
        w = self.jw[k]
        rig, tor = t(w["rigid"]), t(w["tors"])
        return (rig, tor, t(w["stats"]), fd.fk_packed(rig, tor, self.pack),
                t(w["srig"]), t(w["stor"]), t(w["sstat"]))


def test_mc_driver_on_supplied_draws_is_jax_driver(system, jax_runs):
    """Two windows of fused_mc_chunk_inkernel (S = 8, budget 4, 2 BFGS
    iterations, refine_subs = 2, containers of 4), port against JAX on the
    same per-window uniforms from the same starts and energies.  JAX's
    windows were recorded as its scan ran.  Each window's rows against the
    port's plain steps from JAX's chain heads (check_rows), and the port's
    FusedBfgs.run_mc on the window's uniforms gives the first window's
    first rows.  The port's driver, handed JAX's windows, ends where JAX's
    did: the chain state, chain energies and best energies at the
    three-iteration bound (the refinements are K2 at full v from the same
    poses), the merged containers' energies, poses and heavy-atom
    coordinates too."""
    res = jax_runs["driver"].result()
    us = driver_uniforms()
    jw = res["windows"]
    assert len(jw) == WINDOWS
    reps = []
    for k, w in enumerate(jw):
        rep, done = check_rows(system, True, w["rigid_in"], w["tors_in"],
                               w["ecur_in"], w, us[k])
        check_coverage(rep, done, w["sstat"])
        reps.append(rep)
    assert not np.all([w["sstat"][..., 2] > 0.5 for w in jw])

    pack, tp = system["tpack"], M_PAD - 1
    fused_mc = fd.FusedBfgs(system["tsf"], pack, MAXIT, mc_steps=S_STEPS,
                            num_trials=TRIALS, tick_budget=BUDGET)
    fused_ref = fd.FusedBfgs(system["tsf"], pack, MAXIT, num_trials=TRIALS)
    fed = FedWindows(fused_mc, jw, us, pack)
    params = tmc.MCParams()
    hc = params.hunt_cap
    scal_h = fd.scal_vector(hc[0], hc[1], HUNT[2], HUNT[3], system["lo"],
                            system["hi"], params.mutation_amplitude,
                            params.temperature, device="cpu")
    scal_f = scal_port(system, (1000.0, 1000.0, HUNT[2], 1000.0))
    e = torch.as_tensor(start_energy(system))
    rigid, tors = system["rigid"], system["tors"]
    carry = tmc.MCCarry(
        rigid=rigid, tors=tors, e=e, best_e=e.clone(),
        cont=tmc.empty_container((LANES,), N_SAVED, tp, pack.dims[0],
                                 "cpu"),
        coords=fd.fk_packed(rigid, tors, pack), pending_rigid=rigid,
        pending_tors=tors, pending_valid=torch.zeros(LANES, dtype=torch.bool),
        pending_is_current=torch.zeros(LANES, dtype=torch.bool))
    with torch.no_grad():
        out = tmcf.fused_mc_chunk_inkernel(
            carry, None, WINDOWS * S_STEPS, fed, fused_ref, pack, scal_h,
            scal_f, tmcf.lane_meta(pack), params, tp,
            refine_subs=REFINE_SUBS, seeds=[0] * WINDOWS)
    check_first_rows(fed.own[0], reps[0], jw[0], True)

    jf = res["final"]
    close = dict(rtol=1e-2, atol=5e-2)
    np.testing.assert_allclose(out.rigid[:, :3].numpy(), jf.conf.position,
                               atol=2e-2)
    np.testing.assert_allclose(out.rigid[:, 3:7].numpy(),
                               jf.conf.orientation, atol=2e-2)
    np.testing.assert_allclose(out.tors[:, 1:].numpy(), jf.conf.torsions,
                               atol=2e-2)
    np.testing.assert_allclose(out.e.numpy(), jf.e, **close)
    np.testing.assert_allclose(out.best_e.numpy(), jf.best_e, **close)
    jc, tc = jf.cont, out.cont
    filled = jc.energy < MAX_FL
    np.testing.assert_array_equal(tc.energy.numpy() < MAX_FL, filled)
    assert filled.sum(1).min() >= 2
    np.testing.assert_allclose(tc.energy.numpy()[filled], jc.energy[filled],
                               **close)
    for name in ("position", "orientation", "torsions"):
        np.testing.assert_allclose(getattr(tc, name).numpy()[filled],
                                   getattr(jc, name)[filled], atol=2e-2)
    hidx = res["heavy_idx"]                      # (L, NH) -> full index
    nh = int((hidx[0] >= 0).sum())
    jheavy = np.take_along_axis(
        jc.coords, hidx[:, None, :nh, None].clip(0), axis=2)
    np.testing.assert_allclose(tc.coords.numpy()[:, :, :nh][filled],
                               jheavy[filled], atol=2e-2)
