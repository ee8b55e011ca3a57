"""The CUDA kernels of csrc/fused_dock.cu against their plain versions, on
a card.  Imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Without a card every test skips (marker `cuda`).  The plain versions
themselves are held against the JAX package in test_torch_fused_dock.py.
"""

import ctypes

import numpy as np
import pytest
import torch

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem.ingest import box_from_center_size
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.scoring.builtin import get_scoring_function

pytestmark = pytest.mark.cuda
LANES, M = 32, 4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def system(card):
    rec, lig, center, size = fx.system(seed=3, box=16.0, cube=30.0)
    sf = get_scoring_function("vina")
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    pack = fd.build_pack([lig, lig], pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), LANES // 2,
                         sf.table, m_pad=M, device=card)
    lo, hi = box_from_center_size(center, size)
    scal = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, device=card)
    return dict(lig=lig, pack=pack, lo=lo, hi=hi, scal=scal,
                terms=fd.extract_vina_terms(sf), dev=card)


def _poses(system, kind, seed):
    return fx.packed_poses(np.random.default_rng(seed), LANES, system["lo"],
                           system["hi"], system["lig"], M, system["dev"],
                           kind)


def _close(a, b, rtol, atol):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_eval_fg_kernel(system, kind):
    """K1 vs eval_fg_plain: e, e_metro within rtol 2e-4 / atol 2e-3; the
    gradient within rtol 1e-3 / atol 1e-2 on physical poses; coords within
    1e-4 A; one launch counted."""
    r, t = _poses(system, kind, 1)
    before = fd.eval_fg.launches
    got = fd.eval_fg(system["terms"], r, t, system["scal"], system["pack"])
    torch.cuda.synchronize()
    assert fd.eval_fg.launches == before + 1
    ref = fd.eval_fg_plain(system["terms"], r, t, system["scal"],
                           system["pack"])
    _close(got[0], ref[0], 2e-4, 2e-3)
    _close(got[1], ref[1], 2e-4, 2e-3)
    if kind == "perturbed":
        _close(got[2], ref[2], 1e-3, 1e-2)
    _close(got[3], ref[3], 0, 1e-4)


@pytest.mark.parametrize("iters,rtol,atol", [(1, 5e-4, 5e-3),
                                             (3, 1e-2, 5e-2)])
def test_bfgs_kernel(system, iters, rtol, atol):
    r, t = _poses(system, "perturbed", 2)
    got = fd.bfgs_minimize(system["terms"], r, t, system["scal"],
                           system["pack"], iters)
    torch.cuda.synchronize()
    ref = fd.bfgs_minimize_plain(system["terms"], r, t, system["scal"],
                                 system["pack"], iters)
    _close(got[2][:, :2], ref[2][:, :2], rtol, atol)


def test_async_mc_kernel_on_supplied_uniforms(system):
    """K3 with supplied uniforms runs the plain version's window: the same
    completion flags and first steps (same start on both sides, the K2
    one-iteration bound, rtol 5e-4 / atol 5e-3 and 2e-3 A); every row
    within that bound of the plain step from the kernel's own chain head
    (whose float32 differences from the plain window's grow row by row),
    with the Metropolis decisions its own energies and uniforms give and
    the plain step's ticks."""
    r, t = _poses(system, "perturbed", 3)
    s_steps, maxit = 4, 1
    budget = 1 + maxit * fd.NUM_TRIALS
    rng = np.random.default_rng(4)
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, LANES),
                                     dtype=np.float32), device=system["dev"])
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    args = (system["terms"], r, t, system["scal"], system["pack"], ecur,
            s_steps, budget, maxit)
    got = fd.async_mc_window(*args, uniforms=uni)
    torch.cuda.synchronize()
    ref = fd.async_mc_window_plain(*args, uniforms=uni)
    assert torch.equal(got[6][..., 2], ref[6][..., 2])
    _close(got[6][:, 0, 0], ref[6][:, 0, 0], 5e-4, 5e-3)
    _close(got[4][:, 0, :3], ref[4][:, 0, :3], 0, 2e-3)
    e, pos, acc, ticks = fd.replay_mc_window_plain(
        system["terms"], r, t, system["scal"], system["pack"], ecur,
        got[4:], uni)
    _close(got[6][..., 0], e, 5e-4, 5e-3)
    _close(got[4][..., :3], pos, 0, 2e-3)
    assert torch.equal(got[6][..., 1] > 0.5, acc)
    assert torch.equal(ticks, got[2][:, 2].long())


@pytest.fixture(scope="module")
def big_system(card):
    """A receptor above the shared-memory budget: a 34 A box in a 60 A cube
    keeps about 6,150 atoms after pruning, which stream through tiles."""
    rec, lig, center, size = fx.system(seed=3, box=34.0, cube=60.0)
    sf = get_scoring_function("vina")
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    pack = fd.build_pack([lig, lig], pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), LANES // 2,
                         sf.table, m_pad=M, device=card)
    n, m, _, k, _ = pack.dims
    plan = fd.smem_plan(n, m, 6 + m - 1, k)
    assert not plan.resident and plan.n_tiles >= 3
    lo, hi = box_from_center_size(center, size)
    scal = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, device=card)
    return dict(lig=lig, pack=pack, lo=lo, hi=hi, scal=scal,
                terms=fd.extract_vina_terms(sf), dev=card)


@pytest.mark.parametrize("kind", ["random", "perturbed"])
def test_eval_fg_kernel_streamed_receptor(big_system, kind):
    """K1 with the receptor streamed through shared-memory tiles: the same
    bounds as at the resident size."""
    test_eval_fg_kernel(big_system, kind)


def test_async_mc_kernel_streamed_receptor(big_system):
    """K3 with the receptor streamed through shared-memory tiles, on
    supplied uniforms: the same checks as at the resident size."""
    test_async_mc_kernel_on_supplied_uniforms(big_system)


def test_async_mc_kernel_philox_window(system):
    """A window on the kernel's own draws: 0/1 flags, accepts only on
    completed rows, completed rows first, finite energies; the same seed
    gives the same window."""
    r, t = _poses(system, "random", 5)
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    args = (system["terms"], r, t, system["scal"], system["pack"], ecur,
            16, 16, 4)
    a = fd.async_mc_window(*args, seed=11)
    b = fd.async_mc_window(*args, seed=11)
    torch.cuda.synchronize()
    st = a[6]
    flags, acc = st[..., 2], st[..., 1]
    assert ((flags == 0) | (flags == 1)).all()
    assert not ((acc > 0) & (flags == 0)).any()
    assert torch.isfinite(st[..., 0][flags > 0]).all()
    assert torch.equal(torch.cumprod(flags, 1).sum(1), flags.sum(1))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_async_bfgs_kernel_is_the_lockstep_search(system):
    """K4 (async_ls) vs its plain version within the K2 bounds at 3
    iterations, and against K2 itself on the same starts: with one block
    per pose both walk the same trial points, so the final energies agree
    to 1e-4 and the counters relate as pallas_dock.py:888-889 (row 2: one
    tick per trial; row 3: accepts)."""
    r, t = _poses(system, "perturbed", 7)
    args = (system["terms"], r, t, system["scal"], system["pack"], 3)
    before = dict(fd.bfgs_minimize.launches_by_mode)
    k4 = fd.bfgs_minimize(*args, async_ls=True)
    k2 = fd.bfgs_minimize(*args)
    torch.cuda.synchronize()
    assert fd.bfgs_minimize.launches_by_mode[True] == before.get(True, 0) + 1
    ref = fd.bfgs_minimize_plain(*args, async_ls=True)
    _close(k4[2][:, :2], ref[2][:, :2], 1e-2, 5e-2)
    same = (k4[2][:, 2] == k2[2][:, 2])
    assert same.float().mean() > 0.9
    _close(k4[2][same, :2], k2[2][same, :2], 0, 1e-4)
    _close(k4[0][same], k2[0][same], 0, 1e-5)
    assert torch.equal(k4[2][same, 3], k2[2][same, 4])


def test_warm_ls_flag_off_is_the_cold_window(system):
    """K6: with warm_ls off the window is bit-identical to the default call;
    with it on, every row is within the 3-iteration bound of the plain step
    (warm schedule) from the kernel's own chain head on lanes that took the
    same ticks."""
    r, t = _poses(system, "perturbed", 8)
    s_steps, maxit = 4, 2
    budget = 1 + maxit * fd.NUM_TRIALS
    rng = np.random.default_rng(9)
    uni = torch.as_tensor(rng.random((s_steps * budget, fd.N_DRAWS, LANES),
                                     dtype=np.float32), device=system["dev"])
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    args = (system["terms"], r, t, system["scal"], system["pack"], ecur,
            s_steps, budget, maxit)
    cold = fd.async_mc_window(*args, uniforms=uni)
    off = fd.async_mc_window(*args, uniforms=uni, warm_ls=False)
    warm = fd.async_mc_window(*args, uniforms=uni, warm_ls=True)
    torch.cuda.synchronize()
    for x, y in zip(cold, off):
        assert torch.equal(x, y)
    assert (warm[6][..., 2] == 1).all()
    e, pos, acc, ticks = fd.replay_mc_window_plain(
        system["terms"], r, t, system["scal"], system["pack"], ecur,
        warm[4:], uni, maxiters=maxit, warm_ls=True)
    same = ticks == warm[2][:, 2].long()
    assert same.float().mean() >= 0.9
    _close(warm[6][same][..., 0], e[same], 1e-2, 5e-2)
    assert torch.equal(warm[6][same][..., 1] > 0.5, acc[same])


@pytest.mark.parametrize("async_ls", [False, True])
def test_lockstep_mc_kernel_on_supplied_uniforms(system, async_ls):
    """K5 on supplied uniforms: every stream row within the K2
    one-iteration bound (rtol 5e-4 / atol 5e-3, 2e-3 A) of the plain step
    from the kernel's own chain head, on rows whose trial counts agree (at
    least 95% of them); Metropolis decisions as its own energies and
    uniforms give; the final state is the last accepted row; the
    coordinates are those of the plain last step's last evaluation (1e-2
    A: under async_ls that can be a rejected trial point)."""
    r, t = _poses(system, "perturbed", 10)
    s_steps, maxit = 4, 1
    rng = np.random.default_rng(11)
    uni = torch.as_tensor(rng.random((s_steps, fd.N_DRAWS, LANES),
                                     dtype=np.float32), device=system["dev"])
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    before = fd.lockstep_mc_window.launches
    got = fd.lockstep_mc_window(system["terms"], r, t, system["scal"],
                                system["pack"], ecur, s_steps, maxit,
                                async_ls=async_ls, uniforms=uni)
    torch.cuda.synchronize()
    assert fd.lockstep_mc_window.launches == before + 1
    e, pos, trials, acc, coords, _ = fd.replay_lockstep_window_plain(
        system["terms"], r, t, system["scal"], system["pack"], ecur, got[4:],
        uni, maxit, async_ls=async_ls)
    same = trials == got[6][..., 2]
    assert same.float().mean() >= 0.95
    _close(got[6][..., 0][same], e[same], 5e-4, 5e-3)
    _close(got[4][..., :3][same], pos[same], 0, 2e-3)
    assert torch.equal(got[6][..., 1] > 0.5, acc)
    assert torch.equal(got[6][..., 2].sum(1), got[2][:, 2])
    _close(got[3][same[:, -1]], coords[same[:, -1]], 0, 1e-2)
    for l in range(LANES):
        j = int(torch.nonzero(got[6][l, :, 1] > 0)[-1])
        assert torch.equal(got[0][l], got[4][l, j])
        assert got[2][l, 0] == got[6][l, j, 0]


def test_lockstep_mc_kernel_philox_window(system):
    """A K5 window on the kernel's own draws: the same seed gives the same
    window, another seed another; energies finite; accepts 0/1."""
    r, t = _poses(system, "random", 12)
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    args = (system["terms"], r, t, system["scal"], system["pack"], ecur,
            8, 4)
    a = fd.lockstep_mc_window(*args, seed=11)
    b = fd.lockstep_mc_window(*args, seed=11)
    c = fd.lockstep_mc_window(*args, seed=12)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[4], c[4])
    assert torch.isfinite(a[6][..., 0]).all()
    assert ((a[6][..., 1] == 0) | (a[6][..., 1] == 1)).all()
    assert (a[6][:, 0, 1] == 1).all()


def _eval_value_only(sys_, r, t):
    """K1 without its gradient output (a null pointer): the value-only
    evaluation a lockstep Armijo trial runs.  Returns (e, e_metro,
    coords)."""
    from gnina_tpu_torch.ops import _cuda

    pk, dev = sys_["pack"], sys_["dev"]
    e = torch.empty(pk.lanes, dtype=torch.float32, device=dev)
    em = torch.empty_like(e)
    coords = torch.empty((pk.lanes, pk.dims[0], 3), dtype=torch.float32,
                         device=dev)
    pa, ta = fd._pack_args(pk, r.device), fd._term_args(sys_["terms"])
    made = ctypes.c_int(0)
    code = _cuda.lib().gt_eval_fg(
        fd._addr(pa), fd._addr(ta), fd._ptr(r), fd._ptr(t),
        fd._ptr(sys_["scal"]), fd._ptr(e), fd._ptr(em), fd._ptr(None),
        fd._ptr(coords), fd._stream(), ctypes.byref(made))
    assert code == 0 and made.value == 1
    return e, em, coords


@pytest.mark.parametrize("kind", ["random", "perturbed"])
@pytest.mark.parametrize("receptor", ["resident", "streamed"])
def test_value_only_energies_are_the_gradient_evaluations(
        system, big_system, kind, receptor):
    """The energy and Metropolis energy of a value-only evaluation equal,
    bit for bit, those of a value+gradient evaluation of the same poses
    (the same pair sums in the same order): a lockstep Armijo trial
    evaluated with its gradient decides as the value-only trial would, and
    an accepted one needs no second evaluation.  With the receptor resident
    in shared memory and streamed through tiles."""
    sys_ = system if receptor == "resident" else big_system
    r, t = fx.packed_poses(np.random.default_rng(11), sys_["pack"].lanes,
                           sys_["lo"], sys_["hi"], sys_["lig"], M,
                           sys_["dev"], kind)
    e, em, coords = _eval_value_only(sys_, r, t)
    got = fd.eval_fg(sys_["terms"], r, t, sys_["scal"], sys_["pack"])
    torch.cuda.synchronize()
    assert torch.equal(e, got[0]) and torch.equal(em, got[1])
    assert torch.equal(coords, got[3])
    assert bool(torch.isfinite(e).all())


def test_wrappers_check_their_inputs(system):
    r, t = _poses(system, "random", 6)
    with pytest.raises(ValueError, match="shape"):
        fd.eval_fg(system["terms"], r[:-1], t, system["scal"],
                   system["pack"])
    with pytest.raises(TypeError, match="dtype"):
        fd.eval_fg(system["terms"], r.double(), t, system["scal"],
                   system["pack"])


# ---------------------------------------------------------------- K8 ----

@pytest.mark.parametrize("async_ls", [False, True])
@pytest.mark.parametrize("done_frac", [0.5, 0.9])
def test_group_stop_kernel(system, async_ls, done_frac):
    """K8 in k_bfgs vs the plain version on 32 lanes (one group with 96
    counted padding lanes), half the lanes from minima: the group's
    iteration count equal, one count for the whole group, energies within
    the K2 three-iteration bound on lanes with the same trial counts (at
    least 30 of 32), the barrier words' done counts by iteration the
    plain version's, two launches bit-equal, 1.0 bit-equal to the uncoupled
    launch."""
    r, t = _poses(system, "perturbed", 8)
    rm, tm = fd.bfgs_minimize(system["terms"], r, t, system["scal"],
                              system["pack"], 30)[:2]
    half = LANES // 2
    r = torch.cat([rm[:half], r[half:]]).contiguous()
    t = torch.cat([tm[:half], t[half:]]).contiguous()
    args = (system["terms"], r, t, system["scal"], system["pack"], 3)
    before = fd.bfgs_minimize.launches_coupled
    kv, pv = [], []
    got = fd.bfgs_minimize(*args, async_ls=async_ls, done_frac=done_frac,
                           votes=kv)
    again = fd.bfgs_minimize(*args, async_ls=async_ls, done_frac=done_frac)
    torch.cuda.synchronize()
    assert fd.bfgs_minimize.launches_coupled == before + 2
    ref = fd.bfgs_minimize_plain(*args, async_ls=async_ls,
                                 done_frac=done_frac, votes=pv)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    gi = got[2][:, 5]
    assert bool((gi == gi[0]).all()) and torch.equal(gi, ref[2][:, 5])
    # the barrier words: the group met at the iterations it ran and at no
    # other, with the plain version's done counts but for lanes whose
    # Armijo test fell the other way (at most 2)
    assert kv[0].shape == pv[0].shape and kv[0].shape[0] == 1
    assert torch.equal(kv[0] >= 0, pv[0] >= 0)
    assert int((kv[0] >= 0).sum()) == int(gi[0])
    assert int((kv[0] - pv[0]).abs().max()) <= 2
    same = (got[2][:, 2] == ref[2][:, 2]) & (got[2][:, 4] == ref[2][:, 4])
    assert int(same.sum()) >= LANES - 2
    _close(got[2][same, 0], ref[2][same, 0], 1e-2, 5e-2)
    free = fd.bfgs_minimize(*args, async_ls=async_ls)
    one = fd.bfgs_minimize(*args, async_ls=async_ls, done_frac=1.0)
    assert all(torch.equal(a, b) for a, b in zip(free, one))
    assert bool((free[2][:, 5] == 0).all())


def test_group_stop_rolls_back_poses_past_the_stop(system):
    """K8 without the per-iteration wait, on one full group (128 lanes,
    half from minima, half jittered) at done_frac 0.5: a pose runs on past
    its group's stop and takes its state at the stop back from the ring.
    At the main path's 14 iterations some lane must have run past the stop
    in one of the two line-search modes (the wrapper's `overrun`); in
    lockstep mode every lane then equals, bit for bit, the uncoupled kernel
    cut at the group's stop (maxiters = the stop), and two launches are
    bit-equal.  At 3 iterations the stop and the done counts equal the
    plain version's, and the energies are within the K2 three-iteration
    bound on lanes with the same trial counts."""
    dev = system["dev"]
    pk = system["pack"].with_lanes(torch.arange(
        2, device=dev, dtype=torch.int32).repeat_interleave(64))
    r, t = fx.packed_poses(np.random.default_rng(12), 128, system["lo"],
                           system["hi"], system["lig"], M, dev, "perturbed")
    rm, tm = fd.bfgs_minimize(system["terms"], r, t, system["scal"], pk,
                              30)[:2]
    r = torch.cat([rm[:64], r[64:]]).contiguous()
    t = torch.cat([tm[:64], t[64:]]).contiguous()
    args = (system["terms"], r, t, system["scal"], pk)
    rolled = 0
    for async_ls in (False, True):
        got = fd.bfgs_minimize(*args, 14, async_ls=async_ls, done_frac=0.5)
        over = fd.bfgs_minimize.overrun
        again = fd.bfgs_minimize(*args, 14, async_ls=async_ls, done_frac=0.5)
        torch.cuda.synchronize()
        assert over.shape == (128,) and bool((over >= 0).all())
        rolled += int((over > 0).sum())
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        stop = got[2][:, 5]
        assert bool((stop == stop[0]).all())
        if not async_ls:
            cut = fd.bfgs_minimize(*args, int(stop[0]))
            torch.cuda.synchronize()
            assert torch.equal(cut[0], got[0]) and torch.equal(cut[1], got[1])
            assert torch.equal(cut[2][:, :5], got[2][:, :5])
        kv, pv = [], []
        got3 = fd.bfgs_minimize(*args, 3, async_ls=async_ls, done_frac=0.5,
                                votes=kv)
        torch.cuda.synchronize()
        ref3 = fd.bfgs_minimize_plain(*args, 3, async_ls=async_ls,
                                      done_frac=0.5, votes=pv)
        assert torch.equal(got3[2][:, 5], ref3[2][:, 5])
        assert torch.equal(kv[0] >= 0, pv[0] >= 0)
        assert int((kv[0] - pv[0]).abs().max()) <= 2
        same = ((got3[2][:, 2] == ref3[2][:, 2])
                & (got3[2][:, 4] == ref3[2][:, 4]))
        assert int(same.sum()) >= 126
        _close(got3[2][same, 0], ref3[2][same, 0], 1e-2, 5e-2)
    assert rolled > 0


def _bfgs_instances(fn):
    """The blocks-an-SM template argument of every k_bfgs launch fn makes,
    from torch.profiler's kernel names (demangled or not)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()
             if ev.device_type == DeviceType.CUDA and "k_bfgs" in ev.name]
    return out, {2 if (", 2>" in n or "Li2E" in n) else 1 for n in names}


@pytest.mark.parametrize("async_ls", [False, True])
@pytest.mark.parametrize("done_frac", [1.0, 0.5])
def test_bfgs_instances_give_the_same_bits(system, async_ls, done_frac):
    """k_bfgs is built for one pose block an SM (128 registers) and for two
    (64), and a launch with more lanes than the card has SMs takes the
    second: 128 poses (half from minima, half jittered) give, bit for bit,
    what the first 128 lanes of such a launch of the same poses repeated
    give, uncoupled and under K8 (whole 128-lane groups, so every group
    meets the same stop)."""
    dev = system["dev"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    copies = sms // 128 + 1
    lig_of = torch.arange(2, device=dev, dtype=torch.int32) \
        .repeat_interleave(64)
    pk = system["pack"].with_lanes(lig_of)
    pk_big = system["pack"].with_lanes(lig_of.repeat(copies))
    r, t = fx.packed_poses(np.random.default_rng(13), 128, system["lo"],
                           system["hi"], system["lig"], M, dev, "perturbed")
    rm, tm = fd.bfgs_minimize(system["terms"], r, t, system["scal"], pk,
                              30)[:2]
    r = torch.cat([rm[:64], r[64:]]).contiguous()
    t = torch.cat([tm[:64], t[64:]]).contiguous()
    kw = dict(async_ls=async_ls, done_frac=done_frac)
    one, kinds = _bfgs_instances(lambda: fd.bfgs_minimize(
        system["terms"], r, t, system["scal"], pk, 14, **kw))
    assert kinds == {1}
    big, kinds = _bfgs_instances(lambda: fd.bfgs_minimize(
        system["terms"], r.repeat(copies, 1).contiguous(),
        t.repeat(copies, 1).contiguous(), system["scal"], pk_big, 14, **kw))
    assert kinds == {2}
    for a, b in zip(one, big):
        assert a.shape[0] == 128 and b.shape[0] == 128 * copies
        assert torch.equal(a, b[:128])


def test_group_stop_in_lockstep_mc_kernel(system):
    """K8 in k_lockstep_mc (S=4, one iteration a step, supplied uniforms):
    rows against the plain steps at K5's bounds, one iteration count for
    the group equal to the plain steps' sum, two launches bit-equal; and a
    window whose stop comes (three iterations a step cut to one)."""
    r, t = _poses(system, "perturbed", 9)
    rng = np.random.default_rng(10)
    uni = torch.as_tensor(rng.random((4, fd.N_DRAWS, LANES),
                                     dtype=np.float32), device=system["dev"])
    ecur = torch.full((LANES,), 3.0e38, device=system["dev"])
    args = (system["terms"], r, t, system["scal"], system["pack"], ecur, 4, 1)
    got = fd.lockstep_mc_window(*args, uniforms=uni, done_frac=0.9)
    again = fd.lockstep_mc_window(*args, uniforms=uni, done_frac=0.9)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert bool((got[2][:, 5] == 4).all())
    e_rep, _, tr_rep, acc_rep, _, gi_rep = fd.replay_lockstep_window_plain(
        system["terms"], r, t, system["scal"], system["pack"], ecur, got[4:],
        uni, 1, done_frac=0.9)
    same = tr_rep == got[6][..., 2]
    assert int((~same).sum()) <= 2
    _close(got[6][..., 0][same], e_rep[same], 1e-2, 5e-2)
    assert torch.equal(got[6][..., 1] > 0.5, acc_rep)
    assert torch.equal(gi_rep.sum(1), got[2][:, 5])
    # three iterations a step at done_frac 0.75: the target 96 is met by the
    # 96 counted padding lanes alone, so every step's BFGS stops after one
    # iteration where the uncoupled window runs up to three
    args3 = args[:-1] + (3,)
    cut = fd.lockstep_mc_window(*args3, uniforms=uni, done_frac=0.75)
    free = fd.lockstep_mc_window(*args3, uniforms=uni)
    torch.cuda.synchronize()
    assert bool((cut[2][:, 5] == 4).all()) and bool((cut[2][:, 3] <= 4).all())
    assert float(free[2][:, 3].sum()) > float(cut[2][:, 3].sum())
    e_rep, _, tr_rep, acc_rep, _, gi_rep = fd.replay_lockstep_window_plain(
        system["terms"], r, t, system["scal"], system["pack"], ecur, cut[4:],
        uni, 3, done_frac=0.75)
    assert torch.equal(gi_rep.sum(1), cut[2][:, 5])
    same = tr_rep == cut[6][..., 2]
    assert int((~same).sum()) <= 2
    _close(cut[6][..., 0][same], e_rep[same], 1e-2, 5e-2)


# ------------------------------------------------------------- K9-K11 ----

def test_probe_kernels(card):
    """K9-K11 vs their plain versions at a small size: each checksum within
    2e-5 of the sum of the terms' magnitudes (2e-2 for bfloat16 pair
    arithmetic); each call's launch counted; two calls equal."""
    from gnina_tpu_torch import probes

    lanes, n, k, reps = 64, 4, 256, 3
    x = probes.make_inputs(3, lanes, n, k, card)
    mag = reps * float(probes.pair_energies(
        x["lig"], x["ligp"], x["rec"], x["recp"]).abs().sum())
    pa = (x["lig"], x["ligp"], x["rec"], x["recp"], reps)
    for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2)):
        before = (probes.probe_pairs.launches, probes.probe_pairs.calls)
        got = float(probes.probe_pairs(*pa, dtype=dtype))
        assert (probes.probe_pairs.launches, probes.probe_pairs.calls) == (
            before[0] + probes.LAUNCHES_PER_CALL, before[1] + 1)
        ref = float(probes.probe_pairs_plain(*pa, dtype=dtype))
        assert abs(got - ref) <= tol * mag
        assert got == float(probes.probe_pairs(*pa, dtype=dtype))
    got = float(probes.probe_gather_loop(x["idx"], x["cells"], x["w"], reps))
    ref = float(probes.probe_gather_loop_plain(x["idx"], x["cells"], x["w"],
                                               reps))
    mag = reps * float((x["cells"][x["idx"].long(), :8] * x["w"]).abs().sum())
    assert abs(got - ref) <= 2e-5 * mag
    got = float(probes.probe_mxu(x["tgt"], x["g"], reps))
    ref = float(probes.probe_mxu_plain(x["tgt"], x["g"], reps))
    mag = reps * float(x["g"].float()[x["tgt"][:, 0].long()].abs().sum())
    assert abs(got - ref) <= 2e-5 * mag
    assert probes.probe_gather_loop.launches >= 1
    assert probes.probe_mxu.launches >= 1
    with pytest.raises(ValueError):
        probes.probe_mxu(x["tgt"][:40].contiguous(), x["g"], reps)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_probe_pairs_ragged(card, dtype, tol):
    """K9 at sizes that fill no tile (L=100, N=7, K=1000: padded lanes,
    receptor atoms and a short ligand-atom range) against its plain
    version within tol of the sum of the terms' magnitudes, as chip_smoke.py
    holds it; two launches bit-equal."""
    from gnina_tpu_torch import probes

    lanes, n, k, reps = 100, 7, 1000, 3
    x = probes.make_inputs(5, lanes, n, k, card)
    pa = (x["lig"], x["ligp"], x["rec"], x["recp"], reps)
    mag = reps * float(probes.pair_energies(*pa[:4]).abs().sum())
    got = probes.probe_pairs(*pa, dtype=dtype)
    ref = probes.probe_pairs_plain(*pa, dtype=dtype)
    assert abs(float(got) - float(ref)) <= tol * mag
    assert torch.equal(got, probes.probe_pairs(*pa, dtype=dtype))


def test_probe_gather_ragged(card):
    """K10 with 700 lookups x 3 repetitions (2,100 threads, not a multiple
    of the block) against its plain version within 2e-5 of the sum of the
    terms' magnitudes; two launches bit-equal; one launch a call."""
    from gnina_tpu_torch import probes

    x = probes.make_inputs(6, 100, 7, 64, card)
    reps = 3
    before = probes.probe_gather_loop.launches
    got = probes.probe_gather_loop(x["idx"], x["cells"], x["w"], reps)
    assert probes.probe_gather_loop.launches == (
        before + probes.LAUNCHES_PER_CALL)
    ref = probes.probe_gather_loop_plain(x["idx"], x["cells"], x["w"], reps)
    mag = reps * float((x["cells"][x["idx"].long(), :8] * x["w"]).abs().sum())
    assert abs(float(got) - float(ref)) <= 2e-5 * mag
    assert torch.equal(got, probes.probe_gather_loop(x["idx"], x["cells"],
                                                     x["w"], reps))


@pytest.mark.parametrize("rows,kdim", [(2048, 896), (4096, 896), (256, 912)])
def test_probe_mxu_wgmma_shapes(card, rows, kdim):
    """K11 (wgmma, g loaded by TMA) at the main path's 4,096 rows, at 2,048
    (64 blocks), and at a depth that is not a multiple of 64 (912: the last
    k step runs alone): the checksum within 2e-5 of the sum of the terms'
    magnitudes, two calls equal; a depth above what shared memory holds
    raises."""
    from gnina_tpu_torch import probes

    rng = np.random.default_rng(rows + kdim)
    reps = 4
    tgt = torch.as_tensor(rng.integers(0, kdim, (rows, 1)).astype(np.int32),
                          device=card)
    g = torch.as_tensor(rng.standard_normal((kdim, probes.ROW_WIDTH)).astype(
        np.float32), device=card).to(torch.bfloat16)
    got = float(probes.probe_mxu(tgt, g, reps))
    ref = float(probes.probe_mxu_plain(tgt, g, reps))
    mag = reps * float(g.float()[tgt[:, 0].long()].abs().sum())
    assert abs(got - ref) <= 2e-5 * mag
    assert got == float(probes.probe_mxu(tgt, g, reps))
    deep = torch.zeros((probes.MXU_KMAX + 16, probes.ROW_WIDTH),
                       dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError):
        probes.probe_mxu(tgt, deep, reps)


# ------------------------------------------------------------- the CLI ----

def test_cli_runs_on_the_card_by_default(card, tmp_path):
    """python -m gnina_tpu_torch without --device: score_only goes through
    K1 on the card and agrees with --device cpu within 1e-3 kcal/mol."""
    import re

    from gnina_tpu_torch import cli

    lig = fx.ligand()
    rec = tmp_path / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(lig), seed=4,
                                        cube=22.0))
    with open(fx.LIGAND_SDF) as f:
        one = tmp_path / "one.sdf"
        one.write_text(f.read().split("$$$$\n")[0] + "$$$$\n")
    argv = ["-r", str(rec), "-l", str(one), "--score_only", "--cnn_scoring",
            "none", "-q"]
    before = fd.eval_fg.launches
    assert cli.main(argv + ["--log", str(tmp_path / "gpu.log")]) == 0
    assert fd.eval_fg.launches == before + 1
    assert cli.main(argv + ["--device", "cpu", "--log",
                            str(tmp_path / "cpu.log")]) == 0
    aff = [float(re.search(r"Affinity: (-?[\d.]+)",
                           (tmp_path / f).read_text()).group(1))
           for f in ("gpu.log", "cpu.log")]
    assert abs(aff[0] - aff[1]) <= 1e-3


def test_term_values_and_atom_terms_on_the_card(card, monkeypatch):
    """--score_only's "Term values" row and the --atom_terms table are
    evaluated on the engine's device: every tensor a term sees lies on the
    card, and the values equal the CPU engine's within 1e-4 relative (the
    CPU values are held to the JAX package in test_torch_minimize.py)."""
    from gnina_tpu_torch.docking import DockingEngine, DockSettings
    from gnina_tpu_torch.scoring import atom_terms, terms

    rec, lig, _, _ = fx.system(seed=3, box=16.0, cube=30.0)
    seen = []
    real = terms.Gauss.eval

    def spy(self, pa, pb, r, qa=None, qb=None):
        seen.extend([r.device.type, pa["xs_radius"].device.type,
                     pb["xs_radius"].device.type])
        return real(self, pa, pb, r, qa=qa, qb=qb)

    monkeypatch.setattr(terms.Gauss, "eval", spy)
    st = DockSettings(cnn_scoring="none")
    on_card = DockingEngine(st).term_values(rec, lig)      # device=None
    assert seen and set(seen) == {"cuda"}
    del seen[:]
    on_cpu = DockingEngine(st, device="cpu").term_values(rec, lig)
    assert set(seen) == {"cpu"}
    assert len(on_card) == 5 and any(abs(v) > 0.1 for v in on_cpu)
    np.testing.assert_allclose(on_card, on_cpu, rtol=1e-4, atol=1e-4)
    sf = get_scoring_function("vina")
    del seen[:]
    t_card = atom_terms.atom_terms_table(sf, lig, rec)      # device=None
    assert set(seen) == {"cuda"}
    t_cpu = atom_terms.atom_terms_table(sf, lig, rec, device="cpu")
    rows = [(a.split(), b.split()) for a, b in
            zip(t_card.splitlines()[1:-1], t_cpu.splitlines()[1:-1])]
    assert len(rows) == lig.num_atoms
    for a, b in rows:
        assert a[:5] == b[:5]
        np.testing.assert_allclose([float(v) for v in a[5:]],
                                   [float(v) for v in b[5:]], rtol=1e-3,
                                   atol=1e-5)


# ---------------------------------------------------- the screen's batch ----

def test_k3_slots_and_a_screen_batch_that_fills_them(card, tmp_path):
    """fused_dock.k3_occupancy reads the card's SM count and K3's resident
    blocks an SM from the driver's occupancy calculator (at most what K3's
    registers allow); a 16-ligand screen at exhaustiveness
    8 docks in batches of max(8, slots // 8) ligands: one dock_batch of 128
    lanes on an H100's 132 SMs, counted beside its screen.slots."""
    from torch.profiler import ProfilerActivity, profile

    from gnina_tpu_torch import cli, trace
    from gnina_tpu_torch.ops import _cuda

    smem = fd.smem_plan(24, 8, 13, 2048).nbytes
    occ = fd.k3_occupancy(card, smem)
    props = torch.cuda.get_device_properties(card)
    blocks, regs = _cuda.occupancy(fd.K3_SYMBOL, fd.BLOCK_THREADS, smem,
                                   torch.cuda.current_device())
    assert occ == (props.multi_processor_count, blocks)
    assert ctypes.cast(_cuda.lib()[fd.K3_SYMBOL], ctypes.c_void_p).value
    warps = fd.BLOCK_THREADS // 32
    by_regs = 65536 // (warps * 32 * (-(-regs // 8) * 8))
    assert 1 <= blocks <= by_regs

    lig = fx.ligand()
    rec = tmp_path / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(lig), seed=4,
                                        cube=22.0))
    with open(fx.LIGAND_SDF) as f:
        records = f.read().split("$$$$\n")
    (tmp_path / "one.sdf").write_text(records[0] + "$$$$\n")
    (tmp_path / "sixteen.sdf").write_text("".join(
        f"lig{i:02d}" + r[r.index("\n"):] + "$$$$\n"
        for i, r in enumerate(records[:16])))
    argv = ["-r", str(rec), "-l", str(tmp_path / "sixteen.sdf"),
            "--autobox_ligand", str(tmp_path / "one.sdf"), "--cnn_scoring",
            "none", "--num_mc_steps", "32", "--exhaustiveness", "8",
            "-o", str(tmp_path / "out.sdf"), "-q",
            "--log", str(tmp_path / "log")]
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(argv) == 0
    c = trace.snapshot()["counters"]
    trace.reset()
    slots = occ[0] * occ[1]
    per_batch = max(8, slots // 8)
    assert c["dock.batches"] == -(-16 // per_batch)
    assert c["screen.slots"] == slots * c["dock.batches"]
    assert c["dock.lanes"] == 128
    if slots == 132:
        assert c["dock.batches"] == 1
