"""The port's Monte Carlo bookkeeping against the JAX package's: the batched
container merge of a window's candidates, the per-ligand merge of the
chains' containers, and random chain heads.  Inputs come from a numpy seed;
the container outputs are compared exactly (same sort, same dedup)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.constants import MAX_FL
from gnina_tpu.ops import mc as jmc
from gnina_tpu_torch.ops import mc as tmc

N_ATOMS, T = 6, 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def containers(rng, batch, slots, empty_frac=0.3):
    """Random containers whose poses come in clusters (so that the RMSD
    dedup has work) with some empty slots."""
    shape = batch + (slots,)
    centers = rng.normal(scale=4.0, size=batch + (3, N_ATOMS, 3))
    pick = rng.integers(0, 3, size=shape)
    base = np.take_along_axis(
        centers, pick.reshape(batch + (slots, 1, 1)), axis=len(batch))
    coords = base + rng.normal(scale=0.4, size=shape + (N_ATOMS, 3))
    energy = rng.uniform(-9.0, -3.0, size=shape)
    empty = rng.random(shape) < empty_frac
    energy = np.where(empty, MAX_FL, energy)
    coords = np.where(empty[..., None, None], 1e9, coords)
    q = rng.normal(size=shape + (4,))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f = lambda a: np.asarray(a, np.float32)
    return dict(energy=f(energy), position=f(rng.normal(size=shape + (3,))),
                orientation=f(q), torsions=f(rng.normal(size=shape + (T,))),
                coords=f(coords))


def jcont(d):
    return jmc.PoseContainer(**{k: jnp.asarray(v) for k, v in d.items()})


def tcont(d):
    return tmc.PoseContainer(**{k: torch.as_tensor(v) for k, v in d.items()})


def same(tc, jc):
    for f in tmc.PoseContainer._fields:
        np.testing.assert_array_equal(getattr(tc, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batch_merge_candidates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    lanes, k, s = 5, 7, 12
    cont = containers(rng, (lanes,), k)
    cand = containers(rng, (lanes,), s, empty_frac=0.4)
    hm = rng.random((lanes, N_ATOMS)) < 0.85
    want = jax.vmap(jmc.batch_merge_candidates, in_axes=(0, 0, 0, None))(
        jcont(cont), jcont(cand), jnp.asarray(hm), 1.0)
    got = tmc.batch_merge_candidates(tcont(cont), tcont(cand),
                                     torch.as_tensor(hm), 1.0)
    same(got, want)


@pytest.mark.parametrize("seed", [3, 4])
def test_merge_containers_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ligs, chains, slots, out = 3, 4, 5, 6
    conts = containers(rng, (ligs, chains), slots)
    hm = rng.random((ligs, N_ATOMS)) < 0.85
    merge = jax.jit(jax.vmap(lambda c, h: jmc.merge_containers(c, h, 2.0,
                                                                out)))
    want = merge(jcont(conts), jnp.asarray(hm))
    got = tmc.merge_containers(tcont(conts), torch.as_tensor(hm), 2.0, out)
    same(got, want)


def test_empty_container_matches_jax():
    got = tmc.empty_container((2,), 4, T, N_ATOMS, device="cpu")
    want = jmc.empty_container(4, T, N_ATOMS)
    for f in tmc.PoseContainer._fields:
        for b in range(2):
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          np.asarray(getattr(want, f)))


def test_randomize_conf_draws_in_box_from_its_generator():
    lo, hi = np.array([-1.0, 2.0, 0.0]), np.array([3.0, 5.0, 1.0])
    g = torch.Generator().manual_seed(5)
    pos, quat, tors = tmc.randomize_conf(4000, lo, hi, T, g, device="cpu")
    assert ((pos >= torch.as_tensor(lo, dtype=torch.float32))
            & (pos <= torch.as_tensor(hi, dtype=torch.float32))).all()
    np.testing.assert_allclose(torch.linalg.norm(quat, dim=1).numpy(), 1.0,
                               atol=1e-5)
    assert (tors.abs() <= np.pi).all()
    # uniform orientations: each quaternion component has mean ~0
    assert quat.mean(0).abs().max() < 0.05
    again = tmc.randomize_conf(4000, lo, hi, T,
                               torch.Generator().manual_seed(5),
                               device="cpu")
    assert all(torch.equal(a, b) for a, b in zip((pos, quat, tors), again))


def test_mc_init_chain_heads():
    g = torch.Generator().manual_seed(0)
    params = tmc.MCParams(num_saved_mins=3)
    calls = []

    def fk_fn(r, t):
        calls.append((r.shape, t.shape))
        return torch.zeros(r.shape[0], N_ATOMS, 3)

    carry = tmc.mc_init(6, T + 1, params, np.zeros(3), np.ones(3), N_ATOMS,
                        g, fk_fn, device="cpu")
    assert carry.rigid.shape == (6, 8) and carry.tors.shape == (6, T + 1)
    assert (carry.tors[:, 0] == 0).all() and (carry.rigid[:, 7] == 0).all()
    assert (carry.e == MAX_FL).all() and (carry.best_e == MAX_FL).all()
    assert carry.cont.energy.shape == (6, 3)
    assert calls == [((6, 8), (6, T + 1))]


# ------------------------------------------- mutation and Metropolis ----

def jax_mutation_draws(keys, ntors, has_rigid):
    """The numbers jmc.mutate_conf draws from each lane's key, by its own
    key splits (mc.py:193-210, random_inside_sphere :168-174), as the
    port's MutationDraws."""
    which, pd_, pr, rd, rr, nt = [], [], [], [], [], []
    for key, n, rigid in zip(keys, ntors, has_rigid):
        k1, k2, k3, k4 = jax.random.split(key, 4)
        which.append(int(jax.random.randint(k1, (), 0 if rigid else 2,
                                            int(n) + 2)))
        for k, dirs, rads in ((k2, pd_, pr), (k3, rd, rr)):
            ka, kb = jax.random.split(k)
            dirs.append(np.asarray(jax.random.normal(ka, (3,), jnp.float32)))
            rads.append(float(jax.random.uniform(kb, (), jnp.float32)))
        nt.append(float(jax.random.uniform(k4, (), jnp.float32, -jnp.pi,
                                           jnp.pi)))
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return tmc.MutationDraws(which=torch.as_tensor(which), pos_dir=f(pd_),
                             pos_r=f(pr), rot_dir=f(rd), rot_r=f(rr),
                             new_tor=f(nt))


def _confs(rng, lanes, t):
    q = rng.normal(size=(lanes, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    f = lambda a: np.asarray(a, np.float32)
    return (f(rng.normal(scale=5.0, size=(lanes, 3))), f(q),
            f(rng.uniform(-np.pi, np.pi, (lanes, t))))


@pytest.mark.parametrize("seed,has_rigid", [(0, True), (1, True), (2, False)])
def test_mutate_conf_matches_jax_on_its_own_draws(seed, has_rigid):
    """mutate_conf fed the very numbers the JAX function draws from its
    key splits gives the JAX conf within 1e-5, over lanes that hit the
    position, orientation and torsion branches (and only torsions without
    rigid DOFs); one lane has a zero gyration radius (no rotation)."""
    from gnina_tpu.types import Conf as JConf
    from gnina_tpu_torch.types import Conf as TConf

    lanes = 24
    rng = np.random.default_rng(seed)
    pos, quat, tors = _confs(rng, lanes, T)
    gr = rng.uniform(1.0, 4.0, lanes).astype(np.float32)
    gr[0] = 0.0
    ntors = rng.integers(1, T + 1, lanes)
    rigid = np.full(lanes, has_rigid)
    keys = jax.random.split(jax.random.PRNGKey(seed), lanes)
    want = jax.vmap(jmc.mutate_conf, in_axes=(0, 0, 0, None, 0, 0))(
        keys, JConf(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(tors)),
        jnp.asarray(gr), 2.0, jnp.asarray(ntors), jnp.asarray(rigid))
    draws = jax_mutation_draws(keys, ntors, rigid)
    got = tmc.mutate_conf(
        TConf(torch.as_tensor(pos), torch.as_tensor(quat),
              torch.as_tensor(tors)), torch.as_tensor(gr), 2.0,
        torch.as_tensor(ntors), torch.as_tensor(rigid), draws=draws)
    np.testing.assert_allclose(got.position.numpy(),
                               np.asarray(want.position), atol=1e-5)
    np.testing.assert_allclose(got.orientation.numpy(),
                               np.asarray(want.orientation), atol=1e-5)
    np.testing.assert_allclose(got.torsions.numpy(),
                               np.asarray(want.torsions), atol=1e-5)
    kinds = set(np.minimum(draws.which.numpy(), 2).tolist())
    assert kinds == ({0, 1, 2} if has_rigid else {2})


def test_mutation_draws_from_a_generator():
    """draw_mutation: `which` uniform over the lane's own DOF choices
    (torsions only without rigid DOFs), the same seed the same draws."""
    ntors = torch.tensor([3] * 2000 + [1] * 2000)
    rigid = torch.tensor([True] * 3000 + [False] * 1000)
    a = tmc.draw_mutation(torch.Generator().manual_seed(5), ntors, rigid,
                          device="cpu")
    b = tmc.draw_mutation(torch.Generator().manual_seed(5), ntors, rigid,
                          device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    w = a.which.numpy()
    assert set(w[:2000]) == {0, 1, 2, 3, 4} and set(w[2000:3000]) == {0, 1, 2}
    assert set(w[3000:]) == {2}
    counts = np.bincount(w[:2000], minlength=5) / 2000.0
    np.testing.assert_allclose(counts, 0.2, atol=0.04)
    assert (a.new_tor >= -np.pi).all() and (a.new_tor < np.pi).all()
    from gnina_tpu_torch.types import Conf as TConf

    conf = TConf(torch.zeros(2, 3), torch.ones(2, 4) * 0.5,
                 torch.zeros(2, T))
    with pytest.raises(ValueError, match="draws or a generator"):
        tmc.mutate_conf(conf, torch.ones(2), 2.0, ntors[:2])


def test_gyration_and_metropolis_match_jax():
    """gyration_radius within 1e-5 of JAX's on the same coordinates and
    mask; metropolis_accept the same decisions on the uniforms JAX draws
    from its keys."""
    rng = np.random.default_rng(3)
    lanes = 16
    coords = rng.normal(scale=3.0, size=(lanes, N_ATOMS, 3)).astype(
        np.float32)
    root = rng.normal(size=(lanes, 3)).astype(np.float32)
    mask = rng.random((lanes, N_ATOMS)) > 0.3
    mask[0] = False                       # no heavy atom: radius 0
    want = jax.vmap(jmc.gyration_radius)(jnp.asarray(coords),
                                         jnp.asarray(root), jnp.asarray(mask))
    got = tmc.gyration_radius(torch.as_tensor(coords), torch.as_tensor(root),
                              torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert got[0] == 0.0

    old = rng.uniform(-8, -4, lanes).astype(np.float32)
    new = (old + rng.normal(scale=1.0, size=lanes)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), lanes)
    want = jax.vmap(jmc.metropolis_accept, in_axes=(0, 0, 0, None))(
        keys, jnp.asarray(old), jnp.asarray(new), 1.2)
    u = np.asarray([float(jax.random.uniform(k, (), jnp.float32))
                    for k in keys], np.float32)
    got = tmc.metropolis_accept(torch.as_tensor(old), torch.as_tensor(new),
                                1.2, u=torch.as_tensor(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.any() and not got.all()
    assert torch.equal(
        tmc.metropolis_accept(torch.as_tensor(old), torch.as_tensor(new), 1.2,
                              generator=torch.Generator().manual_seed(1)),
        tmc.metropolis_accept(torch.as_tensor(old), torch.as_tensor(new), 1.2,
                              generator=torch.Generator().manual_seed(1)))


# ------------------------------------- host-driven chunk bookkeeping ----

M_NODES, NH = 4, 6          # tree nodes (3 torsion slots), heavy rows


def _script_energy(pos, tors, v):
    """A scripted "minimiser": the candidate's energy is a smooth function
    of the conf it is handed, lower at full v than at the hunt caps."""
    return (-6.0 + 2.0 * np.sin(1.7 * pos[..., 0]) + np.cos(
        2.3 * pos[..., 1] + tors[..., 0]) - 0.002 * v)


class _JaxScripted:
    """Stands in for the JAX FusedBfgs handle: contracts the pose toward
    the origin, reports the scripted energy, and lays the heavy atoms on a
    fixed pattern about the position."""

    def __init__(self, pattern):
        self.m = M_NODES
        self.pattern = jnp.asarray(pattern)            # (NH, 3)

    def __call__(self, rigid, tors, scal, pack=None):
        pos = rigid[0:3] * 0.9                          # (3, L)
        rigid2 = jnp.concatenate([pos, rigid[3:8]], axis=0)
        tors2 = tors * 0.5
        e = (-6.0 + 2.0 * jnp.sin(1.7 * pos[0]) + jnp.cos(
            2.3 * pos[1] + tors2[1]) - 0.002 * scal[0, 0])
        stats = jnp.zeros((8, rigid.shape[1]), jnp.float32).at[1].set(e)
        coords = pos[:, None, :] + self.pattern.T[:, :, None]   # (3, NH, L)
        return rigid2, tors2, stats, coords


class _TorchScripted:
    def __init__(self, pattern):
        self.m = M_NODES
        self.pattern = torch.as_tensor(pattern)

    def __call__(self, rigid, tors, scal):
        pos = rigid[:, 0:3] * 0.9
        rigid2 = torch.cat([pos, rigid[:, 3:8]], dim=1)
        tors2 = tors * 0.5
        e = (-6.0 + 2.0 * torch.sin(1.7 * pos[:, 0]) + torch.cos(
            2.3 * pos[:, 1] + tors2[:, 1]) - 0.002 * scal[0])
        stats = torch.zeros((rigid.shape[0], 8))
        stats[:, 1] = e
        return rigid2, tors2, stats, pos[:, None, :] + self.pattern[None]


@pytest.mark.parametrize("stride,steps", [(4, 12), (3, 7), (0, 6), (8, 5)])
def test_fused_mc_chunk_bookkeeping_matches_jax(stride, steps):
    """The host-driven chunk loop on a scripted minimiser (the same
    function of the conf on both sides) and JAX's own draws: after `steps`
    steps the chain head, its energy, best_e, the container, and the
    pending flags equal JAX's (1e-5; flags and slots exactly).  Covers
    refine every `stride` steps, stride 0 (never) and a stride longer than
    the chunk (never)."""
    from types import SimpleNamespace

    from gnina_tpu.ops import mc_fused as jmcf
    from gnina_tpu.types import Conf as JConf
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops import mc_fused as tmcf

    lanes, slots, tp = 6, 3, M_NODES - 1
    rng = np.random.default_rng(100 + stride)
    pattern = rng.normal(scale=1.5, size=(NH, 3)).astype(np.float32)
    pos, quat, tors = _confs(rng, lanes, tp)
    pos = (pos * 0.5).astype(np.float32)
    ntors = np.asarray([3, 3, 2, 3, 1, 3])
    heavy = np.ones((lanes, NH), bool)
    coords0 = (pos[:, None, :] + pattern[None]).astype(np.float32)
    key = jax.random.PRNGKey(7 + stride)

    # JAX side
    jpar = jmc.MCParams(refine_stride=stride, num_saved_mins=slots)
    jcarry = jmc.MCCarry(
        conf=JConf(jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(tors)),
        e=jnp.full((lanes,), MAX_FL, jnp.float32),
        best_e=jnp.full((lanes,), MAX_FL, jnp.float32),
        cont=jax.vmap(lambda _: jmc.empty_container(slots, tp, NH))(
            jnp.arange(lanes)),
        coords=jnp.asarray(coords0),
        pending=JConf(jnp.asarray(pos), jnp.asarray(quat),
                      jnp.asarray(tors)),
        pending_valid=jnp.zeros((lanes,), bool),
        pending_is_current=jnp.zeros((lanes,), bool))
    jmeta = jmcf.LaneMeta(ntors=jnp.asarray(ntors, jnp.int32),
                          has_rigid=jnp.ones((lanes,), bool),
                          heavy_idx=jnp.tile(jnp.arange(NH, dtype=jnp.int32),
                                             (lanes, 1)),
                          heavy_mask=jnp.asarray(heavy))
    jpack = SimpleNamespace(lc=jnp.zeros((3, NH, lanes)))
    scal_h = jnp.zeros((12, 1), jnp.float32).at[0, 0].set(10.0)
    scal_f = jnp.zeros((12, 1), jnp.float32).at[0, 0].set(1000.0)
    want = jmcf.fused_mc_chunk(jcarry, key, steps, _JaxScripted(pattern),
                               jpack, scal_h, scal_f, jmeta, jpar, tp)

    # the draws of every step, by JAX's key derivation (mc_fused.py:123-128)
    draws = []
    for k in jax.random.split(key, steps):
        k1, k2 = jax.random.split(k)
        kmut = [jax.random.fold_in(k1, j) for j in range(lanes)]
        u = [float(jax.random.uniform(jax.random.fold_in(k2, j), (),
                                      jnp.float32)) for j in range(lanes)]
        draws.append((jax_mutation_draws(kmut, ntors, np.ones(lanes, bool)),
                      torch.as_tensor(np.asarray(u, np.float32))))

    # port side
    from gnina_tpu_torch.types import Conf as TConf

    rigid, ptors = fd.conf_to_packed(
        TConf(torch.as_tensor(pos), torch.as_tensor(quat),
              torch.as_tensor(tors)), M_NODES)
    z = torch.zeros(lanes, dtype=torch.bool)
    tcarry = tmc.MCCarry(
        rigid=rigid, tors=ptors, e=torch.full((lanes,), MAX_FL),
        best_e=torch.full((lanes,), MAX_FL),
        cont=tmc.empty_container((lanes,), slots, tp, NH, device="cpu"),
        coords=torch.as_tensor(coords0), pending_rigid=rigid,
        pending_tors=ptors, pending_valid=z, pending_is_current=z)
    tmeta = tmcf.LaneMeta(heavy_mask=torch.as_tensor(heavy),
                          ntors=torch.as_tensor(ntors),
                          has_rigid=torch.ones(lanes, dtype=torch.bool))
    tpar = tmc.MCParams(refine_stride=stride, num_saved_mins=slots)
    sh = torch.zeros(12)
    sh[0] = 10.0
    sf_ = torch.zeros(12)
    sf_[0] = 1000.0
    got = tmcf.fused_mc_chunk(tcarry, None, steps, _TorchScripted(pattern),
                              None, sh, sf_, tmeta, tpar, tp, draws=draws)

    np.testing.assert_allclose(got.rigid[:, 0:3].numpy(),
                               np.asarray(want.conf.position), atol=1e-5)
    np.testing.assert_allclose(got.rigid[:, 3:7].numpy(),
                               np.asarray(want.conf.orientation), atol=1e-5)
    np.testing.assert_allclose(got.tors[:, 1:].numpy(),
                               np.asarray(want.conf.torsions), atol=1e-5)
    np.testing.assert_allclose(got.e.numpy(), np.asarray(want.e), atol=1e-5)
    np.testing.assert_allclose(got.best_e.numpy(), np.asarray(want.best_e),
                               atol=1e-5)
    np.testing.assert_allclose(got.cont.energy.numpy(),
                               np.asarray(want.cont.energy), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(got.cont.position.numpy(),
                               np.asarray(want.cont.position), atol=1e-5)
    np.testing.assert_allclose(got.coords.numpy(), np.asarray(want.coords),
                               atol=1e-5)
    np.testing.assert_array_equal(got.pending_valid.numpy(),
                                  np.asarray(want.pending_valid))
    np.testing.assert_array_equal(got.pending_is_current.numpy(),
                                  np.asarray(want.pending_is_current))
    np.testing.assert_allclose(got.pending_rigid[:, 0:3].numpy(),
                               np.asarray(want.pending.position), atol=1e-5)
    refines = (stride > 0 and steps >= stride)
    assert bool((got.cont.energy < MAX_FL).any())
    if refines and steps % stride == 0:
        assert not got.pending_valid.any()
