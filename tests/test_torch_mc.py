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
