"""The general path's MC chunk under CNN Metropolis, and the `all` mode's
search objective, against the JAX package's on the CPU (toy CNN; the
system of test_torch_cnn_objective.py).

mc_chunk needs no change for the CNN in the loop: after each BFGS it calls
the energy functions' metro_on_coords, which the engine's _energy_fns_for
points at the CNN objective's value_on_coords under every CNN-in-the-loop
mode (the JAX engine's energy_fns_for, docking.py:1347-1362).  As in
test_torch_mc_chunk.py, chunks of two steps start both sides from the same
chain state on JAX's own draws; the BFGS runs on JAX's search grids.  A
step's Metropolis energy is the CNN loss of the minimised pose at its own
heavy centroid plus the box penalties at slope 1e3; the minimisations run
one BFGS iteration, so that the two sides' poses agree to float32 rounding
(1e-5 A).  The chain energies are held at 1e-4 relative and the
acceptances (which chain heads moved) exactly, lane by lane; a lane whose
pose parted further (a CNN gradient of 10 per A turns 1e-5 A into 1e-4)
is dropped, at most one lane in four.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.ops import mc as jmc
from gnina_tpu.ops.bfgs import MinimizeParams as JMinimizeParams
from gnina_tpu.types import Conf as JConf
from gnina_tpu_torch.ops import cache_grid as tcg
from gnina_tpu_torch.ops import mc as tmc
from gnina_tpu_torch.ops.bfgs import MinimizeParams
from gnina_tpu_torch.ops.energy import lane_ligands
from gnina_tpu_torch.types import Conf as TConf
from test_torch_cnn_objective import engines, grad_close, load_system, \
    random_confs, toy_scorers, write_system
from test_torch_mc_chunk import LANES, SLOTS, chunk_draws, jax_fns, \
    start_carry, to_port

CHUNKS = 2
# BFGS iterations a minimisation: one, so that the minimised poses (and
# with them the CNN energies) agree to float32 rounding
MAXIT = 1
SLOPE = 1e3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    sysd = load_system(*write_system(tmp_path_factory.mktemp("mc_cnn")))
    e = engines(sysd, toy_scorers(0), cnn_scoring="metrorescore")
    lo, hi = np.asarray(e["jbox"].lo), np.asarray(e["jbox"].hi)
    return dict(e, lo=lo, hi=hi, jlig=sysd["jlig"], tlig=sysd["tlig"],
                jgrids=e["je"]._populate_cache([sysd["jlig"]], e["jr"], lo,
                                               hi))


def test_mc_chunk_under_cnn_metropolis_matches_jax(system):
    jl = system["jl"]
    m = jl.num_torsion_slots + 1
    ntors = system["jlig"].num_torsions
    jobj, tobj = system["jobj"], system["tobj"]
    fns = jax_fns(system, True)
    fns["metro_on_coords"] = lambda x: jobj["value_on_coords"](jl, x, SLOPE)
    par = jmc.MCParams(num_steps=2, num_saved_mins=SLOTS, refine_stride=2,
                       minparams=JMinimizeParams(maxiters=MAXIT,
                                                 fused_trials=False))
    dof = jnp.arange(m - 1 + 6) < 6 + ntors
    chunk = jax.jit(jax.vmap(lambda c, k: jmc.mc_chunk(
        c, k, 2, jl, fns, par, system["layers"], dof, ntors, True)))

    lig_l = lane_ligands([system["tl"]], torch.zeros(LANES, dtype=torch.long))
    te = system["te"]
    tgrids = tcg.CacheGrids(*[torch.tensor(np.asarray(x))
                              for x in system["jgrids"]])
    tfns = te._energy_fns_for(te._make_efn(system["layers"]), lig_l,
                              system["tr"], system["tbox"], tgrids,
                              system["layers"], cnn_obj=tobj, cnn_metro=True)
    tpar = tmc.MCParams(num_saved_mins=SLOTS, refine_stride=2,
                        minparams=MinimizeParams(maxiters=MAXIT))
    tdof = (torch.arange(6 + m - 1) < 6 + ntors).expand(LANES, -1)
    nt = torch.full((LANES,), ntors)
    rig = torch.ones(LANES, dtype=torch.bool)

    jc = start_carry(system, 21)
    live = np.ones(LANES, bool)
    accepted = rejected = 0
    base = jax.random.PRNGKey(5)
    for i in range(CHUNKS):
        keys = [jax.random.fold_in(base, i * LANES + l) for l in range(LANES)]
        want = chunk(jc, jnp.stack(keys))
        with torch.no_grad():
            got = tmc.mc_chunk(to_port(jc, m), None, 2, lig_l, tfns, tpar,
                               system["layers"], tdof, nt, rig,
                               draws=chunk_draws(keys, ntors))
        w, start = to_port(want, m), to_port(jc, m)
        moved_w = (w.rigid != start.rigid).any(1).numpy()
        moved_g = (got.rigid != start.rigid).any(1).numpy()
        de = np.abs(got.e.numpy() - w.e.numpy()) / np.abs(w.e.numpy())
        ok = (moved_w == moved_g) & (de <= 1e-4)
        ok &= (np.abs(got.rigid[:, :3].numpy() - w.rigid[:, :3].numpy())
               <= 5e-3).all(1)
        live &= ok
        assert live.sum() >= LANES - LANES // 4, (i, live, de)
        accepted += int((moved_w & live).sum())
        rejected += int((~moved_w & live).sum())
        jc = want
    assert accepted >= 1 and rejected >= 1, (accepted, rejected)
    # the Metropolis energies are CNN losses plus box penalties (positive),
    # not the search grids' energies (negative in the pocket)
    assert (w.e.numpy() > 0).all()
    assert (got.e.numpy() != tfns_grid_metro(system, got)).any()


def tfns_grid_metro(system, carry):
    """The search grids' Metropolis energy of the carry's coordinates (what
    metro_on_coords is without the CNN)."""
    te = system["te"]
    lig_l = lane_ligands([system["tl"]],
                         torch.zeros(LANES, dtype=torch.long))
    tgrids = tcg.CacheGrids(*[torch.tensor(np.asarray(x))
                              for x in system["jgrids"]])
    fns = te._energy_fns_for(te._make_efn(system["layers"]), lig_l,
                             system["tr"], system["tbox"], tgrids,
                             system["layers"])
    with torch.no_grad():
        return fns["metro_on_coords"](carry.coords).numpy()


def test_all_mode_search_objective_matches_jax(system):
    """eval_deriv and eval_energy of _energy_fns_for under cnn_search (the
    `all` mode): the CNN objective with each conf's grids centred on its
    own heavy centroid, the centre held fixed in the gradient, for 4 lanes
    and for the line search's (10, lanes) trial batch.  Against JAX's
    deriv / value at center_of: values 1e-4 relative, gradients 1e-3 of
    the largest component."""
    jl, layers = system["jl"], system["layers"]
    jobj = system["jobj"]
    t = jl.num_torsion_slots
    pos, q, tors = random_confs(system["tlig"], t, 4, seed=13)
    want_v, want_g = [], []
    for i in range(4):
        c = JConf(jnp.asarray(pos[i]), jnp.asarray(q[i]), jnp.asarray(tors[i]))
        cen = jax.lax.stop_gradient(jobj["center_of"](jl, c))
        v, g = jobj["deriv"](jl, c, cen, SLOPE)
        want_v.append(float(v))
        want_g.append(np.asarray(g))
    te = system["te"]
    lig_l = lane_ligands([system["tl"]], torch.zeros(4, dtype=torch.long))
    fns = te._energy_fns_for(te._make_efn(layers), lig_l, system["tr"],
                             system["tbox"], None, layers,
                             cnn_obj=system["tobj"], cnn_metro=True,
                             cnn_search=True)
    conf = TConf(*[torch.as_tensor(x) for x in (pos, q, tors)])
    v = [1000.0] * 3
    with torch.no_grad():
        e, g = fns["eval_deriv"](conf, v)
        trials = TConf(*[x.expand((10,) + x.shape) for x in conf])
        et = fns["eval_energy"](trials, v)
    np.testing.assert_allclose(e.numpy(), want_v, rtol=1e-4)
    grad_close(g.numpy(), np.stack(want_g))
    assert tuple(et.shape) == (10, 4)
    np.testing.assert_allclose(et.numpy(), np.tile(want_v, (10, 1)),
                               rtol=1e-4)
