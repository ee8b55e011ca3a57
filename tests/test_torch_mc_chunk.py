"""The general path's MC chunk (ops/mc.mc_chunk) against the JAX package's
(gnina_tpu/ops/mc.py:268-393), step by step on JAX's own draws.

Each chunk of two steps starts both sides from the same chain state
(JAX's, carried over to the port's layout), and the port's draws are
JAX's: the mutation and Metropolis numbers that mc_chunk's key splits give
each lane (test_torch_mc.jax_mutation_draws).  A step is the hunt-cap
BFGS, Metropolis on the inter-only energy, the promising/pending
bookkeeping and the container insert; with refine_stride 2 the chunk's
second step ends in the full-v refine of the pending promising pose, with
refine_stride 0 the pending flags carry from chunk to chunk.  On the
search grids and on the exact energy, from jittered crystal poses.  On the
grids both sides read JAX's grids, carried over as tensors (the populate
itself is held to JAX's in test_torch_general_ops.py): each side's own
populate puts a few pairs at the 8 A cutoff on the other side of it, and a
BFGS run at authentic v turns that into a visibly different step.

Bounds: a step runs whole BFGS minimisations (MAXIT iterations at the hunt
caps, and at authentic v in the refine), so energies are held at the
three-iteration bound of the fused kernels' tests, rtol 1e-2 / atol 5e-2,
and positions within 5e-2 A; the promising and pending flags and the
container's occupied slots exactly.  An Armijo test that float32 decides
the other way ends that lane's comparison (the lane has taken another
step, and any of those checks then fails for it): the lane is dropped,
and no more than one lane in four may be dropped over the run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.constants import MAX_FL
from gnina_tpu.docking import DockingEngine as JEngine
from gnina_tpu.docking import DockSettings as JSettings
from gnina_tpu.ops import cache_grid as jcg
from gnina_tpu.ops import fk as jfk
from gnina_tpu.ops import mc as jmc
from gnina_tpu.ops.bfgs import MinimizeParams as JMinimizeParams
from gnina_tpu.types import Conf as JConf
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from gnina_tpu_torch.ops import cache_grid as tcg
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.ops import mc as tmc
from gnina_tpu_torch.ops.bfgs import MinimizeParams
from gnina_tpu_torch.ops.energy import lane_ligands
from gnina_tpu_torch.types import Conf as TConf
from test_torch_mc import jax_mutation_draws

LANES, SLOTS, CHUNKS, MAXIT = 8, 4, 3, 3
BOX = 10.0


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
    tlig = fx.ligand()
    center = fx.ligand_center(tlig)
    path = tmp_path_factory.mktemp("mc") / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=6, cube=18.0))
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    size = np.full(3, BOX, np.float32)
    je = JEngine(JSettings(cnn_scoring="none"))
    te = DockingEngine(DockSettings(cnn_scoring="none"), device="cpu")
    jrec = jingest.Receptor.from_file(str(path))
    trec = tingest.Receptor.from_file(str(path))
    jl, jr, jbox, layers, _ = je._prepare(jrec, jlig, center, size)
    tl, tr, tbox, _ = te._prepare(trec, tlig, center, size)
    lo, hi = np.asarray(jbox.lo), np.asarray(jbox.hi)
    return dict(je=je, te=te, jl=jl, jr=jr, jbox=jbox, tl=tl, tr=tr,
                tbox=tbox, layers=layers, lo=lo, hi=hi, jlig=jlig,
                tlig=tlig, jgrids=je._populate_cache([jlig], jr, lo, hi))


def jax_fns(system, grids):
    """JAX's energy_fns_for (gnina_tpu/docking.py:1307-1346) for one
    ligand, on the grids or analytic."""
    efn = system["je"]._make_efn(system["layers"])
    jl, jr, box, layers = (system["jl"], system["jr"], system["jbox"],
                           system["layers"])
    slope = 1e3
    if not grids:
        return {"eval_deriv": lambda c, v: efn.eval_deriv(jl, jr, c, box,
                                                          slope, v),
                "eval_energy": lambda c, v: efn.eval_energy(jl, jr, c, box,
                                                            slope, v),
                "metro_on_coords": lambda x: efn.inter_on_coords(
                    jl, jr, x, box, slope, jnp.float32(1000.0))}
    g = system["jgrids"]

    def total(c, v):
        x = jfk.fk_coords(jl, c, layers)
        return (jcg.cache_inter_energy(g, x, jl.types, jl.charges,
                                       jl.heavy_mask, slope, v[1])
                + efn.pairs_on_coords(jl, x, v[0], v[2]))

    def deriv(c, v):
        t = c.torsions.shape[-1]
        return jax.value_and_grad(lambda eps: total(
            jfk.conf_with_increment_var(c, eps), v))(
                jnp.zeros((6 + t,), jnp.float32))

    return {"eval_deriv": deriv, "eval_energy": total,
            "metro_on_coords": lambda x: jcg.cache_inter_energy(
                g, x, jl.types, jl.charges, jl.heavy_mask, slope,
                jnp.float32(1000.0))}


def jax_chunk(system, grids, stride):
    """A jitted JAX mc_chunk of two steps for every lane (vmapped)."""
    jl = system["jl"]
    t = jl.num_torsion_slots
    ntors = system["jlig"].num_torsions
    dof = jnp.arange(6 + t) < 6 + ntors
    par = jmc.MCParams(num_steps=2, num_saved_mins=SLOTS,
                       refine_stride=stride,
                       minparams=JMinimizeParams(maxiters=MAXIT,
                                                 fused_trials=False))
    fns = jax_fns(system, grids)
    return jax.jit(jax.vmap(lambda c, k: jmc.mc_chunk(
        c, k, 2, jl, fns, par, system["layers"], dof, ntors, True)))


def start_carry(system, seed):
    """Jittered crystal poses with empty containers (JAX layout, lanes
    leading)."""
    rng = np.random.default_rng(seed)
    t = system["jl"].num_torsion_slots
    pos = system["jlig"].orig_coords[0][None] + 0.7 * rng.normal(
        size=(LANES, 3))
    axis = 0.3 * rng.normal(size=(LANES, 3))
    ang = np.linalg.norm(axis, axis=1, keepdims=True)
    q = np.concatenate([np.cos(ang / 2), np.sin(ang / 2) * axis / ang], 1)
    tors = 0.4 * rng.normal(size=(LANES, t))
    conf = JConf(*[jnp.asarray(a, jnp.float32) for a in (pos, q, tors)])
    coords = jax.vmap(lambda c: jfk.fk_coords(system["jl"], c,
                                              system["layers"]))(conf)
    n = system["jl"].types.shape[0]
    return jmc.MCCarry(
        conf=conf, e=jnp.full((LANES,), MAX_FL, jnp.float32),
        best_e=jnp.full((LANES,), MAX_FL, jnp.float32),
        cont=jax.vmap(lambda _: jmc.empty_container(SLOTS, t, n))(
            jnp.arange(LANES)),
        coords=coords, pending=conf,
        pending_valid=jnp.zeros((LANES,), bool),
        pending_is_current=jnp.zeros((LANES,), bool))


def to_port(jc, m):
    """A JAX MCCarry (lanes leading) in the port's packed layout."""
    f = lambda a: torch.as_tensor(np.asarray(a))
    rigid, tors = fd.conf_to_packed(TConf(*[f(x) for x in jc.conf]), m)
    prig, ptor = fd.conf_to_packed(TConf(*[f(x) for x in jc.pending]), m)
    return tmc.MCCarry(rigid=rigid, tors=tors, e=f(jc.e), best_e=f(jc.best_e),
                       cont=tmc.PoseContainer(*[f(x) for x in jc.cont]),
                       coords=f(jc.coords), pending_rigid=prig,
                       pending_tors=ptor, pending_valid=f(jc.pending_valid),
                       pending_is_current=f(jc.pending_is_current))


def chunk_draws(keys, ntors):
    """The draws JAX's mc_chunk takes from each lane's chunk key for its two
    steps (mc.py:380 split, :284 step split, mutate_conf and
    metropolis_accept): [(mutation draws, Metropolis uniforms)] a step."""
    out = []
    for i in range(2):
        k1s, us = [], []
        for key in keys:
            k1, k2 = jax.random.split(jax.random.split(key, 2)[i])
            k1s.append(k1)
            us.append(float(jax.random.uniform(k2, (), jnp.float32)))
        md = jax_mutation_draws(k1s, [ntors] * len(keys),
                                np.ones(len(keys), bool))
        out.append((md, torch.as_tensor(np.asarray(us, np.float32))))
    return out


def port_fns(system, grids):
    te, tl = system["te"], system["tl"]
    lig_l = lane_ligands([tl], torch.zeros(LANES, dtype=torch.long))
    efn = te._make_efn(system["layers"])
    tgrids = None
    if grids:
        tgrids = tcg.CacheGrids(*[torch.tensor(np.asarray(x))
                                  for x in system["jgrids"]])
    return lig_l, te._energy_fns_for(efn, lig_l, system["tr"],
                                     system["tbox"], tgrids,
                                     system["layers"])


def lanes_agree(got, w):
    """Per lane: every checked quantity of the two carries agrees within
    the module's bounds."""
    def close(a, b):
        return np.isclose(a.numpy(), b.numpy(), rtol=1e-2, atol=5e-2)

    ok = close(got.e, w.e) & close(got.best_e, w.best_e)
    ok &= (np.abs(got.rigid[:, :3].numpy() - w.rigid[:, :3].numpy())
           <= 5e-2).all(1)
    for name in ("pending_valid", "pending_is_current"):
        ok &= (getattr(got, name) == getattr(w, name)).numpy()
    ok &= ((got.cont.energy < MAX_FL) == (w.cont.energy < MAX_FL)).all(
        1).numpy()
    ok &= close(torch.sort(got.cont.energy, 1).values,
                torch.sort(w.cont.energy, 1).values).all(1)
    return ok


@pytest.mark.parametrize("grids,stride", [(True, 2), (False, 0)],
                         ids=["grids-refine", "analytic-pending"])
def test_mc_chunk_steps_match_jax_on_its_draws(system, grids, stride):
    jl = system["jl"]
    m = jl.num_torsion_slots + 1
    ntors = system["jlig"].num_torsions
    chunk = jax_chunk(system, grids, stride)
    lig_l, fns = port_fns(system, grids)
    par = tmc.MCParams(num_saved_mins=SLOTS, refine_stride=stride,
                       minparams=MinimizeParams(maxiters=MAXIT))
    dof = (torch.arange(6 + m - 1) < 6 + ntors).expand(LANES, -1)
    nt = torch.full((LANES,), ntors)
    rig = torch.ones(LANES, dtype=torch.bool)
    jc = start_carry(system, 7 if grids else 8)
    live = np.ones(LANES, bool)
    rejected = pending = 0
    base = jax.random.PRNGKey(11 if grids else 12)
    for i in range(CHUNKS):
        keys = [jax.random.fold_in(base, i * LANES + l) for l in range(LANES)]
        want = chunk(jc, jnp.stack(keys))
        with torch.no_grad():
            got = tmc.mc_chunk(to_port(jc, m), None, 2, lig_l, fns, par,
                               system["layers"], dof, nt, rig,
                               draws=chunk_draws(keys, ntors))
        w = to_port(want, m)
        live &= lanes_agree(got, w)
        assert live.sum() >= LANES - LANES // 4, (i, live)
        # what the chunks covered: chain heads that stayed put (Metropolis
        # rejections) and pending poses
        moved = (w.rigid != to_port(jc, m).rigid).any(1).numpy()
        rejected += int((~moved & live).sum())
        pending += int((w.pending_valid.numpy() & live).sum())
        jc = want
    occupied = int((w.cont.energy[torch.as_tensor(live)] < MAX_FL).sum())
    assert occupied >= 2 * int(live.sum())
    assert rejected >= 1
    if stride == 0:
        assert pending >= live.sum()


def test_run_mc_chain_is_init_and_chunk(system):
    """run_mc_chain (mc.py:394's whole chain in one call) is mc_init then
    one mc_chunk of every step from the same generator: the same
    container, bit for bit; every lane holds a pose, occupied slots hold
    finite energies and empty ones the empty-slot convention."""
    from gnina_tpu_torch.ops import fk as tfk

    lanes = 4
    lig_l = lane_ligands([system["tl"]], torch.zeros(lanes, dtype=torch.long))
    fns = system["te"]._energy_fns_for(
        system["te"]._make_efn(system["layers"]), lig_l, system["tr"],
        system["tbox"], tcg.CacheGrids(*[torch.tensor(np.asarray(x))
                                         for x in system["jgrids"]]),
        system["layers"])
    m = system["jl"].num_torsion_slots + 1
    ntors = system["jlig"].num_torsions
    par = tmc.MCParams(num_saved_mins=SLOTS, refine_stride=2,
                       minparams=MinimizeParams(maxiters=MAXIT))
    dof = (torch.arange(6 + m - 1) < 6 + ntors).expand(lanes, -1)
    nt = torch.full((lanes,), ntors)
    rig = torch.ones(lanes, dtype=torch.bool)
    with torch.no_grad():
        cont = tmc.run_mc_chain(torch.Generator().manual_seed(3), 4, lig_l,
                                fns, par, system["lo"], system["hi"],
                                system["layers"], dof, nt, rig)
        g = torch.Generator().manual_seed(3)
        carry = tmc.mc_init(
            lanes, m, par, system["lo"], system["hi"], lig_l.types.shape[1],
            g, lambda r, t: tfk.fk_coords(lig_l, fd.packed_to_conf(
                r, t, m - 1), system["layers"]), device="cpu")
        want = tmc.mc_chunk(carry, g, 4, lig_l, fns, par, system["layers"],
                            dof, nt, rig).cont
    for a, b in zip(cont, want):
        assert torch.equal(a, b)
    occ = cont.energy < MAX_FL
    assert occ.any(1).all() and torch.isfinite(cont.energy[occ]).all()
    assert (cont.coords[~occ] == 1e9).all()
