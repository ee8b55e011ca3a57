"""JAX's Pallas interpreter draws only zeros, and the port's MC windows
reproduce JAX's interpret-mode kernel on zero draws.

The TPU PRNG is not implemented by the Mosaic TPU interpreter of the JAX
installed here: `pltpu.prng_seed` does nothing and `pltpu.prng_random_bits`
returns zeros (jax/_src/pallas/mosaic/interpret/interpret_pallas_call.py,
the prng_seed_p and prng_random_bits_p cases).  So make_bfgs_kernel's MC
modes, run in interpret mode on the CPU, see every uniform u01 = 0
(gnina_tpu/ops/pallas_dock.py:232-240): `mutate` always picks the position
(:1038-1078), `rand_sphere` always gives (1, 0, 1)/sqrt(2) at radius
cbrt(1e-7) (:1009-1024), and Metropolis (:1241, :1299) accepts every
candidate whose exp(...) does not underflow.  JAX's fused route does no
search on the CPU; a comparison of search quality against it says nothing
of the route the JAX package runs on a TPU.

The same fact makes the kernel's MC modes comparable with the port's plain
windows, which take their uniforms as given: with all-zero uniforms the
port's K3 (async_mc_window_plain) and K5 (lockstep_mc_window_plain) must
give JAX's interpret-mode stream row for row.  Bounds are the port's own
for K3 against its plain version: stream rows (one candidate search each)
at the one-iteration bound, rtol 5e-4 / atol 5e-3 on energies and 2e-3 A on
positions, with the accept and completed flags equal; the final chain
state at the three-iteration bound, rtol 1e-2 / atol 5e-2 and 2e-2 A.
"""

import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.ops import pallas_dock as pd
from gnina_tpu.scoring import terms as jterms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu.types import pad_receptor as jpad_receptor
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import convert
from gnina_tpu_torch.ops import fused_dock as fd

LANES, M_PAD, S_STEPS, MAXIT, TRIALS = 8, 4, 4, 1, 4
BUDGET = 1 + MAXIT * TRIALS         # ticks of the worst step
HUNT = (10.0, 10.0, 1e3, 1000.0)    # v_intra, v_inter, slope, v_metro


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_interpreter_draws_only_zeros():
    """Two blocks of a pallas_call that seeds the TPU PRNG (a different
    seed per block) and draws 8 x 128 bits each, under the Mosaic TPU
    interpreter: all 2,048 draws are 0."""
    def kernel(seed_ref, out_ref):
        pltpu.prng_seed(seed_ref[0, 0] + pl.program_id(0))
        out_ref[...] = pltpu.prng_random_bits(out_ref.shape)

    fn = pl.pallas_call(
        kernel, grid=(2,),
        in_specs=[pl.BlockSpec((1, 1), lambda i: (0, 0),
                               memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((8, 128), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((16, 128), jnp.int32),
        interpret=pltpu.InterpretParams())
    bits = np.asarray(fn(jnp.full((1, 1), 12345, jnp.int32)))
    assert bits.size == 2048
    assert int(np.count_nonzero(bits)) == 0, (
        "the Pallas interpreter now implements the TPU PRNG: JAX's fused "
        "route searches on the CPU again; re-run "
        "scripts/torch_quality_vs_jax.py for its jax_fused column and "
        "revisit this test")
    # and the kernel's uniforms are then 0
    assert float(jnp.max(pd.u01_from_bits(jnp.asarray(bits)))) == 0.0


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
    return make_system(tmp_path_factory.mktemp("rec"))


def make_system(rec_dir):
    """The `system` fixture's value, its receptor file written into the
    directory rec_dir."""
    jlig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    tlig = convert.ligand_from_numpy(
        {f.name: getattr(jlig, f.name) for f in dataclasses.fields(jlig)
         if f.name not in ("mol", "other_pairs", "flex_meta")})
    center = fx.ligand_center(jlig)
    path = pathlib.Path(rec_dir) / "rec.pdb"
    path.write_text(fx.receptor_pdb_text(center, seed=4, cube=22.0))
    jrec = jingest.Receptor.from_file(str(path))
    pr = jrec.pruned(center, np.full(3, 6.0), margin=2.0)
    lo = (center - 6.0).astype(np.float32)
    hi = (center + 6.0).astype(np.float32)
    jsf = jget_sf("vina")
    tsf = port_sf(jsf)
    kr = len(pr.types)
    tpack = fd.build_pack([tlig], pr.coords, pr.types,
                          np.ones(kr, np.float32), LANES, tsf.table,
                          m_pad=M_PAD, device="cpu")
    rd = jpad_receptor(pr.coords, pr.types, pr.charges,
                       -(-kr // pd.KB) * pd.KB)
    jpack = pd.build_pack([jlig], np.asarray(rd.coords), np.asarray(rd.types),
                          np.asarray(rd.charges), np.asarray(rd.mask),
                          exhaustiveness=LANES, table=jsf.table)
    rng = np.random.default_rng(21)
    rigid, tors = fx.packed_poses(rng, LANES, lo, hi, tlig, M_PAD, "cpu",
                                  "perturbed")
    return dict(jsf=jsf, tpack=tpack, jpack=jpack, lo=lo, hi=hi,
                terms=fd.extract_vina_terms(tsf), rigid=rigid, tors=tors,
                jlig=jlig, tsf=tsf)


def jax_window(system, async_mc):
    """JAX's kernel in an MC mode, interpret mode, from the system's starts
    (padded to the block's 128 lanes): final rigid (L, 8), tors (L, M),
    stats (L, 8) and the stream srig (L, S, 8), stor (L, S, M), sstat
    (L, S, 3 or 2)."""
    fused = pd.FusedBfgs(system["jsf"], system["jpack"], maxiters=MAXIT,
                         want_metro=True, interpret=True, mc_steps=S_STEPS,
                         async_mc=async_mc, tick_budget=BUDGET,
                         num_trials=TRIALS)
    assert fused.m == M_PAD
    l_pad = system["jpack"].lc.shape[-1]

    def pad(t):
        return jnp.pad(jnp.asarray(t.numpy().T), ((0, 0), (0, l_pad - LANES)))

    scal = fused.scal(*HUNT, system["lo"], system["hi"])
    ecur = jnp.full((1, l_pad), 3.0e38, jnp.float32)
    out = fused.run_mc(pad(system["rigid"]), pad(system["tors"]), scal, 7,
                       ecur)
    frig, ftor, fstats, _, srig, stor, sstat = [np.asarray(x) for x in out]

    def stream(a, width):
        # async: component-major rows (c * S + j); lockstep: step-major
        # (j * width + c), pallas_dock.py:1303-1306
        if async_mc:
            a = a.reshape(width, S_STEPS, l_pad).transpose(1, 0, 2)
        return a.reshape(S_STEPS, width, l_pad)[..., :LANES].transpose(
            2, 0, 1)

    return (frig[:, :LANES].T, ftor[:, :LANES].T, fstats[:, :LANES].T,
            stream(srig, 8), stream(stor, M_PAD),
            stream(sstat, 3 if async_mc else 2))


def port_window(system, async_mc):
    scal = fd.scal_vector(*HUNT, system["lo"], system["hi"], device="cpu")
    ecur = torch.full((LANES,), 3.0e38)
    if async_mc:
        zeros = torch.zeros((S_STEPS * BUDGET, fd.N_DRAWS, LANES))
        return fd.async_mc_window_plain(
            system["terms"], system["rigid"], system["tors"], scal,
            system["tpack"], ecur, S_STEPS, BUDGET, MAXIT, TRIALS,
            uniforms=zeros, trace=True)
    zeros = torch.zeros((S_STEPS, fd.N_DRAWS, LANES))
    return fd.lockstep_mc_window_plain(
        system["terms"], system["rigid"], system["tors"], scal,
        system["tpack"], ecur, S_STEPS, MAXIT, TRIALS, uniforms=zeros,
        trace=True)


@pytest.mark.parametrize("async_mc", [True, False], ids=["K3", "K5"])
def test_plain_window_on_zero_draws_is_the_interpreted_kernel(system,
                                                              async_mc):
    """K3 (async_mc) and K5 (lockstep): the port's plain window on all-zero
    uniforms against JAX's interpret-mode kernel from the same starts.
    Stream rows (every step completes: the budget covers the worst step)
    at the one-iteration bound with equal flags; the chain state at the
    three-iteration bound.  Every step's mutation moved the position only,
    by the fixed zero-draw nudge, and (with no uniform above 0) every
    finite candidate was accepted."""
    jr, jt, js, jsr, jst, jss = jax_window(system, async_mc)
    crig, ctors, stats, _, srig, stor, sstat, tr = port_window(system,
                                                              async_mc)
    if async_mc:
        assert (jss[..., 2] == 1).all() and (sstat[..., 2] == 1).all()
    np.testing.assert_array_equal(sstat[..., 1].numpy(), jss[..., 1])
    assert (jss[..., 1] == 1).all()
    np.testing.assert_allclose(sstat[..., 0].numpy(), jss[..., 0],
                               rtol=5e-4, atol=5e-3)
    np.testing.assert_allclose(srig[..., :3].numpy(), jsr[..., :3],
                               atol=2e-3)
    np.testing.assert_allclose(stor.numpy(), jst, atol=2e-3)
    np.testing.assert_allclose(stats[:, 0].numpy(), js[:, 0], rtol=1e-2,
                               atol=5e-2)
    np.testing.assert_allclose(crig[:, :3].numpy(), jr[:, :3], atol=2e-2)
    np.testing.assert_allclose(ctors.numpy(), jt, atol=2e-2)
    # each step's mutated start: the previous chain head (every step was
    # accepted) moved by amplitude 2 x cbrt(1e-7) along (1, 0, 1)/sqrt(2),
    # orientation and torsions untouched
    head = torch.cat([system["rigid"][:, None], srig[:, :-1]], 1)
    heads_t = torch.cat([system["tors"][:, None], stor[:, :-1]], 1)
    nudge = 2.0 * np.exp(np.log(1e-7) / 3.0) * np.array(
        [1.0, 0.0, 1.0]) / np.sqrt(2.0)
    np.testing.assert_allclose(
        (tr["start_rigid"][..., :3] - head[..., :3]).numpy(),
        np.broadcast_to(nudge, (LANES, S_STEPS, 3)), atol=1e-5)
    assert torch.equal(tr["start_rigid"][..., 3:7], head[..., 3:7])
    assert torch.equal(tr["start_tors"], heads_t)
