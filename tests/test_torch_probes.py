"""K9-K11, the rate probes: the port's plain versions against the Pallas
kernel bodies of scripts/tpu_pallas_probe.py, run in interpret mode on the
CPU at a small size on the same numpy inputs.

The script itself reads its sizes from the environment when imported and
times on a TPU, so the three kernel bodies are copied here with the sizes
as arguments and `interpret=True`; nothing of the script is imported.
Tolerances: the checksums are float32 sums of 10^4-10^5 terms taken in
another order, so they are held to 2e-5 of the sum of the terms' magnitudes
(float32) and to 2e-2 of it (bfloat16 arithmetic, which the two frameworks
round at different places: the TPU body sums in bfloat16, the port in
float32).  The one-hot contraction selects single bfloat16 values, which
both sides add in float32: 1e-5 of the magnitudes.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gnina_tpu_torch import probes

L, N, K, REPS = 16, 4, 64, 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs():
    return probes.make_inputs(7, L, N, K, device="cpu")


# ---- the TPU kernel bodies (scripts/tpu_pallas_probe.py), sizes as args ----

def jax_pairs(ligp, lig, rec, recp, dtype, n, lanes, reps):
    def kernel(ligp_ref, lig_ref, rec_ref, recp_ref, out_ref):
        recx = rec_ref[:, 0:1].astype(dtype)
        recy = rec_ref[:, 1:2].astype(dtype)
        recz = rec_ref[:, 2:3].astype(dtype)
        recr = rec_ref[:, 3:4].astype(dtype)
        rphi = recp_ref[:, 0:1].astype(dtype)
        rdon = recp_ref[:, 1:2].astype(dtype)
        racc = recp_ref[:, 2:3].astype(dtype)

        def vec1(x):
            return jnp.full((1, 1), x, jnp.float32).astype(dtype)

        def eval_once(carry):
            def atom_body(a, acc):
                ax = lig_ref[pl.ds(a, 1), :].astype(dtype)
                ay = lig_ref[pl.ds(n + a, 1), :].astype(dtype)
                az = lig_ref[pl.ds(2 * n + a, 1), :].astype(dtype)
                dx = recx - ax
                dy = recy - ay
                dz = recz - az
                r2 = dx * dx + dy * dy + dz * dz
                r = jnp.sqrt(r2)
                d = r - (recr + vec1(ligp_ref[0, a]))
                g1 = jnp.exp(-4.0 * d * d)
                dd = (d - 3.0) * 0.5
                g2 = jnp.exp(-dd * dd)
                rep = jnp.where(d < 0, d * d, 0.0)
                hyd = jnp.clip(-d * 1.4285715 - 0.5, 0.0, 1.0) \
                    * (vec1(ligp_ref[1, a]) * rphi)
                hb = jnp.clip(-d * 1.4285715 - 0.42857143, 0.0, 1.0) \
                    * (vec1(ligp_ref[2, a]) * racc
                       + vec1(ligp_ref[3, a]) * rdon)
                e = (-0.0356 * g1 - 0.00516 * g2 + 0.84 * rep
                     - 0.0351 * hyd - 0.587 * hb)
                e = jnp.where(r2 < 64.0, e, 0.0)
                return acc + jnp.sum(e, axis=0, keepdims=True)

            acc0 = jnp.full((1, lanes), carry * 1e-30,
                            jnp.float32).astype(dtype)
            acc = jax.lax.fori_loop(0, n, atom_body, acc0)
            return carry + jnp.sum(acc.astype(jnp.float32))

        out_ref[0, 0] = jax.lax.fori_loop(
            0, reps, lambda i, c: eval_once(c), jnp.float32(0.0))

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        interpret=True)(ligp, lig, rec, recp)


def jax_gather(idx, cells, w, a_total, reps):
    def kernel(idx_ref, cells_ref, w_ref, out_ref):
        def eval_once(carry):
            def body(a, acc):
                row = cells_ref[pl.ds(idx_ref[a], 1), 0:8]
                return acc + jnp.sum(row * w_ref[pl.ds(a, 1), :])

            return carry + jax.lax.fori_loop(0, a_total, body,
                                             jnp.float32(0.0))

        out_ref[0, 0] = jax.lax.fori_loop(
            0, reps, lambda i, c: eval_once(c), jnp.float32(0.0))

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        interpret=True)(idx, cells, w)


def jax_mxu(tgt, g, a_total, kdim, reps):
    def kernel(tgt_ref, g_ref, out_ref):
        def eval_once(carry):
            ii = jax.lax.broadcasted_iota(jnp.int32, (a_total, kdim), 1)
            w = jnp.where(ii == tgt_ref[:], 1.0, 0.0).astype(jnp.bfloat16)
            t = jnp.dot(w, g_ref[:], preferred_element_type=jnp.float32)
            return carry + jnp.sum(t)

        out_ref[0, 0] = jax.lax.fori_loop(
            0, reps, lambda i, c: eval_once(c), jnp.float32(0.0))

    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        interpret=True)(tgt, g)


def j(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


# --------------------------------------------------------------- tests ----

@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_probe_pairs_plain_matches_jax_body(inputs, dtype, tol):
    x = inputs
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = float(probes.probe_pairs(x["lig"], x["ligp"], x["rec"], x["recp"],
                                   REPS, dtype=tdt))
    ref = float(jax_pairs(j(x["ligp"]), j(x["lig"]), j(x["rec"]),
                          j(x["recp"]), jdt, N, L, REPS)[0, 0])
    mag = REPS * float(probes.pair_energies(
        x["lig"], x["ligp"], x["rec"], x["recp"]).abs().sum())
    assert mag > 0 and np.isfinite(got)
    assert abs(got - ref) <= tol * mag, (got, ref, mag)


def test_probe_pairs_energy_formula(inputs):
    """One pair by hand (numpy, float64) against pair_energies, 1e-5."""
    x = inputs
    e = probes.pair_energies(x["lig"], x["ligp"], x["rec"], x["recp"])
    assert e.shape == (N, K, L)
    a, k, l = 1, 5, 3
    lig, ligp = x["lig"].numpy().astype(np.float64), x["ligp"].numpy()
    rec, recp = x["rec"].numpy().astype(np.float64), x["recp"].numpy()
    dv = rec[k, :3] - np.array([lig[a, l], lig[N + a, l], lig[2 * N + a, l]])
    r2 = float(dv @ dv)
    d = np.sqrt(r2) - (rec[k, 3] + ligp[0, a])
    ref = (-0.0356 * np.exp(-4 * d * d)
           - 0.00516 * np.exp(-((d - 3) * 0.5) ** 2)
           + 0.84 * (d * d if d < 0 else 0.0)
           - 0.0351 * np.clip(-d * 1.4285715 - 0.5, 0, 1)
           * ligp[1, a] * recp[k, 0]
           - 0.587 * np.clip(-d * 1.4285715 - 0.42857143, 0, 1)
           * (ligp[2, a] * recp[k, 2] + ligp[3, a] * recp[k, 1]))
    ref = ref if r2 < 64.0 else 0.0
    assert abs(float(e[a, k, l]) - ref) <= 1e-5 * max(1.0, abs(ref))


def test_probe_gather_plain_matches_jax_body(inputs):
    x = inputs
    a_total = N * L
    got = float(probes.probe_gather_loop(x["idx"], x["cells"], x["w"], REPS))
    ref = float(jax_gather(j(x["idx"]), j(x["cells"]), j(x["w"]), a_total,
                           REPS)[0, 0])
    mag = REPS * float((x["cells"][x["idx"].long(), :8] * x["w"]).abs().sum())
    assert abs(got - ref) <= 2e-5 * mag, (got, ref, mag)


def test_probe_mxu_plain_matches_jax_body(inputs):
    x = inputs
    a_total = N * L
    got = float(probes.probe_mxu(x["tgt"], x["g"], REPS))
    ref = float(jax_mxu(j(x["tgt"]), j(x["g"]), a_total, probes.MXU_KDIM,
                        REPS)[0, 0])
    sel = x["g"].float()[x["tgt"][:, 0].long()]
    mag = REPS * float(sel.abs().sum())
    assert abs(got - ref) <= 1e-5 * mag, (got, ref, mag)
    # the checksum is the sum of the selected rows of g, REPS times
    assert abs(got - REPS * float(sel.sum())) <= 1e-5 * mag


def test_inputs_have_the_script_shapes(inputs):
    x = inputs
    a = N * L
    assert x["lig"].shape == (3 * N, L) and x["ligp"].shape == (8, N)
    assert x["rec"].shape == (K, 4) and x["recp"].shape == (K, 4)
    assert x["idx"].shape == (a,) and x["idx"].dtype == torch.int32
    assert x["cells"].shape == (probes.GATHER_ROWS, 128)
    assert x["w"].shape == (a, 8) and x["tgt"].shape == (a, 1)
    assert x["g"].shape == (896, 128) and x["g"].dtype == torch.bfloat16
    assert int(x["tgt"].max()) < probes.MXU_KDIM - 1
    y = probes.make_inputs(7, L, N, K, device="cpu")
    assert all(torch.equal(x[k], y[k]) for k in x)


def test_probes_need_a_card_unless_told(monkeypatch):
    """device=None is the card: without one the entry points raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.make_inputs(0, L, N, K)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.run()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.main([])


def test_probe_script_prints_one_json_line_each(monkeypatch):
    for k, v in (("PROBE_L", L), ("PROBE_N", N), ("PROBE_K", K),
                 ("PROBE_REPS", 2)):
        monkeypatch.setenv(k, str(v))
    buf = io.StringIO()
    probes.run("cpu", out=buf)
    lines = buf.getvalue().strip().splitlines()
    rows = [json.loads(s) for s in lines[1:]]
    assert [r["probe"] for r in rows] == ["pairs_f32", "pairs_bf16",
                                          "gather_loop", "mxu_onehot"]
    assert all(r["us_per_eval"] >= 0 and r["ns_per_unit"] >= 0 for r in rows)
    monkeypatch.setenv("PROBE_WHICH", "gather")
    buf = io.StringIO()
    probes.run("cpu", out=buf)
    assert len(buf.getvalue().strip().splitlines()) == 2
    # CPU tensors never count as launches
    assert all(p.launches == 0 for p in probes.PROBES)
