"""The port's MC windows against JAX's interpreted kernel on supplied draws:
the numbers behind tests/test_torch_supplied_draws.py, on the CPU.

    python scripts/torch_supplied_draws_report.py [--out FILE.json]

Runs that test's three JAX runs (K3, K5, and two windows of the MC driver;
JAX's Pallas kernel in interpret mode, its TPU PRNG served seeded uniforms
by scripts/jax_supplied_draws.py) and prints one JSON object with, for
each of the four windows:

  rows     completed rows; of them position, orientation and torsion
           mutations and Metropolis rejections; rows never completed
  replay   each JAX row against the port's plain step from JAX's own
           chain head on the row's uniforms: the largest |port - JAX| of
           energy (kcal/mol), position (A) and torsions (rad), the rows
           outside the stated bound (rtol 5e-4 / atol 5e-3 on energies,
           2e-3 on positions and torsions) and, for those, the port's own
           change when the chain head moves one ulp ("conditioning")
  whole    the port's whole window from the same start against JAX's
           window: per lane the first row outside the stated bound or
           with other flags (null: none), and the largest |de| over the
           rows both completed
  control  the port's whole window against itself started one ulp away
           (x of every start moved to the next float32): the same
           measures, which float32 alone produces

The test holds the replay; `whole` and `control` show why whole windows
are not compared row for row.  About 2 minutes.
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for p in (ROOT, os.path.join(ROOT, "tests"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def row_errors(a, b, done_a, done_b):
    """(L, S) rows: outside the stated bound or with other flags."""
    ea, eb = a["sstat"][..., 0], b["sstat"][..., 0]
    bad = np.abs(ea - eb) > 5e-3 + 5e-4 * np.abs(eb)
    bad |= np.abs(a["srig"][..., :3] - b["srig"][..., :3]).max(-1) > 2e-3
    bad |= np.abs(a["stor"] - b["stor"]).max(-1) > 2e-3
    bad &= done_a & done_b
    bad |= done_a != done_b
    bad |= (a["sstat"][..., 1] > 0.5) != (b["sstat"][..., 1] > 0.5)
    return bad


def whole(a, b, async_mc):
    done_a = a["sstat"][..., 2] > 0.5 if async_mc else np.ones(
        a["sstat"].shape[:2], bool)
    done_b = b["sstat"][..., 2] > 0.5 if async_mc else np.ones_like(done_a)
    bad = row_errors(a, b, done_a, done_b)
    both = done_a & done_b
    de = np.abs(a["sstat"][..., 0] - b["sstat"][..., 0])[both]
    return {"first_row_off": [int(np.argmax(r)) if r.any() else None
                              for r in bad],
            "max_abs_de": float(de.max()) if de.size else 0.0}


def as_dict(out):
    """A port window's outputs -> unpack_window's keys."""
    return dict(rigid=out[0].numpy(), tors=out[1].numpy(),
                stats=out[2].numpy(), srig=out[4].numpy(),
                stor=out[5].numpy(), sstat=out[6].numpy())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import concurrent.futures
    import multiprocessing

    import torch

    import test_torch_supplied_draws as T

    torch.set_num_threads(2)
    rec_dir = tempfile.mkdtemp()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(3, mp_context=ctx) as ex:
        futs = {k: ex.submit(T.jax_side, k, rec_dir)
                for k in ("K3", "K5", "driver")}
        runs = {k: f.result() for k, f in futs.items()}
    system = T.make_system(rec_dir)
    t = lambda a: torch.as_tensor(np.array(a))
    cases = []
    for kind in ("K3", "K5"):
        async_mc = kind == "K3"
        u = T.window_uniforms(T.S_STEPS * T.BUDGET if async_mc
                              else T.S_STEPS)
        cases.append((kind, async_mc, runs[kind], system["rigid"].numpy(),
                      system["tors"].numpy(),
                      np.full(T.LANES, 3.0e38, np.float32), u))
    for k, w in enumerate(runs["driver"]["windows"]):
        cases.append((f"driver window {k}", True, w, w["rigid_in"],
                      w["tors_in"], w["ecur_in"], T.driver_uniforms()[k]))

    def port_window(async_mc, rigid, tors, ecur, u):
        if async_mc:
            return as_dict(T.fd.async_mc_window_plain(
                system["terms"], rigid, tors, T.scal_port(system),
                system["tpack"], ecur, T.S_STEPS, T.BUDGET, T.MAXIT,
                T.TRIALS, uniforms=u))
        return as_dict(T.fd.lockstep_mc_window_plain(
            system["terms"], rigid, tors, T.scal_port(system),
            system["tpack"], ecur, T.S_STEPS, T.MAXIT, T.TRIALS,
            uniforms=u))

    report = {"system": "tests/test_torch_interpret_draws.py make_system: "
              f"{T.LANES} lanes, S = {T.S_STEPS}, budget {T.BUDGET} "
              f"(K3), {T.MAXIT} BFGS iterations of up to {T.TRIALS} "
              "trials", "windows": {}}
    for name, async_mc, w, rigid0, tors0, ecur, u in cases:
        rargs = (system, async_mc, t(rigid0), t(tors0), t(ecur),
                 (t(w["srig"]), t(w["stor"]), t(w["sstat"])), t(u))
        rep = T.replay_rows(*rargs)
        cond = T.conditioning(*rargs, rep)
        sstat = w["sstat"]
        done = sstat[..., 2] > 0.5 if async_mc else np.ones(
            sstat.shape[:2], bool)
        pos, ori, tor = T.mutation_kinds(rep, done)
        errs, off = {}, np.zeros_like(done)
        for key, jv, atol, rtol in (("e", sstat[..., 0], 5e-3, 5e-4),
                                    ("pos", w["srig"][..., :3], 2e-3, 0.0),
                                    ("tors", w["stor"], 2e-3, 0.0)):
            pv = rep[key].numpy().reshape(jv.shape)
            d = np.abs(jv - pv).reshape(jv.shape[:2] + (-1,)).max(-1)
            lim = atol + rtol * np.abs(pv).reshape(d.shape + (-1,)).max(-1)
            errs[key] = float(d[done].max())
            off |= done & (d > lim)
        own = port_window(async_mc, t(rigid0), t(tors0), t(ecur), t(u))
        moved = t(rigid0).clone()
        moved[:, 0] = torch.nextafter(moved[:, 0],
                                      torch.full_like(moved[:, 0], 1e9))
        own2 = port_window(async_mc, moved, t(tors0), t(ecur), t(u))
        report["windows"][name] = {
            "rows": {"completed": int(done.sum()),
                     "position": int(pos.sum()),
                     "orientation": int(ori.sum()),
                     "torsion": int(tor.sum()),
                     "rejected": int(((sstat[..., 1] < 0.5) & done).sum()),
                     "never_completed": int((~done).sum())},
            "replay": {"max_abs_diff": errs,
                       "rows_outside_stated_bound": np.argwhere(
                           off).tolist(),
                       "their_conditioning": {
                           k: cond[k][off].tolist() for k in cond}},
            "whole": whole(own, w, async_mc),
            "control": whole(own2, own, async_mc)}
    text = json.dumps(report, indent=1)
    print(text)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
