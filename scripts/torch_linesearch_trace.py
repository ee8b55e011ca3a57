"""The accurate line search of both packages, iteration by iteration, on the
CPU.

    python scripts/torch_linesearch_trace.py [--iters 5] [--ligand 0]

Runs DockingEngine.minimize (cnn_scoring="none", minimize_iters=--iters) of
the first three minout.sdf records near the origin against a synthetic
receptor (tests/test_torch_minimize.py's and test_torch_server.py's
system, tests/test_torch_gninagrid.write_origin_system), in the JAX package
and in the port, both on the CPU.  It prints:

- each ligand's final minimizedAffinity in both packages;
- for --ligand, every energy evaluation of the accurate line search in its
  first BFGS run (the slope-10 stage): the trial energies, then per
  iteration the accepted step alpha, its energy f1, the directional
  slope g.p and the starting energy f0, side by side, and the first
  iteration where alpha or f1 differ by more than 1e-5 relative;
- the same minimisation with every receptor coordinate moved by one
  float32 ulp (np.nextafter toward +inf), in each package: how far one
  rounding of the input moves each package's own result.

JAX's vmapped while loops run masked stages to the end, so its log can
hold more line searches than the port's: only the first run's are
compared.
"""

import argparse
import copy
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "..", "tests"))
sys.path.insert(0, os.path.join(HERE, ".."))


def instrument(jb, tb, jlog, tlog):
    """Wrap both packages' accurate_line_search to log trials and accepts."""
    import jax
    import jax.numpy as jnp
    import torch

    jorig, torig = jb.accurate_line_search, tb.accurate_line_search

    def jls(f_val, x, g, f0, p):
        def fv(c):
            f1 = f_val(c)
            jax.debug.callback(
                lambda v: jlog.append(("trial", float(np.ravel(v)[0]))), f1)
            return f1
        r = jorig(fv, x, g, f0, p)
        jax.debug.callback(
            lambda *v: jlog.append(("acc",) + tuple(
                float(np.ravel(a)[0]) for a in v)),
            r.alpha, r.f1, jnp.dot(g, p), f0)
        return r

    def tls(f_val, x, g, f0, p):
        def fv(c):
            f1 = f_val(c)
            tlog.append(("trial", float(f1.reshape(-1)[0])))
            return f1
        r = torig(fv, x, g, f0, p)
        tlog.append(("acc",) + tuple(float(a.reshape(-1)[0]) for a in (
            r.alpha, r.f1, torch.sum(g * p, -1), f0)))
        return r

    jb.accurate_line_search = jls
    tb.accurate_line_search = tls


def first_run(log, iters):
    """The entries of the first BFGS run: up to `iters` accepts."""
    out, n = [], 0
    for e in log:
        out.append(e)
        if e[0] == "acc":
            n += 1
            if n == iters:
                break
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ligand", type=int, default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(2)
    from gnina_tpu.chem import ingest as jingest
    from gnina_tpu.docking import DockingEngine as JEngine
    from gnina_tpu.docking import DockSettings as JSettings
    from gnina_tpu.ops import bfgs as jb
    from gnina_tpu_torch.chem import ingest as tingest
    from gnina_tpu_torch.docking import DockingEngine, DockSettings
    from gnina_tpu_torch.ops import bfgs as tb
    from test_torch_gninagrid import write_origin_system

    d = tempfile.mkdtemp()
    lig, rec = write_origin_system(d, n_ligs=3)
    settings = dict(cnn_scoring="none", minimize_iters=args.iters)
    jlog, tlog = [], []
    instrument(jb, tb, jlog, tlog)
    je = JEngine(JSettings(**settings))
    te = DockingEngine(DockSettings(**settings), device="cpu")
    jr = jingest.Receptor.from_file(rec)
    tr = tingest.Receptor.from_file(rec)
    jligs = list(jingest.iter_ligands(lig))
    tligs = list(tingest.iter_ligands(lig))
    for i, (jl, tl) in enumerate(zip(jligs, tligs)):
        jlog.clear()
        tlog.clear()
        a = je.minimize(jr, jl).energy
        b = te.minimize(tr, tl).energy
        print(f"ligand {i}: jax {a:.6f} port {b:.6f} port - jax {b - a:.3e}")
        if i != args.ligand:
            continue
        jrun, trun = first_run(jlog, args.iters), first_run(tlog, args.iters)
        print(f"ligand {i}, first BFGS run, {len(jrun)} / {len(trun)} "
              "evaluations (jax / port):")
        it, parted = 0, None
        for k in range(max(len(jrun), len(trun))):
            je_, te_ = (jrun[k] if k < len(jrun) else None,
                        trun[k] if k < len(trun) else None)

            def fmt(e):
                if e is None:
                    return "-"
                if e[0] == "trial":
                    return f"trial f1={e[1]:.9g}"
                return (f"alpha={e[1]:.9g} f1={e[2]:.9g} slope={e[3]:.9g} "
                        f"f0={e[4]:.9g}")

            print(f"  {k:3d} jax {fmt(je_):68s} port {fmt(te_)}")
            if je_ and te_ and je_[0] == te_[0] == "acc":
                it += 1
                rel = max(abs(je_[j] - te_[j]) / max(abs(je_[j]), 1e-30)
                          for j in (1, 2))
                if parted is None and rel > 1e-5:
                    parted = (it, rel)
        if parted:
            print(f"first iteration whose alpha or f1 differ by more than "
                  f"1e-5 relative: {parted[0]} ({parted[1]:.3e})")
        else:
            print("alpha and f1 agree within 1e-5 relative at every "
                  "iteration")

    def nudge(r):
        r2 = copy.copy(r)
        r2.coords = np.nextafter(np.asarray(r.coords, np.float32),
                                 np.float32(np.inf))
        return r2

    jl, tl = jligs[args.ligand], tligs[args.ligand]
    a, a2 = je.minimize(jr, jl).energy, je.minimize(nudge(jr), jl).energy
    b, b2 = te.minimize(tr, tl).energy, te.minimize(nudge(tr), tl).energy
    print(f"ligand {args.ligand}, receptor moved one float32 ulp: jax "
          f"{a:.6f} -> {a2:.6f} ({a2 - a:.3e}); port {b:.6f} -> {b2:.6f} "
          f"({b2 - b:.3e}); port - jax {b - a:.3e}")


if __name__ == "__main__":
    main()
