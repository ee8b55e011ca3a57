#!/usr/bin/env python3
"""The benchmark of the port, gnina_tpu_torch: one run of one cell.

    python3 dockbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (timed as setup_s, from this file's first line): import torch and
the port, write the cell's receptor into a temporary directory, and make
one warm-up call of the command line on a call's worth of each size
class (molecules the window never docks) at 16 Monte Carlo steps, which
builds or loads the port's CUDA and native libraries, loads the CNN
ensemble and brings up every kernel at the cell's shapes.  The window: a
closed loop of `gnina_tpu_torch.cli.main` calls in this process, each one
screen of a file of ligands of one size class, the classes in turn; it
ends with the first whole round of classes that ends past the deadline,
so every window holds as many calls of each class.
After the window: the import check (no jax, jaxlib, flax or gnina_tpu
module loaded), the peak memory, then the reference's judgement of every
pose written.  The last line of standard output is the result, as JSON;
the numbers compared, each beside its limit, end standard error.

With --trace 1 the run records spans and the card's kernel intervals
(dockbench/trace.py) and reports the per-layer metrics.  The run exits
with 2 and prints no result without the card(s) the cell asks for.
"""

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, ".cache")
# every build and kernel cache at a fixed place inside the checkout
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = os.path.join(CACHE, _sub)
sys.path.insert(0, ROOT)

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402

import numpy as np  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gnina_tpu")


def fail(msg: str, code: int = 1):
    sys.stderr.write(f"dockbench: {msg}\n")
    sys.exit(code)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cli_args(cfg, screen, rec_path, lig_path, out_path, seed, device,
             mc_steps=None):
    center, size = screen.box()
    argv = ["-r", rec_path, "-l", lig_path, "-o", out_path, "-q",
            "--seed", str(seed)]
    for ax, c, s in zip("xyz", center, size):
        argv += [f"--center_{ax}", repr(float(c)), f"--size_{ax}",
                 repr(float(s))]
    argv += list(cfg["flags"])
    if mc_steps is not None:
        argv += ["--num_mc_steps", str(mc_steps)]
    if device is not None:
        argv += ["--device", device]
    return argv


def best_by_ligand(text: str):
    """{name: lowest written minimizedAffinity} of an output SDF."""
    best = {}
    for block in text.split("$$$$\n"):
        if not block.strip():
            continue
        name = block.split("\n", 1)[0].strip()
        k = block.find("<minimizedAffinity>")
        if k < 0:
            continue
        v = float(block[k:].split("\n")[1])
        best[name] = min(v, best.get(name, np.inf))
    return best


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device=None, root: str = ROOT, shrink=None, fault=None,
        control: bool = False) -> dict:
    """One run; returns the result's fields and the lines of numbers
    compared.  device None: the card.  shrink, fault: the CPU tests' hooks
    (a smaller job; a function that breaks the timed path).  control: also
    judge the control (dockbench/control.py) on the window's poses."""
    from dockbench import gen, lookup
    from dockbench.reference import check

    bench = lookup.benchmark(root)
    cell = lookup.cell(bench, cell_name)
    cfg = lookup.config(bench, cell["config"], root)
    traffic = lookup.traffic(cell["traffic"])
    limits = lookup.limits(cell_name)
    if shrink is not None:
        cfg, traffic = shrink(cfg, traffic)

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < cell["chips"]:
            fail(f"{cell_name} needs {cell['chips']} CUDA device(s); "
                 f"found {torch.cuda.device_count()}", 2)
    from gnina_tpu_torch import cli
    on_card = device is None
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    phases = [("imports", time.perf_counter())]
    screen = gen.Screen(traffic, CACHE)
    tmp = tempfile.TemporaryDirectory(prefix="dockbench_")
    rec_path = os.path.join(tmp.name, "receptor.pdb")
    rec_text = screen.receptor_pdb()
    with open(rec_path, "w") as f:
        f.write(rec_text)
    phases.append(("inputs", time.perf_counter()))
    out_path = os.path.join(tmp.name, "out.sdf")
    for cls in dict.fromkeys(traffic["call_classes"]):
        lp = os.path.join(tmp.name, f"warm_{cls}.sdf")
        with open(lp, "w") as f:
            f.write(gen.sdf_text(screen.warmup(cls)))
        if cli.main(cli_args(cfg, screen, rec_path, lp, out_path, 0, device,
                             traffic["warmup_mc_steps"])) != 0:
            fail(f"warm-up call on class {cls} failed")
        sync()
        phases.append((f"warm-up {cls}", time.perf_counter()))
    t_prev = T_START
    for what, t in phases:
        sys.stderr.write(f"set-up {what}: {t - t_prev:.3f} s\n")
        t_prev = t
    sys.stderr.write(f"set-up {time.perf_counter() - T_START:.3f} s\n")
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    tracer = None
    if trace:
        from dockbench.trace import Tracer
        tracer = Tracer(torch)
        tracer.install()
        if on_card:
            tracer.start_profiler()
    if fault is not None:
        fault(cli)

    calls = []
    t_window = time.perf_counter()
    k = 0
    while True:
        cls, ligs, dseed = screen.call(seed, k)
        lp = os.path.join(tmp.name, f"call_{k}.sdf")
        text_in = gen.sdf_text(ligs)
        with open(lp, "w") as f:
            f.write(text_in)
        t0 = time.perf_counter()
        rc = cli.main(cli_args(cfg, screen, rec_path, lp, out_path, dseed,
                               device))
        t1 = time.perf_counter()
        text_out = ""
        if rc == 0 and os.path.exists(out_path):
            with open(out_path) as f:
                text_out = f.read()
            os.remove(out_path)
        os.remove(lp)
        calls.append(dict(cls=cls, round=screen.call_round(k), t0=t0, t1=t1,
                          names=[l.name for l, _ in ligs],
                          text_in=text_in, text_out=text_out, rc=rc,
                          best=best_by_ligand(text_out)))
        sys.stderr.write(f"call {k} class {cls}: {t1 - t0:.3f} s, rc {rc}\n")
        k += 1
        if t1 - t_window >= seconds and screen.call_round(k) != calls[-1][
                "round"]:
            break
    t_end = calls[-1]["t1"]
    sync()

    kernels = []
    if tracer is not None:
        if on_card:
            kernels = tracer.stop_profiler()
        tracer.uninstall()
    memory_peak = int(torch.cuda.max_memory_allocated()) if on_card else 0
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    found = forbidden_modules()
    if found:
        fail("modules of the JAX package loaded in the run: "
             + ", ".join(found))

    # the reference's judgement of every pose written in the window
    from dockbench.reference import chem, cnn
    rec = check.Receptor(rec_text)
    models = None
    if cfg["cnn_models"]:
        models = cnn.load_models(cfg["cnn_models"], os.path.join(
            root, cfg["models_dir"]), "cuda" if on_card else "cpu")
    inputs = {}
    judged = []
    for c in calls:
        gs = [check.given(m) for m in chem.parse_sdf(c["text_in"])]
        for g in gs:
            inputs[g.mol.name] = g
        judged.append((gs, c["text_out"]))
    t_judge = time.perf_counter()
    j = check.judge(judged, rec, screen.box(), cfg["check"], models,
                    "cuda" if on_card else "cpu")
    sys.stderr.write(f"judged {j['poses']} poses in "
                     f"{time.perf_counter() - t_judge:.3f} s\n")
    correct, rows = check.verdict(j["readings"], limits)
    control_rows = None
    if control:
        jc = check.judge(judged, rec, screen.box(), cfg["check"], models,
                         "cuda" if on_card else "cpu", control=True)
        control_rows = check.verdict(jc["readings"], limits)

    attempted = sum(len(c["names"]) for c in calls)
    failed = sum(1 for c in calls for n in c["names"] if n not in c["best"])
    ctx = types.SimpleNamespace(
        calls=calls, setup_s=t_window - T_START, window_s=t_end - t_window,
        attempted=attempted, failed=failed)
    if tracer is not None:
        ctx.tracer = tracer
        ctx.kernels = kernels
        _trace_context(ctx, tracer, kernels, calls, inputs, rec, screen,
                       models, int(t_window * 1e9), int(t_end * 1e9))
    out_metrics = {}
    for m in lookup.metrics(bench, cell_name, trace):
        v = lookup.reader(m["name"])(ctx)
        if v is not None:
            out_metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell["chips"], "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": out_metrics, "device": dev}
    if tracer is not None:
        dev["busy_s"] = ctx.busy_s
        dev["window_s"] = ctx.window_s
        result["breakdown"] = ctx.breakdown
    result["checked"] = {r[0]: {"value": r[1], "limit": r[2]} for r in rows}
    tmp.cleanup()
    return dict(result=result, rows=rows, faults=j["faults"],
                poses=j["poses"], control=control_rows)


def _trace_context(ctx, tracer, kernels, calls, inputs, rec, screen, models,
                   t0: int, t1: int):
    """What the per-layer readers read: spans, kernel calls with the work
    their inputs need, the card's busy time and the breakdown."""
    from dockbench import roofline
    from dockbench.reference import chem
    from dockbench.trace import breakdown, busy_in, union

    heavy_rec = rec.xyz[~chem.IS_H[rec.types]]
    center, size = screen.box()
    lo = center - size / 2 - roofline.CUTOFF
    hi = center + size / 2 + roofline.CUTOFF
    ctx.rec_atoms = int(np.all((heavy_rec >= lo) & (heavy_rec <= hi),
                               axis=1).sum())
    # per ligand: mean pairs inside the cutoff over its written poses, its
    # movable intramolecular pairs, atoms and torsions
    work = {}
    for c in calls:
        for m in chem.parse_sdf(c["text_out"]):
            work.setdefault(m.name, []).append(m)
    ctx.ligand_work = {}
    for name, ms in work.items():
        xyz = np.stack([m.coords[m.heavy] for m in ms])
        g = inputs[name]
        ctx.ligand_work[name] = dict(
            inter=float(roofline.in_cutoff_pairs(xyz, heavy_rec).mean()),
            intra=chem.intra_pairs(g.mol), atoms=len(g.mol.elems),
            torsions=g.num_tors)
    for launch in tracer.launches:
        if launch["stats"] is not None:
            launch["stats"] = launch["stats"].double().cpu().numpy()
        launch["lane_lig"] = launch["lane_lig"].cpu().numpy()
    ctx.cnn_flops_per_pose = 0.0
    if models is not None:
        for m in models:
            ctx.cnn_flops_per_pose += roofline.model_flops(
                m.spec, m.params, m.rec_channels + m.lig_channels, m.points)
    merged = union(kernels)
    ctx.merged = merged
    ctx.busy_s = busy_in(merged, t0, t1) / 1e9
    ctx.breakdown = breakdown(kernels, merged, tracer.spans, t0, t1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    for f in out["faults"]:
        sys.stderr.write(f"fault: {f}\n")
    for name, value, limit in out["rows"]:
        sys.stderr.write(f"check {name}: {value!r} (limit {limit!r})\n")
    sys.stdout.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
