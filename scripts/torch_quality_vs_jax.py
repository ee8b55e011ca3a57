"""Search quality of the port against both JAX docking routes, on the CPU.

    python scripts/torch_quality_vs_jax.py [--seeds 0,1,2] [--steps 64]
        [--chains 4] [--jobs 3] [--out TORCH_QUALITY_VS_JAX.json]

Docks the job of tests/test_torch_dock.py (two copies of the minout.sdf
ligand in a 12 A box of the seed-0 synthetic receptor of an 18 A cube,
SETTINGS: no CNN, num_mc_saved 9) on three routes, for each seed:

  port       gnina_tpu_torch's DockingEngine.dock_batch on the CPU (the
             kernels' plain versions, the fused route)
  jax_off    the JAX package with fused_search="off" (its general XLA path)
  jax_fused  the JAX package with fused_search="on": the Pallas kernel in
             interpret mode, the route the JAX package takes on a TPU

`--steps` and `--chains` set num_mc_steps and exhaustiveness (the test's
64 and 4); the same job runs on all three routes and is written into the
JSON.  A seed's best is the mean over the two ligands of each ligand's top
pose energy (kcal/mol), as the test takes it.  The JSON holds per route the
per-seed bests, their mean, spread (max - min) and the wall of each run,
and per JAX route the port's mean difference over every seed and over the
first three, each with the bar of scripts/quality_gate.py (max(seed
spread, 0.25)) over the same seeds and the number of seeds of the mean's
sign.  A run whose seeds are all in the JSON only rewrites the summary.  Each (route, seed) runs
in its own process, `--jobs` at once; the JSON is rewritten after every
run, so an interrupted sweep keeps what finished.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

ROUTES = ("port", "jax_off", "jax_fused")
BOX = 12.0
CUBE = 18.0
BAR = 0.25      # kcal/mol, scripts/quality_gate.py's floor of the gap bar


def _job(steps: int, chains: int) -> dict:
    return dict(cnn_scoring="none", num_mc_steps=steps,
                exhaustiveness=chains, num_mc_saved=9)


def dock_one(route: str, seed: int, steps: int, chains: int,
             rec_path: str) -> dict:
    """One (route, seed): {"best": kcal/mol, "wall_s": s}."""
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import torch

    torch.set_num_threads(2)
    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch.chem import ingest as tingest

    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    center = np.asarray(center, np.float32)
    size = np.full(3, BOX, np.float32)
    settings = _job(steps, chains)
    t0 = time.perf_counter()
    if route == "port":
        from gnina_tpu_torch.docking import DockingEngine, DockSettings

        rec = tingest.Receptor.from_file(rec_path)
        lig = fx.ligand()
        eng = DockingEngine(DockSettings(**settings), device="cpu")
        res = eng.dock_batch(rec, [lig, lig], center, size, seed=seed)
    else:
        from gnina_tpu.chem import ingest as jingest
        from gnina_tpu.docking import DockingEngine as JEngine
        from gnina_tpu.docking import DockSettings as JSettings

        rec = jingest.Receptor.from_file(rec_path)
        lig = next(jingest.iter_ligands(fx.LIGAND_SDF))
        mode = "off" if route == "jax_off" else "on"
        eng = JEngine(JSettings(fused_search=mode, **settings))
        res = eng.dock_batch(rec, [lig, lig], center, size, seed=seed)
    wall = time.perf_counter() - t0
    return {"best": float(np.mean([r[0].energy for r in res])),
            "wall_s": wall}


def gap(port: dict, ref: dict, seeds: list) -> dict:
    """The port's mean difference to a route over `seeds`, its spread, how
    many seeds have the mean's sign, and quality_gate.py's bar over the
    same seeds."""
    d = np.array([port[s]["best"] - ref[s]["best"] for s in seeds])
    pb = np.array([port[s]["best"] for s in seeds])
    rb = np.array([ref[s]["best"] for s in seeds])
    spread = max(float(pb.max() - pb.min()), float(rb.max() - rb.min()))
    bar = max(spread, BAR)
    return {"seeds": seeds, "mean_diff": float(d.mean()),
            "per_seed_diff": d.tolist(),
            "same_sign": int((np.sign(d) == np.sign(d.mean())).sum()),
            "sd_of_mean_diff": (float(np.sqrt(pb.var(ddof=1) / len(seeds)
                                              + rb.var(ddof=1) / len(seeds)))
                                if len(seeds) > 1 else None),
            "bar": bar, "within_bar": bool(abs(d.mean()) <= bar)}


def summarise(out: dict) -> None:
    """Means, spreads and the port's gap to each JAX route, over every seed
    both ran and over the first three (the sweep's own size: the bar, a
    max - min spread, widens as seeds are added)."""
    for route in ROUTES:
        runs = out["routes"][route]["per_seed"]
        b = np.array([runs[s]["best"] for s in sorted(runs)])
        if len(b):
            out["routes"][route].update(
                mean=float(b.mean()), spread=float(b.max() - b.min()),
                sd=float(b.std(ddof=1)) if len(b) > 1 else None)
    port = out["routes"]["port"]
    for route in ("jax_off", "jax_fused"):
        ref = out["routes"][route]
        both = sorted(set(port["per_seed"]) & set(ref["per_seed"]), key=int)
        if not both:
            continue
        out[f"port_minus_{route}"] = gap(port["per_seed"], ref["per_seed"],
                                         both)
        out[f"port_minus_{route}_first_3"] = gap(
            port["per_seed"], ref["per_seed"], both[:3])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--routes", default=",".join(ROUTES))
    ap.add_argument("--out", default=os.path.join(
        REPO, "TORCH_QUALITY_VS_JAX.json"))
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    routes = [r for r in args.routes.split(",") if r]

    from gnina_tpu_torch import _fixtures as fx

    rec_path = os.path.join(tempfile.mkdtemp(), "rec.pdb")
    with open(rec_path, "w") as f:
        f.write(fx.receptor_pdb_text(fx.ligand_center(fx.ligand()), seed=0,
                                     cube=CUBE))
    out = {"job": dict(ligands=2, ligand="minout.sdf record 1",
                       receptor=f"_fixtures.receptor_pdb_text(seed=0, "
                                f"cube={CUBE})", box=BOX,
                       settings=_job(args.steps, args.chains)),
           "device": "cpu", "best": "mean over the 2 ligands of the top "
           "pose energy, kcal/mol",
           "routes": {r: {"per_seed": {}} for r in ROUTES}}
    if os.path.exists(args.out):       # keep runs of an earlier sweep
        with open(args.out) as f:
            old = json.load(f)
        if old.get("job") == out["job"]:
            for r in ROUTES:
                out["routes"][r]["per_seed"].update(
                    old["routes"][r]["per_seed"])
    tasks = [(r, s) for r in routes for s in seeds
             if str(s) not in out["routes"][r]["per_seed"]]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs,
                                                mp_context=ctx) as ex:
        futs = {ex.submit(dock_one, r, s, args.steps, args.chains,
                          rec_path): (r, s) for r, s in tasks}
        for fut in concurrent.futures.as_completed(futs):
            r, s = futs[fut]
            res = fut.result()
            out["routes"][r]["per_seed"][str(s)] = res
            summarise(out)
            with open(args.out, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
            print(f"{r} seed {s}: best {res['best']:.3f} kcal/mol in "
                  f"{res['wall_s']:.1f} s", flush=True)
    summarise(out)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True)
    for route in ("jax_off", "jax_fused"):
        for key in (f"port_minus_{route}", f"port_minus_{route}_first_3"):
            if key in out:
                print(key, json.dumps(out[key]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
