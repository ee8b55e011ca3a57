#!/usr/bin/env python3
"""The port's fused route against its general path, on the card.

    python scripts/torch_route_gap.py [--steps 256] [--seeds 0,1,2]
        [--out chiprun_out/route_gap.json]

Docks chip_smoke.py phase [8]'s job (16 copies of the minout.sdf ligand x
exhaustiveness 8 in a 20 A box of the seed-0 synthetic receptor,
cnn_scoring="none") through DockingEngine.dock_batch on both routes, the
default fused route (the kernels K1-K3) and the general path
(fused_search="off", ordinary PyTorch), at each of --steps MC steps (a
comma list: 256,512) and each seed.  A seed's best is the mean over the 16
ligands of each ligand's top pose energy (kcal/mol).  For each step count
it prints, and writes to --out as JSON, per route the per-seed bests,
their mean, spread (max - min) and walls, and the gap fused - general with
scripts/quality_gate.py's bar, max(seed spread, 0.25), and the number of
seeds whose gap has the mean gap's sign.  The first line is the card's
nvidia-smi name and power limit.  Each route is docked once first, unkept
(the kernels' build and the first-use costs).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
LIGANDS, EXHAUSTIVENESS = 16, 8
BAR = 0.25      # kcal/mol, scripts/quality_gate.py's floor of the gap bar


def smi_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", default="256")
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "route_gap.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_route_gap: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch.docking import DockingEngine, DockSettings

    smi = smi_line()
    print(smi, flush=True)
    seeds = [int(s) for s in args.seeds.split(",")]
    rec, lig, center, size = fx.system(seed=0, box=20.0)
    ligs = [lig] * LIGANDS
    report = {"card": smi, "job": f"{LIGANDS} x {EXHAUSTIVENESS}, 20 A box, "
              "seed-0 synthetic receptor", "runs": {}}
    for steps in [int(s) for s in args.steps.split(",")]:
        base = dict(cnn_scoring="none", num_mc_steps=steps,
                    exhaustiveness=EXHAUSTIVENESS)
        routes = {"fused": DockingEngine(DockSettings(**base)),
                  "general": DockingEngine(DockSettings(fused_search="off",
                                                        **base))}
        row = {}
        for name, eng in routes.items():
            eng.dock_batch(rec, ligs[:1], center, size, seed=99)   # warm
            bests, walls = [], []
            for seed in seeds:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = eng.dock_batch(rec, ligs, center, size, seed=seed)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                bests.append(float(np.mean([r[0].energy for r in res])))
                print(f"{steps} steps, {name}, seed {seed}: mean best "
                      f"{bests[-1]:.4f} kcal/mol in {walls[-1]:.2f} s",
                      flush=True)
            row[name] = dict(bests=bests, mean=float(np.mean(bests)),
                             spread=float(np.ptp(bests)), walls=walls)
        gaps = np.array(row["fused"]["bests"]) - np.array(
            row["general"]["bests"])
        gap = float(gaps.mean())
        bar = max(row["fused"]["spread"], row["general"]["spread"], BAR)
        row["gap"] = dict(mean=gap, per_seed=gaps.tolist(), bar=bar,
                          same_sign=int((np.sign(gaps) == np.sign(gap)).sum()),
                          within_bar=bool(abs(gap) <= bar))
        report["runs"][str(steps)] = row
        print(f"{steps} steps: fused {row['fused']['mean']:.4f} (spread "
              f"{row['fused']['spread']:.4f}), general "
              f"{row['general']['mean']:.4f} (spread "
              f"{row['general']['spread']:.4f}); gap fused - general "
              f"{gap:+.4f} kcal/mol, per seed "
              f"{[round(g, 4) for g in gaps.tolist()]}, bar {bar:.4f}, "
              f"{row['gap']['same_sign']} of {len(seeds)} seeds of its "
              f"sign", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v["gap"] for k, v in report["runs"].items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
