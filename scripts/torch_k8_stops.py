"""Count the K8 group stops that move against the plain version, on one card.

    python scripts/torch_k8_stops.py [--seeds 0-7] [--out PATH]

For each seed, the system and starts of chip_smoke.py's phases [3]-[3c]
(a synthetic receptor from the seed, 16 copies of the minout.sdf ligand x
8 chains; the refine shape L=128 from jittered poses, half of them swapped
for minima, and the finish shape L=800 from minima), and for each shape,
line-search mode (lockstep, async_ls), iteration count (1, 3) and
done_frac (0.5, 0.9): k_bfgs's K8 instance against
fused_dock.bfgs_minimize_plain.  A group's stop moved where the two
versions' group iteration counts (stats column 5) differ; a group holds a
flipped lane where, at the same iteration count, the UNCOUPLED kernel and
the uncoupled plain version give some lane other trial, iteration or
accept counts (stats columns 2-4): an Armijo, descent or convergence
test decided the other way.  Each uncoupled plain run is made twice, to
show that the plain version gives the same bits in every run.  Prints one
line per case and a total, and writes them as JSON to --out (default
chiprun_out/k8_stops.json).  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem.ingest import box_from_center_size  # noqa: E402
from gnina_tpu_torch.docking import DockSettings  # noqa: E402
from gnina_tpu_torch.ops import fused_dock as fd  # noqa: E402
from gnina_tpu_torch.scoring.builtin import get_scoring_function  # noqa: E402


def groups_of(mask):
    return set((torch.nonzero(mask)[:, 0] // fd.GROUP).tolist())


def shapes(seed, dev):
    """[(label, pack, scal, metro, (rigid, tors))] as chip_smoke.py's [3c]
    builds them for `seed`."""
    rec, lig, center, size = fx.system(seed=seed, box=20.0)
    sf = get_scoring_function("vina")
    terms = fd.extract_vina_terms(sf)
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    lo, hi = box_from_center_size(center, size)
    pack = fd.build_pack([lig] * 16, pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), 8, sf.table,
                         m_pad=4, device=dev)
    num_out = max(DockSettings().num_modes, DockSettings().num_mc_saved)
    pack_out = pack.with_lanes(torch.arange(
        16, device=dev, dtype=torch.int32).repeat_interleave(num_out))
    miniters = max(int((25 + lig.num_atoms) / 3), 1)
    scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                            device=dev)
    scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi, device=dev)
    scal_s = fd.scal_vector(1000.0, 1000.0, 1e5, 1000.0, lo, hi, device=dev)
    rng = np.random.default_rng(seed)
    jit = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev, "perturbed")
    r, t = fx.packed_poses(rng, pack_out.lanes, lo, hi, lig, 4, dev,
                           "random")
    r, t = fd.bfgs_minimize(terms, r, t, scal_h, pack_out, miniters)[:2]
    mins = fd.bfgs_minimize(terms, r, t, scal_r, pack_out, miniters)[:2]
    half = pack.lanes // 2
    mixed = (torch.cat([mins[0][:half], jit[0][half:]]).contiguous(),
             torch.cat([mins[1][:half], jit[1][half:]]).contiguous())
    return terms, [("refine", pack, scal_r, True, mixed),
                   ("finish", pack_out, scal_s, False, mins)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "k8_stops.json"))
    args = ap.parse_args(argv)
    lo_s, _, hi_s = args.seeds.partition("-")
    seeds = range(int(lo_s), int(hi_s or lo_s) + 1)
    dev = torch.device("cuda")
    rows = []
    for seed in seeds:
        terms, cases = shapes(seed, dev)
        for label, pk, sc, wm, (r, t) in cases:
            for async_ls in (False, True):
                for iters in (1, 3):
                    def run(frac, plain):
                        fn = fd.bfgs_minimize_plain if plain \
                            else fd.bfgs_minimize
                        out = fn(terms, r, t, sc, pk, iters, wm,
                                 async_ls=async_ls, done_frac=frac)[2]
                        torch.cuda.synchronize()
                        return out

                    fk, fp = run(1.0, False), run(1.0, True)
                    same_plain = bool(torch.equal(fp, run(1.0, True)))
                    flip_lanes = (fk[:, 2:5] != fp[:, 2:5]).any(1)
                    flipped = groups_of(flip_lanes)
                    for frac in (0.5, 0.9):
                        gk, gp = run(frac, False), run(frac, True)
                        moved = groups_of(gk[:, 5] != gp[:, 5])
                        row = dict(
                            seed=seed, shape=label, lanes=pk.lanes,
                            groups=-(-pk.lanes // fd.GROUP),
                            mode="async_ls" if async_ls else "lockstep",
                            iters=iters, done_frac=frac,
                            flipped_lanes=int(flip_lanes.sum()),
                            plain_repeats=same_plain,
                            flipped_groups=sorted(flipped),
                            moved_groups=sorted(moved),
                            moved_with_flip=len(moved & flipped),
                            moved_without_flip=len(moved - flipped))
                        rows.append(row)
                        print(json.dumps(row), flush=True)
    total = {k: sum(r[k] for r in rows)
             for k in ("moved_with_flip", "moved_without_flip")}
    total["cases"] = len(rows)
    total["plain_repeats"] = all(r["plain_repeats"] for r in rows)
    total["cases_moving_more_than_one"] = sum(
        len(r["moved_groups"]) > 1 for r in rows)
    total["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print("total", json.dumps(total), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"total": total, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit(__doc__)
    sys.exit(main())
