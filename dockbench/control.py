#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's size: for
each seed, one run of the cell (set-up, a window, the judgement), then the
same poses judged with the reference in the program's place one precision
lower (coordinates and the Vina affinity in bfloat16, the CNN with TF32 on).
Prints, per seed, the program's readings and the control's, each beside its
limit, and one JSON line of them all.  The control has to come out as not
correct on every seed.  The benchmark's own runs do not run this.

    python3 dockbench/control.py --workload <cell> --seeds 1,2,3 --seconds 45
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from dockbench import run as bench_run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=45.0)
    args = ap.parse_args(argv)
    out = []
    for seed in [int(x) for x in args.seeds.split(",")]:
        r = bench_run.run(args.workload, seed, args.seconds, False,
                          control=True)
        ok, rows = r["control"]
        for (name, v, lim), (_, cv, _) in zip(r["rows"], rows):
            print(f"seed {seed} {name}: program {v!r} control {cv!r} "
                  f"(limit {lim!r})", flush=True)
        print(f"seed {seed}: program correct {r['result']['correct']}, "
              f"control correct {ok}", flush=True)
        out.append(dict(seed=seed, program=r["rows"], control=rows,
                        control_correct=ok,
                        program_correct=r["result"]["correct"],
                        metrics=r["result"]["metrics"]))
    print(json.dumps(out), flush=True)
    return 0 if not any(o["control_correct"] for o in out) else 1


if __name__ == "__main__":
    sys.exit(main())
