"""Read K9's and K10's machine code (SASS) in a build of csrc/probes.cu.

    python scripts/torch_probe_sass.py [LIBRARY.so | DUMP.sass]

With no argument it builds the package's probes.cu (ops/_cuda.py, sm_90a)
and disassembles it with the toolkit's cuobjdump; a .so is disassembled as
it is, a .sass file is read as cuobjdump's output.  For each instance of
k_probe_pairs (float32, bfloat16) it finds the inner loop, the innermost
backward branch whose body holds the most MUFU.EX2, and prints its instruction count,
its opcodes, the pairs one trip computes (one square root a pair:
MUFU.SQRT), MUFU.EX2 a pair, and every branch inside the body besides the
back edge.  For k_probe_gather it prints every global load and every
backward branch.  One JSON line each.  Needs the CUDA toolkit (the card's
machine).
"""

from __future__ import annotations

import collections
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                  r"([^;]*);")


def disassemble(path: str) -> str:
    if path.endswith(".sass"):
        with open(path) as f:
            return f.read()
    tool = "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        tool = "cuobjdump"
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def functions(sass: str) -> dict:
    """{mangled name: [(address, predicate, opcode, operands)]}."""
    out, cur = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = LINE.search(ln)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), (m.group(2) or "").strip(),
                        m.group(3), m.group(4).strip()))
    return out


def backward(c):
    """The target of a backward branch, else None."""
    m = re.search(r"0x([0-9a-f]+)", c[3])
    if c[2].startswith("BRA") and m and int(m.group(1), 16) < c[0]:
        return int(m.group(1), 16)
    return None


def inner_loop(code):
    """The body (list of instructions) of the innermost loop (a backward
    branch with no other backward branch in its body) with the most
    MUFU.EX2."""
    best = []
    for c in code:
        target = backward(c)
        if target is None:
            continue
        body = [x for x in code if target <= x[0] <= c[0]]
        if any(backward(x) is not None for x in body[:-1]):
            continue
        n = sum(x[2].startswith("MUFU.EX2") for x in body)
        if n > sum(x[2].startswith("MUFU.EX2") for x in best):
            best = body
    return best


def pairs_report(name, code):
    body = inner_loop(code)
    ops = collections.Counter(c[2] for c in body)
    pairs = sum(n for op, n in ops.items() if op.startswith("MUFU.SQRT"))
    ex2 = sum(n for op, n in ops.items() if op.startswith("MUFU.EX2"))
    inner_branches = [f"{c[1]} {c[2]} {c[3]}".strip() for c in body[:-1]
                      if c[2].startswith(("BRA", "BRX", "JMP"))]
    return {"kernel": name, "loop_instructions": len(body),
            "loop_from": hex(body[0][0]) if body else None,
            "loop_to": hex(body[-1][0]) if body else None,
            "pairs_per_trip": pairs, "ex2_per_pair": ex2 / max(pairs, 1),
            "instructions_per_pair": len(body) / max(pairs, 1),
            "branches_inside": inner_branches,
            "opcodes": dict(ops.most_common())}


def gather_report(name, code):
    loads = [f"{c[2]} {c[3]}" for c in code if c[2].startswith("LDG")]
    back = [hex(c[0]) for c in code if backward(c) is not None]
    return {"kernel": name, "instructions": len(code), "global_loads": loads,
            "backward_branches": back}


def main(argv) -> int:
    if argv:
        path = argv[0]
    else:
        from gnina_tpu_torch.ops import _cuda

        path = _cuda.build(name="probes")
    for name, code in functions(disassemble(path)).items():
        if "k_probe_pairs" in name:
            print(json.dumps(pairs_report(name, code)), flush=True)
        elif "k_probe_gather" in name:
            print(json.dumps(gather_report(name, code)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
