"""gninatyper equivalent: molecule -> .gninatypes binary records.

reference: gninasrc/gninatyper/gninatyper.cpp:29-36 — each atom is a packed
record of (float x, float y, float z, int32 smina_type); one output file per
model in the input (suffixed _N), matching the original tool's behavior.
"""

from __future__ import annotations

import argparse
import struct
import sys
from typing import List

import numpy as np

from gnina_tpu_torch.chem import ingest
from gnina_tpu_torch.constants import IS_HYDROGEN


def write_gninatypes(lig, path: str, skip_hydrogens: bool = True):
    with open(path, "wb") as f:
        for i in range(lig.num_atoms):
            t = int(lig.types[i])
            if skip_hydrogens and IS_HYDROGEN[t]:
                continue
            x, y, z = (float(v) for v in lig.orig_coords[i])
            f.write(struct.pack("<fffi", x, y, z, t))


def read_gninatypes(path: str):
    """Returns (coords (N,3), types (N,))."""
    coords: List[List[float]] = []
    types: List[int] = []
    with open(path, "rb") as f:
        while True:
            rec = f.read(16)
            if len(rec) < 16:
                break
            x, y, z, t = struct.unpack("<fffi", rec)
            coords.append([x, y, z])
            types.append(t)
    return np.array(coords, np.float32).reshape(-1, 3), np.array(types, np.int32)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gninatyper")
    p.add_argument("input", help="molecule file")
    p.add_argument("output", nargs="?", help="output base name")
    p.add_argument("--keep_hydrogens", action="store_true")
    args = p.parse_args(argv)

    base = args.output or args.input.rsplit(".", 1)[0]
    count = 0
    for i, lig in enumerate(ingest.iter_ligands(args.input)):
        out = f"{base}_{i}.gninatypes" if i > 0 or True else base
        write_gninatypes(lig, out, skip_hydrogens=not args.keep_hydrogens)
        count += 1
    print(f"wrote {count} gninatypes file(s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
