"""tognina equivalent: molecules -> pre-parsed .molcache archives.

reference: gninasrc/tognina.cpp (serialized smina-format trees for
parse-free screening input)."""

from __future__ import annotations

import argparse
import sys

from gnina_tpu_torch.chem import ingest, molcache


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tognina")
    p.add_argument("input", help="molecule file (sdf/pdbqt/pdb/xyz)")
    p.add_argument("output", nargs="?", help="output .molcache path")
    args = p.parse_args(argv)
    out = args.output or (args.input.rsplit(".", 1)[0] + ".molcache")
    ligs = list(ingest.iter_ligands(args.input))
    molcache.save_ligands(out, ligs)
    print(f"wrote {len(ligs)} ligand(s) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
