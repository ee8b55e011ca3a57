"""fromgnina equivalent: .molcache archives -> SDF.

reference: gninasrc/fromgnina.cpp."""

from __future__ import annotations

import argparse
import sys

from gnina_tpu_torch.chem import molcache
from gnina_tpu_torch.chem.sdf import write_sdf_block
from gnina_tpu_torch.chem.mol import Atom, Molecule
from gnina_tpu_torch.constants import smina_type_to_element_name, SminaType
from gnina_tpu_torch.chem import elements as el


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="fromgnina")
    p.add_argument("input", help=".molcache file")
    p.add_argument("output", nargs="?", help="output SDF path")
    args = p.parse_args(argv)
    out = args.output or (args.input.rsplit(".", 1)[0] + ".sdf")
    chunks = []
    n = 0
    for lig in molcache.load_ligands(args.input):
        # reconstruct a minimal molecule from types+coords (bonds perceived)
        mol = Molecule(name=lig.name)
        for i in range(lig.num_atoms):
            sym = smina_type_to_element_name(SminaType(int(lig.types[i])))
            mol.atoms.append(Atom(anum=el.symbol_to_anum(sym),
                                  coords=lig.orig_coords[i],
                                  element_name=sym))
        mol.perceive_bonds()
        chunks.append(write_sdf_block(mol, coords=lig.orig_coords,
                                      name=lig.name))
        n += 1
    with open(out, "w") as f:
        f.write("".join(chunks))
    print(f"wrote {n} molecule(s) to {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
