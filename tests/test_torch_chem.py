"""The port's copies of the host chemistry give the JAX package's arrays:
torsion trees from minout.sdf, receptor typing from a synthetic PDB,
pruning and autoboxing."""

import os

import numpy as np
import pytest

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.chem import sdf as jsdf
from gnina_tpu.chem.tree_build import build_tree_from_molecule as jbuild
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem import sdf as tsdf
from gnina_tpu_torch.chem.tree_build import build_tree_from_molecule as tbuild

_LIG_ARRAYS = ("local_coords", "orig_coords", "types", "charges", "node_id",
               "parent", "rel_axis", "rel_origin", "layer", "parent_anchor",
               "pairs")
_LIG_SCALARS = ("num_tors", "num_heavy_atoms", "num_hydrophobic_atoms",
                "ligand_length", "torsdof", "num_lig_atoms",
                "num_movable_atoms", "has_rigid_dof")


def _assert_same_ligand(a, b):
    for f in _LIG_ARRAYS:
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)), err_msg=f)
    for f in _LIG_SCALARS:
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("strip_h", [True, False])
def test_tree_from_minout(strip_h):
    jm = list(jsdf.iter_sdf(fx.LIGAND_SDF))[0]
    tm = list(tsdf.iter_sdf(fx.LIGAND_SDF))[0]
    _assert_same_ligand(jbuild(jm, strip_h=strip_h),
                        tbuild(tm, strip_h=strip_h))


def test_iter_ligands_minout():
    a = list(jingest.iter_ligands(fx.LIGAND_SDF))
    b = list(tingest.iter_ligands(fx.LIGAND_SDF))
    assert len(a) == len(b) >= 1
    for x, y in zip(a, b):
        _assert_same_ligand(x, y)
    # the fixture ligand: 19 atoms, 3 torsions, 4 tree nodes
    assert (b[0].num_atoms, b[0].num_torsions, b[0].num_nodes) == (19, 3, 4)


def test_autobox_ligand():
    ca, sa = jingest.autobox_ligand(fx.LIGAND_SDF)
    cb, sb = tingest.autobox_ligand(fx.LIGAND_SDF)
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cb))
    np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))


@pytest.mark.parametrize("seed", [0, 3])
def test_receptor_from_pdb_and_pruned(tmp_path, seed):
    center = fx.ligand_center(fx.ligand())
    path = os.path.join(tmp_path, "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(center, seed, cube=22.0))
    ja = jingest.Receptor.from_file(path)
    tb = tingest.Receptor.from_file(path)
    assert 300 <= len(tb.types) <= 1000
    for f in ("coords", "types", "charges"):
        np.testing.assert_array_equal(getattr(ja, f), getattr(tb, f))
    # a lattice at ~2.7 A perceives no bonds: every atom is its own molecule
    assert not tb.mol.bonds
    for half in (4.0, 6.0):
        pa = ja.pruned(np.asarray(center), np.full(3, half), margin=8.0)
        pb = tb.pruned(np.asarray(center), np.full(3, half), margin=8.0)
        for f in ("coords", "types", "charges"):
            np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
        assert 0 < len(pb.types) < len(tb.types)


def test_fixture_receptor_goes_through_from_file():
    rec, lig, center, size = fx.system(seed=1, box=12.0, cube=22.0)
    assert len(rec.types) == len(rec.coords) > 300
    assert lig.num_atoms == 19
    np.testing.assert_allclose(size, 12.0)
    # C/N/O/S only, hydrogens none
    elements = {a.anum for a in rec.mol.atoms}
    assert elements <= {6, 7, 8, 16}
