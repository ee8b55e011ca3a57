"""Host bond perception in C++ (gnina_tpu_torch/native) against the JAX
package's native library, on the CPU.

On two receptors (the 3,304-atom synthetic receptor that chip_smoke.py's
phases [8] and [11] read, and the one with eight real residues,
_fixtures.flex_receptor_pdb_text):

- the port's native bond list equals the JAX package's native list, pair
  for pair and in order (the synthetic receptor, heavy atoms on a 2.7 A
  lattice, has none: it measures the parse's time);
- the pure-Python loop, which runs only without g++, finds the same bonds
  as a set (its cells are sized by the largest covalent radius of any
  element, the native code's by the largest present, so the order
  differs);
- the receptor's atom types, and every flexible residue's tree, are the
  same whichever list is used.
"""

import numpy as np
import pytest
import torch

from gnina_tpu.chem import pdb as jpdb
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import native
from gnina_tpu_torch.chem import flexinfo
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem import pdb as tpdb

FLEX_KEYS = [("A", r, "") for r in (37, 45, 68, 74)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def receptors(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    lig = fx.ligand()
    out = {}
    for name, text in (
            ("synthetic", fx.receptor_pdb_text(fx.ligand_center(lig), 0)),
            ("residues", fx.flex_receptor_pdb_text(lig, 0, cube=24.0))):
        path = d / f"{name}.pdb"
        path.write_text(text)
        out[name] = str(path)
    return out


def _pairs(mol):
    return [(b.a, b.b) for b in mol.bonds]


@pytest.fixture
def python_loop(monkeypatch):
    """Perceive with the pure-Python loop, as on a machine without g++."""
    monkeypatch.setattr(native, "perceive_bonds_native", lambda *a: None)


def test_native_library_loads():
    assert native.loaded()
    assert native.library_path().startswith(native.BUILD_DIR)


@pytest.mark.parametrize("name", ["synthetic", "residues"])
def test_native_bonds_equal_jax_in_order(receptors, name):
    with open(receptors[name]) as f:
        text = f.read()
    got = tpdb.parse_pdb(text)
    want = jpdb.parse_pdb(text)
    if name == "synthetic":
        # heavy atoms on a 2.7 A lattice: no two within bonding distance
        assert len(got.atoms) == 3304 and not got.bonds
    else:
        assert len(got.bonds) > 50   # the eight residues' bonds
    assert _pairs(got) == _pairs(want)


@pytest.mark.parametrize("name", ["synthetic", "residues"])
def test_python_loop_finds_the_same_bonds(receptors, name, python_loop,
                                          capsys):
    with open(receptors[name]) as f:
        text = f.read()
    want = _pairs(jpdb.parse_pdb(text))
    got = tpdb.parse_pdb(text)
    assert set(_pairs(got)) == set(want) and len(_pairs(got)) == len(want)
    # one line on stderr a process, at most
    assert capsys.readouterr().err.count("native bond perception") <= 1


def _flex_trees(path):
    rec = tingest.Receptor.from_file(path)
    out = []
    for key in FLEX_KEYS:
        r = flexinfo.extract_flex_residue(rec, key)
        assert r is not None, key
        out.append(r)
    return rec, out


def test_typing_and_flex_trees_either_way(receptors, monkeypatch):
    for name in ("synthetic", "residues"):
        a = tingest.Receptor.from_file(receptors[name])
        with monkeypatch.context() as m:
            m.setattr(native, "perceive_bonds_native", lambda *x: None)
            b = tingest.Receptor.from_file(receptors[name])
        assert np.array_equal(a.types, b.types)
        assert np.array_equal(a.coords, b.coords)
    rec_n, trees_n = _flex_trees(receptors["residues"])
    with monkeypatch.context() as m:
        m.setattr(native, "perceive_bonds_native", lambda *x: None)
        rec_p, trees_p = _flex_trees(receptors["residues"])
    assert np.array_equal(rec_n.types, rec_p.types)
    for tn, tp in zip(trees_n, trees_p):
        for field in ("coords", "types", "node_of_atom", "parent",
                      "rel_axis", "rel_origin", "layer",
                      "parent_anchor_local", "inflex_coords", "pairs"):
            assert np.array_equal(getattr(tn, field), getattr(tp, field)), \
                (tn.key, field)
