"""The port's file tools against the JAX package's on the CPU: the .molcache
archive (chem/molcache.py) across both packages in both directions,
gninatyper's .gninatypes bytes, tognina then fromgnina (SDF text equal to
JAX's), and each tool's main() on temporary files.  The inputs are
records of minout.sdf and the flex fixture's ligand with its side chains
(other_pairs, num_lig_atoms, num_movable_atoms)."""

import os

import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.chem import molcache as jmolcache
from gnina_tpu.tools import fromgnina as jfromgnina
from gnina_tpu.tools import gninatyper as jgninatyper
from gnina_tpu.tools import tognina as jtognina
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem import molcache as tmolcache
from gnina_tpu_torch.tools import fromgnina as tfromgnina
from gnina_tpu_torch.tools import gninatyper as tgninatyper
from gnina_tpu_torch.tools import tognina as ttognina

ARRAYS = ("local_coords", "orig_coords", "types", "charges", "node_id",
          "parent", "rel_axis", "rel_origin", "layer", "parent_anchor",
          "pairs", "other_pairs")
SCALARS = ("name", "num_tors", "num_heavy_atoms", "num_hydrophobic_atoms",
           "ligand_length", "torsdof", "num_lig_atoms", "num_movable_atoms")


AMINE_SDF = """methylamine
  prog
  comment
  4  3  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0
    1.4700    0.0000    0.0000 N   0  0
    1.8000    0.9400    0.0000 H   0  0
    1.8000   -0.4700    0.8200 H   0  0
  1  2  1  0
  2  3  1  0
  2  4  1  0
M  END
$$$$
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sdf4(tmp_path_factory):
    """Four records of minout.sdf, and methylamine with its two polar
    hydrogens (which the ligand reader keeps)."""
    d = tmp_path_factory.mktemp("tools_files")
    blocks = open(fx.LIGAND_SDF).read().split("$$$$\n")
    path = d / "four.sdf"
    path.write_text("$$$$\n".join(blocks[:4]) + "$$$$\n")
    amine = d / "amine.sdf"
    amine.write_text(AMINE_SDF)
    return dict(dir=d, four=str(path), amine=str(amine))


def _assert_same_ligands(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ARRAYS:
            x, y = getattr(a, f), getattr(b, f)
            if y is None:
                assert x is None, f
            else:
                assert np.array_equal(np.asarray(x), np.asarray(y)), f
                assert np.asarray(x).dtype == np.asarray(y).dtype, f
        for f in SCALARS:
            assert getattr(a, f) == getattr(b, f), f
        assert a.mol is None and b.mol is None


@pytest.fixture(scope="module")
def flex_ligand(tmp_path_factory):
    """The ligand with two flexible side chains attached (other_pairs,
    num_lig_atoms and num_movable_atoms set), in both packages from the
    same files: (JAX's, the port's)."""
    from gnina_tpu.chem import flexinfo as jflex
    from gnina_tpu.chem.tree_build import attach_flex as jattach
    from gnina_tpu_torch.chem import flexinfo as tflex
    from gnina_tpu_torch.chem.tree_build import attach_flex as tattach

    path = tmp_path_factory.mktemp("flex") / "rec.pdb"
    path.write_text(fx.flex_receptor_pdb_text(fx.ligand(), seed=0,
                                              cube=24.0))
    out = []
    for ing, flex, attach in ((jingest, jflex, jattach),
                              (tingest, tflex, tattach)):
        rec = ing.Receptor.from_file(str(path))
        keys = flex.select_flex_residues(rec, flexres="A:45,A:74")
        frs = [flex.extract_flex_residue(rec, k) for k in keys]
        out.append(attach(next(ing.iter_ligands(fx.LIGAND_SDF)), frs))
    return out


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_molcache_across_packages(sdf4, tmp_path, direction):
    jligs = list(jingest.iter_ligands(sdf4["four"]))
    tligs = list(tingest.iter_ligands(sdf4["four"]))
    path = str(tmp_path / "x.molcache")
    if direction == "port_to_jax":
        tmolcache.save_ligands(path, tligs)
        got = list(jmolcache.load_ligands(path))
        want = list(tmolcache.load_ligands(path))
    else:
        jmolcache.save_ligands(path, jligs)
        got = list(tmolcache.load_ligands(path))
        want = list(jmolcache.load_ligands(path))
    _assert_same_ligands(got, want)
    for a, lig in zip(got, tligs):
        assert np.array_equal(a.orig_coords, lig.orig_coords)
        assert np.array_equal(a.pairs, lig.pairs)
        assert a.num_tors == lig.num_tors


def test_molcache_bytes_equal_jax(sdf4, tmp_path):
    """The two packages write the same archive members, byte for byte."""
    import zipfile

    a, b = str(tmp_path / "t.molcache"), str(tmp_path / "j.molcache")
    tmolcache.save_ligands(a, list(tingest.iter_ligands(sdf4["four"])))
    jmolcache.save_ligands(b, list(jingest.iter_ligands(sdf4["four"])))
    with zipfile.ZipFile(a) as za, zipfile.ZipFile(b) as zb:
        assert za.namelist() == zb.namelist()
        for name in za.namelist():
            assert za.read(name) == zb.read(name), name


def test_molcache_flex_fields_across_packages(flex_ligand, tmp_path):
    jlig, tlig = flex_ligand
    assert tlig.other_pairs is not None and tlig.num_lig_atoms > 0
    a, b = str(tmp_path / "t.molcache"), str(tmp_path / "j.molcache")
    tmolcache.save_ligands(a, [tlig])
    jmolcache.save_ligands(b, [jlig])
    _assert_same_ligands(list(jmolcache.load_ligands(a)),
                         list(tmolcache.load_ligands(b)))


@pytest.mark.parametrize("keep_h", [False, True], ids=["heavy", "all"])
def test_gninatypes_bytes_equal_jax(sdf4, tmp_path, keep_h):
    sizes = []
    for src in (sdf4["four"], sdf4["amine"]):
        for i, (tl, jl) in enumerate(zip(tingest.iter_ligands(src),
                                         jingest.iter_ligands(src))):
            a, b = tmp_path / f"t{i}.gninatypes", tmp_path / f"j{i}.gninatypes"
            tgninatyper.write_gninatypes(tl, str(a), skip_hydrogens=not keep_h)
            jgninatyper.write_gninatypes(jl, str(b), skip_hydrogens=not keep_h)
            assert a.read_bytes() == b.read_bytes()
            coords, types = tgninatyper.read_gninatypes(str(a))
            jc, jt = jgninatyper.read_gninatypes(str(a))
            assert np.array_equal(coords, jc) and np.array_equal(types, jt)
            assert len(a.read_bytes()) == 16 * len(types)
            sizes.append(len(types))
    # the amine's two polar hydrogens are written only when kept
    assert sizes[-1] == (4 if keep_h else 2)


def test_tognina_fromgnina_sdf_equal_jax(sdf4, tmp_path):
    """tognina then fromgnina in each package; the SDF text is equal, and
    each package's fromgnina reads the other's archive to the same text."""
    texts = {}
    for name, to, frm in (("t", ttognina, tfromgnina),
                          ("j", jtognina, jfromgnina)):
        mc = str(tmp_path / f"{name}.molcache")
        assert to.main([sdf4["four"], mc]) == 0
        out = str(tmp_path / f"{name}.sdf")
        assert frm.main([mc, out]) == 0
        texts[name] = open(out).read()
    assert texts["t"] == texts["j"]
    assert texts["t"].count("$$$$") == 4
    cross = str(tmp_path / "cross.sdf")
    assert tfromgnina.main([str(tmp_path / "j.molcache"), cross]) == 0
    assert open(cross).read() == texts["j"]
    # the round trip keeps the atoms: their count, coordinates and the
    # element of each smina type, in the ligand's atom order
    from gnina_tpu_torch.chem.sdf import iter_sdf
    from gnina_tpu_torch.constants import SminaType, \
        smina_type_to_element_name

    orig = list(tingest.iter_ligands(sdf4["four"]))
    mols = list(iter_sdf(cross))
    assert len(mols) == len(orig) == 4
    for mol, lig in zip(mols, orig):
        assert mol.num_atoms() == lig.num_atoms
        assert np.abs(mol.coords() - lig.orig_coords).max() <= 1e-4
        assert [a.element_name for a in mol.atoms] == [
            smina_type_to_element_name(SminaType(int(t))) for t in lig.types]


def test_mains_default_names(sdf4, tmp_path, capsys):
    """The CLIs with their default output names: gninatyper suffixes every
    file _N (also the first), tognina and fromgnina swap the extension."""
    src = tmp_path / "in.sdf"
    src.write_text(open(sdf4["four"]).read())
    assert tgninatyper.main([str(src)]) == 0
    assert "wrote 4 gninatypes file(s)" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.glob("*.gninatypes")) == [
        f"in_{i}.gninatypes" for i in range(4)]
    for mod, base in ((tgninatyper, "t"), (jgninatyper, "j")):
        assert mod.main([str(src), str(tmp_path / base),
                         "--keep_hydrogens"]) == 0
    capsys.readouterr()
    for i in range(4):
        kept = (tmp_path / f"t_{i}.gninatypes").read_bytes()
        assert kept == (tmp_path / f"j_{i}.gninatypes").read_bytes()
        # minout.sdf's dummy atom '*' reads as a hydrogen
        assert len(kept) == len(
            (tmp_path / f"in_{i}.gninatypes").read_bytes()) + 16
    assert ttognina.main([str(src)]) == 0
    assert "wrote 4 ligand(s)" in capsys.readouterr().out
    assert (tmp_path / "in.molcache").exists()
    os.remove(src)
    assert tfromgnina.main([str(tmp_path / "in.molcache")]) == 0
    assert "wrote 4 molecule(s)" in capsys.readouterr().out
    assert (tmp_path / "in.sdf").read_text().count("$$$$") == 4
