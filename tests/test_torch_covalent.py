"""Covalent docking and SMARTS in the port against the JAX package.

Inputs: the inline CYS/GLY receptor and acrylamide of tests/test_covalent.py
and the acrylamide and benzene of tests/test_smarts.py, read by each
package's own readers.  Host results (atom indices, coordinates, pair
lists, match lists) must be equal; the tiny covalent dock pins the
attachment atom within 1e-3 A.
"""

import dataclasses

import numpy as np
import pytest
import torch

from gnina_tpu.chem import covalent as jcov
from gnina_tpu.chem import ingest as jingest
from gnina_tpu.chem import sdf as jsdf
from gnina_tpu.chem.smarts import SmartsPattern as JSmarts
from gnina_tpu_torch.chem import covalent as tcov
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem import sdf as tsdf
from gnina_tpu_torch.chem.smarts import SmartsError as TSmartsError
from gnina_tpu_torch.chem.smarts import SmartsPattern as TSmarts
from gnina_tpu_torch.docking import DockingEngine, DockSettings
from test_covalent import LIG_SDF, REC_PDB
from test_smarts import ACRYLAMIDE, BENZENE


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def recs(tmp_path_factory):
    p = tmp_path_factory.mktemp("cov") / "rec.pdb"
    p.write_text(REC_PDB)
    return (jingest.Receptor.from_file(str(p)),
            tingest.Receptor.from_file(str(p)))


def mols(text):
    return (list(jsdf.iter_sdf(text, is_text=True))[0],
            list(tsdf.iter_sdf(text, is_text=True))[0])


def cinfos(**kw):
    kw = dict(dict(covalent_rec_atom="A:7:SG",
                   covalent_lig_atom_pattern="[$(C=C)]"), **kw)
    return (jcov.CovInfo(jcov.CovOptions(**kw), log=lambda *a: None),
            tcov.CovInfo(tcov.CovOptions(**kw), log=lambda *a: None))


@pytest.mark.parametrize("spec", ["A:7:SG", "3.8,1.4,0.0", "A:7:CYS:SG",
                                  "A:8:CA", "A:9:SG"])
def test_find_rec_atom(recs, spec):
    """Atom addressing by chain:resnum:name, by coordinates and with the
    residue name: the same index (None where no atom matches)."""
    j, t = cinfos(covalent_rec_atom=spec)
    assert j.find_rec_atom(recs[0].mol) == t.find_rec_atom(recs[1].mol)
    if spec != "A:9:SG":
        assert t.find_rec_atom(recs[1].mol) is not None


def test_extract_covres(recs):
    jc, tc = cinfos()
    jr, jres, ja = jcov.extract_covres(recs[0], jc)
    tr, tres, ta = tcov.extract_covres(recs[1], tc)
    assert ja == ta and tres.atoms[ta].name.strip() == "SG"
    np.testing.assert_array_equal(jr.coords, tr.coords)
    np.testing.assert_array_equal(jr.types, tr.types)
    assert [(b.a, b.b, b.order) for b in jres.bonds] == \
        [(b.a, b.b, b.order) for b in tres.bonds]
    assert len(tres.atoms) == 6


def _same_struct(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        elif isinstance(x, (int, float, bool, str)):
            assert x == y, f.name


@pytest.mark.parametrize("position", ["", "5.0,2.0,0.5"])
def test_build_covalent_complex(recs, position):
    """The placed ligand, its torsion-only tree and its pairs: every array
    of the LigandStruct equal, with and without a user position."""
    jc, tc = cinfos(covalent_lig_atom_position=position)
    jm, tm = mols(LIG_SDF)
    jr, jl = jcov.build_covalent_complex(recs[0], jm, jc)
    tr, tl = tcov.build_covalent_complex(recs[1], tm, tc)
    np.testing.assert_array_equal(jr.coords, tr.coords)
    assert len(jl) == len(tl) >= 1
    for a, b in zip(jl, tl):
        _same_struct(a, b)
        np.testing.assert_array_equal(a.other_pairs, b.other_pairs)
        assert not b.has_rigid_dof and b.num_lig_atoms < b.num_atoms
    if position:
        np.testing.assert_allclose(tl[0].orig_coords[0], [5.0, 2.0, 0.5],
                                   atol=1e-4)


def test_covalent_pairs(recs):
    """_covalent_pairs on the merged ligand + covres graph: equal lists."""
    jc, tc = cinfos()
    jm, tm = mols(LIG_SDF)
    outs = []
    for mod, rec, ci, m in ((jcov, recs[0], jc, jm), (tcov, recs[1], tc, tm)):
        _, covres, ratom = mod.extract_covres(rec, ci)
        lig = mod.covalent_complexes_for_mol(covres, ratom, m, ci,
                                             rec_coords=rec.coords)[0]
        merged = mod.Molecule(name="m")
        merged.atoms = list(lig.mol.atoms) + list(covres.atoms)
        nl = lig.num_lig_atoms
        for b in lig.mol.bonds:
            merged.bonds.append(mod.Bond(b.a, b.b, b.order))
        for b in covres.bonds:
            merged.bonds.append(mod.Bond(b.a + nl, b.b + nl, b.order))
        merged.bonds.append(mod.Bond(0, ratom + nl, 1))
        merged.invalidate()
        remap = {i: i for i in range(len(merged.atoms))}
        outs.append(mod._covalent_pairs(merged, remap, nl, lig.types,
                                        lig.node_id, lig.parent_anchor))
    np.testing.assert_array_equal(outs[0], outs[1])
    assert len(outs[1]) > 0


ACRYLAMIDE_PATTERNS = [
    "C=C", "C(=O)N", "[$(C=O)]", "[CX3]=[OX1]", "[NX3H2]", "O=C",
    "C=CC(=O)N", "[CH2]=[CH1]", "S", "[R]", "[#6]", "[!#6]", "[#6,#7]",
    "[C;!$(C=O)]", "[OX1]", "N~C", "*", "[D1]"]
BENZENE_PATTERNS = ["c", "C", "a", "[cR]", "[r6]", "c1ccccc1", "cc",
                    "[c;!R]"]


@pytest.mark.parametrize("block,patterns", [
    (ACRYLAMIDE, ACRYLAMIDE_PATTERNS), (BENZENE, BENZENE_PATTERNS)],
    ids=["acrylamide", "benzene"])
def test_smarts_matches(block, patterns):
    """Every pattern of tests/test_smarts.py: the same matches (all
    mappings, and the unique ones) in both packages; the bad patterns
    raise in both."""
    jm, tm = mols(block)
    jm.perceive_all()
    tm.perceive_all()
    for pat in patterns:
        assert JSmarts(pat).match(jm) == TSmarts(pat).match(tm), pat
        assert JSmarts(pat).match_unique(jm) == \
            TSmarts(pat).match_unique(tm), pat
    for bad in ["", "C(", "[Qq]", "C1CC", "[", "$C"]:
        with pytest.raises((TSmartsError, ValueError)):
            TSmarts(bad)


def test_covalent_dock_pins_the_attachment_atom(recs):
    """A tiny covalent dock_batch on the general path (2 chains x 16 steps,
    as tests/test_covalent.py's): every pose finite, the attachment atom
    at its placed coordinates within 1e-3 A, the covalent residue's atoms
    unmoved."""
    _, tc = cinfos()
    _, tm = mols(LIG_SDF)
    rec, ligs = tcov.build_covalent_complex(recs[1], tm, tc)
    lig = ligs[0]
    nl = lig.num_lig_atoms
    eng = DockingEngine(DockSettings(
        cnn_scoring="none", exhaustiveness=2, num_mc_steps=16,
        mc_chunk_steps=16, minimize_iters=3, num_modes=3, num_mc_saved=5,
        search_grid=False, seed=11), device="cpu")
    assert not eng._fused_route([lig])
    center = lig.orig_coords[:nl].mean(axis=0)
    res = eng.dock_batch(rec, [lig], center, np.full(3, 12.0, np.float32),
                         seed=11)[0]
    assert res
    for r in res:
        assert np.isfinite(r.energy) and np.isfinite(r.coords).all()
        np.testing.assert_allclose(r.coords[0], lig.orig_coords[0],
                                   atol=1e-3)
        np.testing.assert_array_equal(r.coords[nl:], lig.orig_coords[nl:])
    assert any(np.abs(r.coords[1:nl] - lig.orig_coords[1:nl]).max() > 0.1
               for r in res)
