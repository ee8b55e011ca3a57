"""The port's gninavis (gnina_tpu_torch/tools/gninavis.py) against the JAX
package's on the CPU.

The fragment lists (bond subgraphs of 1..N heavy-atom bonds with their
hydrogens, and the rigid tree nodes) must equal JAX's element for element
on minout.sdf records.  The masking attributions run over the toy CNN
(_fixtures.toy_cnn, 13^3 grid) loaded into both packages' scorers, with
the system near the origin (JAX's voxelizer is good to 1e-4 there): the
per-atom scores within 1e-4.  The B-factor PDB and main() are checked too.
"""

import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.models import scorer as jscorer
from gnina_tpu.tools import gninavis as jvis
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.models import scorer as tscorer
from gnina_tpu_torch.tools import gninavis as tvis
from test_torch_cnn_objective import toy_scorers
from test_torch_gninagrid import write_origin_system

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("gninavis")
    lig, rec = write_origin_system(d, n_ligs=2, cavity=5.0)
    return dict(dir=d, lig=lig, rec=rec,
                jligs=list(jingest.iter_ligands(lig)),
                tligs=list(tingest.iter_ligands(lig)),
                jrec=jingest.Receptor.from_file(rec),
                trec=tingest.Receptor.from_file(rec))


@pytest.fixture(scope="module")
def scorers():
    return toy_scorers(0)


@pytest.fixture(scope="module")
def records():
    """Four minout.sdf records in each package."""
    from gnina_tpu_torch import _fixtures as fx

    j = list(jingest.iter_ligands(fx.LIGAND_SDF))[:4]
    t = list(tingest.iter_ligands(fx.LIGAND_SDF))[:4]
    return j, t


# ------------------------------------------------------------ fragments --

@pytest.mark.parametrize("max_bonds", [1, 3, 6])
def test_bond_subgraph_fragments_equal_jax(records, max_bonds):
    for jl, tl in zip(*records):
        got = tvis.bond_subgraph_fragments(tl, max_bonds)
        want = jvis.bond_subgraph_fragments(jl, max_bonds)
        assert got == want
        assert got and all(len(f) >= 2 for f in got)


def test_node_fragments_equal_jax(records):
    for jl, tl in zip(*records):
        got = tvis.node_fragments(tl)
        assert got == jvis.node_fragments(jl)
        assert sorted(i for f in got for i in f) == list(range(tl.num_atoms))


# -------------------------------------------------------- attributions ----

def _coords_variants(lig):
    """The input pose and one moved by 0.6 A along a fixed direction."""
    c = np.asarray(lig.orig_coords, np.float32)
    return {"input": None, "moved": c + np.float32([0.6, -0.3, 0.2])}


@pytest.mark.parametrize("which", ["input", "moved"])
def test_atom_masking_scores_match_jax(system, scorers, which):
    js, ts = scorers
    for jl, tl in zip(system["jligs"], system["tligs"]):
        coords = _coords_variants(tl)[which]
        got = tvis.atom_masking_scores(ts, system["trec"], tl, coords)
        want = jvis.atom_masking_scores(js, system["jrec"], jl, coords)
        assert got.shape == want.shape == (tl.num_atoms,)
        assert np.abs(got).max() > 1e-3
        assert np.abs(got - want).max() <= TOL


def test_fragment_masking_scores_match_jax(system, scorers):
    js, ts = scorers
    for jl, tl in zip(system["jligs"], system["tligs"]):
        frags = tvis.node_fragments(tl)
        got = tvis.fragment_masking_scores(ts, system["trec"], tl, frags)
        want = jvis.fragment_masking_scores(js, system["jrec"], jl, frags)
        assert np.abs(got - want).max() <= TOL
        # every atom of a fragment carries its fragment's score
        for f in frags:
            assert np.all(got[f] == got[f[0]])


@pytest.mark.parametrize("chunk", [128, 40])
def test_averaged_fragment_scores_match_jax(system, scorers, chunk):
    js, ts = scorers
    jl, tl = system["jligs"][0], system["tligs"][0]
    frags = tvis.bond_subgraph_fragments(tl, 6)
    assert len(frags) > chunk                   # more than one chunk
    got = tvis.averaged_fragment_scores(ts, system["trec"], tl, frags,
                                        chunk=chunk)
    want = jvis.averaged_fragment_scores(js, system["jrec"], jl, frags,
                                         chunk=chunk)
    assert np.abs(got).max() > 1e-3
    assert np.abs(got - want).max() <= TOL


def test_write_colored_pdb_equals_jax(system, tmp_path):
    jl, tl = system["jligs"][0], system["tligs"][0]
    scores = np.linspace(-2.5, 3.25, tl.num_atoms).astype(np.float32)
    a, b = tmp_path / "t.pdb", tmp_path / "j.pdb"
    tvis.write_colored_pdb(tl, scores, str(a))
    jvis.write_colored_pdb(jl, scores, str(b))
    assert a.read_text() == b.read_text()
    lines = a.read_text().splitlines()
    assert len(lines) == tl.num_atoms + 1 and lines[-1] == "END"
    # the B-factor column carries the scores; the coordinates are the
    # input's even when another pose was scored
    assert [float(x[60:66]) for x in lines[:-1]] == \
        [float(f"{s:.2f}") for s in scores]
    assert np.allclose([[float(x[30 + 8 * k:38 + 8 * k]) for k in range(3)]
                        for x in lines[:-1]], tl.orig_coords, atol=1e-3)


# ---------------------------------------------------------------- main ----

def test_main_writes_the_pdbs_jax_writes(system, scorers, tmp_path,
                                         monkeypatch):
    """main() over the toy model in both packages (CNNScorer replaced for
    the test): the same files, atom lines equal, B-factors within 0.01 (two
    decimals printed)."""
    js, ts = scorers

    class JToy(jscorer.CNNScorer):
        def __init__(self, model_names=None, **kw):
            self.__dict__.update(js.__dict__)

    seen = []

    class TToy(tscorer.CNNScorer):
        def __init__(self, model_names=None, device=None, **kw):
            seen.append(device)
            super().__init__(models=ts.models, device=device)

    monkeypatch.setattr(jscorer, "CNNScorer", JToy)
    monkeypatch.setattr(tscorer, "CNNScorer", TToy)
    base = ["-r", system["rec"], "-l", system["lig"], "--frag_bonds", "2"]
    assert tvis.main(base + ["-o", str(tmp_path / "t"), "--device",
                             "cpu"]) == 0
    assert jvis.main(base + ["-o", str(tmp_path / "j")]) == 0
    assert [str(d) for d in seen] == ["cpu"]
    for i in range(2):
        for kind in ("atoms", "frags"):
            a = (tmp_path / f"t_{i}_{kind}.pdb").read_text().splitlines()
            b = (tmp_path / f"j_{i}_{kind}.pdb").read_text().splitlines()
            assert len(a) == len(b) == system["tligs"][i].num_atoms + 1
            for x, y in zip(a, b):
                assert x[:60] == y[:60] and x[66:] == y[66:]
                if x != "END":
                    assert abs(float(x[60:66]) - float(y[60:66])) <= 0.0101
    # --atoms_only / --frags_only, node fragments (--frag_bonds 0)
    assert tvis.main(base + ["-o", str(tmp_path / "a"), "--device", "cpu",
                             "--atoms_only"]) == 0
    assert tvis.main(base + ["-o", str(tmp_path / "n"), "--device", "cpu",
                             "--frags_only", "--frag_bonds", "0"]) == 0
    names = sorted(p.name for p in tmp_path.glob("[an]_*.pdb"))
    assert names == ["a_0_atoms.pdb", "a_1_atoms.pdb", "n_0_frags.pdb",
                     "n_1_frags.pdb"]
    n0 = (tmp_path / "n_0_frags.pdb").read_text().splitlines()[:-1]
    want = tvis.fragment_masking_scores(
        ts, system["trec"], system["tligs"][0],
        tvis.node_fragments(system["tligs"][0]))
    assert np.allclose([float(x[60:66]) for x in n0], want, atol=0.0051)


def test_main_defaults_to_the_card(system, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tvis.main(["-r", system["rec"], "-l", system["lig"], "-o",
                   str(tmp_path / "x"), "--cnn", "fast"])
