"""A flex dock through the port's general path end to end against the JAX
package's.

The job: 2 copies of the minout.sdf ligand with the two closest residues
that --flexdist 3.5 selects (--flex_max 2: SER45 and CYS74, 2 flex
torsions) in the receptor with real residues
(_fixtures.flex_receptor_pdb_text, seed 3, a 20 A cube), extracted,
stripped and attached as the command line does, x 4 chains x 32 MC steps in
a 12 A box.  Every flex job takes the general path on both sides (search
grids with the flex atoms' types, the per-step MC of mc_chunk with the
other pairs at v[2], the five slope stages on the exact energy, the
flex-aware exact split), so the two runs are the same algorithm on
different random numbers.  JAX docks seeds 0-2 in a worker thread (its
programs compile meanwhile); the port docks the three seeds' six ligands
as one dock_batch of 6 copies (each ligand's chains are independent of the
other lanes, so one batch of 6 copies is 3 runs of 2).

Check: the port's mean best energy over the 3 x 2 ligands lies within
MARGIN of JAX's over its 3 seeds.

MARGIN comes from `python tests/test_torch_dock_flex.py --sweep 24`,
which docks 24 seeds on the JAX side and 24 runs of 2 (8 batches of 6
copies) on the port's and prints the spread of a 3-run mean difference.
Over runs 0-23 on an 8-core CPU host, the per-run best (mean of the two
ligands) had mean -7.727 / sd 0.116 kcal/mol for JAX and -7.699 / sd
0.207 for the port; the 3-run-mean difference then has mean 0.028 and sd
0.137, and the margin below is |mean| + 4 sd = 0.576, rounded up.
"""

import concurrent.futures
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:            # for the --sweep entry point
    sys.path.insert(0, REPO)

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem import flexinfo as tflex  # noqa: E402
from gnina_tpu_torch.chem import ingest as tingest  # noqa: E402
from gnina_tpu_torch.chem.tree_build import attach_flex  # noqa: E402
from gnina_tpu_torch.constants import IS_HYDROGEN  # noqa: E402
from gnina_tpu_torch.docking import DockingEngine, DockSettings  # noqa: E402

SETTINGS = dict(cnn_scoring="none", num_mc_steps=32, exhaustiveness=4,
                num_mc_saved=4)
SEEDS = (0, 1, 2)
BOX = 12.0
FLEX_MAX = 2      # the two closest residues, SER45 and CYS74
MARGIN = 0.6      # kcal/mol, see the module docstring


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_receptor(directory) -> str:
    path = os.path.join(str(directory), "flex_rec.pdb")
    with open(path, "w") as f:
        f.write(fx.flex_receptor_pdb_text(fx.ligand(), seed=3, cube=20.0))
    return path


def _box():
    center = fx.ligand_center(fx.ligand())
    return center, np.full(3, BOX, np.float32)


def complex_of(ingest, flexinfo, attach, path):
    """(stripped receptor, ligand + the --flexdist 3.5 residues) through
    one package's own readers."""
    rec = ingest.Receptor.from_file(path)
    lig = next(ingest.iter_ligands(fx.LIGAND_SDF))
    keys = flexinfo.select_flex_residues(rec, flexdist=3.5,
                                         flexdist_coords=lig.orig_coords,
                                         flex_max=FLEX_MAX)
    assert keys == list(fx.FLEXDIST_35[:FLEX_MAX])
    flex = [flexinfo.extract_flex_residue(rec, k) for k in keys]
    return flexinfo.strip_flex_from_receptor(rec, flex), attach(lig, flex)


def jax_runs(path, seeds):
    """JAX dock_batch of 2 copies (its general path: flex jobs never take
    the fused route) for each seed."""
    from gnina_tpu.chem import flexinfo as jflex
    from gnina_tpu.chem import ingest as jingest
    from gnina_tpu.chem.tree_build import attach_flex as jattach
    from gnina_tpu.docking import DockingEngine as JEngine
    from gnina_tpu.docking import DockSettings as JSettings

    rec, cplx = complex_of(jingest, jflex, jattach, path)
    center, size = _box()
    eng = JEngine(JSettings(**SETTINGS))
    assert not eng._fused_eligible([cplx])
    return {s: eng.dock_batch(rec, [cplx, cplx], center, size, seed=s)
            for s in seeds}


def port_runs(path, batches):
    """The port: one dock_batch of 6 copies per batch seed, returned as 3
    runs of 2 ligands each."""
    rec, cplx = complex_of(tingest, tflex, attach_flex, path)
    center, size = _box()
    eng = DockingEngine(DockSettings(**SETTINGS), device="cpu")
    assert not eng._fused_route([cplx])
    runs = []
    for b in batches:
        res = eng.dock_batch(rec, [cplx] * 6, center, size, seed=b)
        runs += [res[i:i + 2] for i in range(0, 6, 2)]
    return runs, cplx


def best(results):
    """Mean over the batch's ligands of each ligand's top pose energy."""
    return float(np.mean([r[0].energy for r in results]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = _write_receptor(tmp_path_factory.mktemp("dock_flex"))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(jax_runs, path, SEEDS)
        port, cplx = port_runs(path, [0])
        jres = fut.result(timeout=900)
    return dict(port=port, jax=jres, cplx=cplx)


def test_flex_dock_mean_best_within_margin_of_jax(runs):
    port = np.mean([best(r) for r in runs["port"]])
    jx = np.mean([best(runs["jax"][s]) for s in SEEDS])
    assert abs(port - jx) <= MARGIN, (port, jx)
    assert port < -5.0 and jx < -5.0


def test_flex_poses_keep_the_residues_whole(runs):
    """Every pose: sorted by energy, finite, the movable heavy atoms in the
    box, the inflex anchors (CA, C) at their input coordinates within
    1e-4 A, and every bond inside a flex residue at its input length
    within 1e-3 A."""
    cplx = runs["cplx"]
    center, size = _box()
    lo, hi = center - size / 2, center + size / 2
    orig = cplx.orig_coords
    anchors = slice(cplx.movable_atoms, cplx.num_atoms)
    heavy = ~IS_HYDROGEN[cplx.types] & (np.arange(cplx.num_atoms)
                                        < cplx.movable_atoms)
    bonds, off = [], cplx.movable_atoms
    for (_k, _n, start, end, fr) in cplx.flex_meta:
        idx = np.r_[start:end, off:off + len(fr.inflex_types)]
        off += len(fr.inflex_types)
        d = np.linalg.norm(orig[idx][:, None] - orig[idx][None], axis=-1)
        bonds += [(idx[a], idx[b])
                  for a, b in zip(*np.nonzero(np.triu(d < 2.0, 1)))]
    bonds = np.array(bonds)
    d0 = np.linalg.norm(orig[bonds[:, 0]] - orig[bonds[:, 1]], axis=-1)
    for res in runs["port"]:
        for poses in res:
            e = [p.energy for p in poses]
            assert poses and e == sorted(e) and np.isfinite(e).all()
            for p in poses:
                c = p.coords
                assert np.isfinite(p.intramol)
                assert ((c[heavy] >= lo - 1e-3) & (c[heavy] <= hi + 1e-3)
                        ).all()
                np.testing.assert_allclose(c[anchors], orig[anchors],
                                           rtol=0, atol=1e-4)
                d = np.linalg.norm(c[bonds[:, 0]] - c[bonds[:, 1]], axis=-1)
                np.testing.assert_allclose(d, d0, rtol=0, atol=1e-3)


def _sweep(n: int):
    """Dock n seeds on the JAX side and n runs of 2 on the port's; print the
    spread of the 3-run-mean difference that sets MARGIN."""
    import tempfile

    torch.set_num_threads(2)        # as under the test fixture
    path = _write_receptor(tempfile.mkdtemp())
    jb = np.array([best(r) for r in jax_runs(path, range(n)).values()])
    print("jax  best per seed:", np.round(jb, 3).tolist(), flush=True)
    port, _ = port_runs(path, range((n + 2) // 3))
    pb = np.array([best(r) for r in port[:n]])
    print("port best per run:", np.round(pb, 3).tolist(), flush=True)
    diff_sd = np.sqrt(jb.var(ddof=1) / 3 + pb.var(ddof=1) / 3)
    print(f"jax  best: mean {jb.mean():.3f} sd {jb.std(ddof=1):.3f}")
    print(f"port best: mean {pb.mean():.3f} sd {pb.std(ddof=1):.3f}")
    print(f"3-run mean difference: mean {pb.mean() - jb.mean():.3f} "
          f"sd {diff_sd:.3f}; |mean| + 4 sd = "
          f"{abs(pb.mean() - jb.mean()) + 4 * diff_sd:.3f}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sweep":
        _sweep(int(sys.argv[2]))
    else:
        print("usage: python tests/test_torch_dock_flex.py --sweep N")
