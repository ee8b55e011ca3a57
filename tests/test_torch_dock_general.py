"""The port's general docking path end to end against the JAX package's.

The job is tests/test_torch_dock.py's: 2 copies of the minout.sdf ligand x
4 chains x 64 MC steps in a 12 A box of a synthetic receptor.  Both sides
run their general path (fused_search="off": search grids, the per-step MC
of mc_chunk, the five slope stages on the exact energy), so the two runs
are the same algorithm on different random numbers.  JAX docks seeds
0-2 in a worker thread (its programs compile meanwhile); the port docks
the three seeds' six ligands as one dock_batch of 6 copies (each ligand's
4 chains are independent of the other lanes, so a batch of 6 copies is 3
runs of 2; one batch costs the CPU a third of three).

Check: the port's mean best energy over the 3 x 2 ligands lies within
MARGIN of JAX's over its 3 seeds.

MARGIN comes from `python tests/test_torch_dock_general.py --sweep 24`,
which docks 24 seeds on the JAX side and 24 runs of 2 (8 batches of 6
copies) on the port's and prints the spread of a 3-run mean difference.
Over runs 0-23 on an 8-core CPU host, the per-run best (mean of the two
ligands) had mean -6.891 / sd 0.224 kcal/mol for JAX (the same seeds as
test_torch_dock.py's sweep) and mean -6.799 / sd 0.202 for the port; the
3-run-mean difference then has mean 0.092 and sd 0.174, and the margin
below is |mean| + 4 sd = 0.790, rounded up.  Over the 24 runs the port
sits 0.092 above JAX, 1.5 standard errors (0.062) of the difference of
the two means: not resolved at this count.
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
    sys.path.insert(0, os.path.join(REPO, "tests"))

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem import ingest as tingest  # noqa: E402
from gnina_tpu_torch.constants import IS_HYDROGEN  # noqa: E402
from gnina_tpu_torch.docking import DockingEngine, DockSettings  # noqa: E402
from test_torch_dock import SETTINGS, _box, _write_receptor, best, \
    jax_runs  # noqa: E402

SEEDS = (0, 1, 2)
MARGIN = 0.8      # kcal/mol, see the module docstring


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_general_runs(path, batches, **settings):
    """The port's general path: one dock_batch of 6 copies per batch seed,
    returned as 3 runs of 2 ligands each."""
    rec = tingest.Receptor.from_file(path)
    lig = fx.ligand()
    center, size = _box()
    eng = DockingEngine(DockSettings(fused_search="off",
                                     **dict(SETTINGS, **settings)),
                        device="cpu")
    runs = []
    for b in batches:
        res = eng.dock_batch(rec, [lig] * 6, center, size, seed=b)
        runs += [res[i:i + 2] for i in range(0, 6, 2)]
    return runs, eng


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = _write_receptor(tmp_path_factory.mktemp("dock_general"))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(jax_runs, path, SEEDS)
        port, eng = port_general_runs(path, [0])
        jres = fut.result(timeout=900)
    return dict(path=path, port=port, jax=jres, eng=eng)


def test_general_path_mean_best_within_margin_of_jax(runs):
    port = np.mean([best(r) for r in runs["port"]])
    jx = np.mean([best(runs["jax"][s]) for s in SEEDS])
    assert abs(port - jx) <= MARGIN, (port, jx)
    assert port < -5.0 and jx < -5.0


def k1_energies(eng, rec, lig, poses, center, size):
    """Each pose's affinity by the fused route's exact rescore: K1's plain
    version on a one-lane-a-pose pack (an energy code of its own, not the
    general path's autograd energy)."""
    from gnina_tpu_torch.chem.ingest import box_from_center_size
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.types import Conf

    m = -(-lig.num_nodes // 4) * 4
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=eng.sf.cutoff)
    pack = fd.build_pack([lig], pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), len(poses),
                         eng.sf.table, m_pad=m, device="cpu")
    f = lambda rows: torch.as_tensor(np.asarray(rows, np.float32))
    tors = np.zeros((len(poses), m - 1), np.float32)
    for i, p in enumerate(poses):
        tors[i, :len(p.conf_torsions)] = p.conf_torsions
    rigid, ptors = fd.conf_to_packed(Conf(
        f([p.conf_position for p in poses]),
        f([p.conf_orientation for p in poses]), f(tors)), m)
    lo, hi = box_from_center_size(center, size)
    inter, _ = eng._exact_energies(rigid, ptors, pack, lo, hi, 1e3)
    return np.asarray([float(eng._conf_independent(lig, x)) for x in inter])


def test_general_path_poses_are_sorted_in_the_box_and_rescored(runs):
    """Every ligand returns up to num_modes poses sorted by energy, each
    pose's heavy atoms in the box (the stages' slope escalation), and each
    energy the exact rescore of its pose by K1's plain version within
    1e-3 kcal/mol."""
    eng = runs["eng"]
    center, size = _box()
    lo, hi = center - size / 2, center + size / 2
    lig = fx.ligand()
    heavy = ~IS_HYDROGEN[lig.types]
    rec = tingest.Receptor.from_file(runs["path"])
    for res in runs["port"]:
        for poses in res:
            assert 1 <= len(poses) <= SETTINGS["num_mc_saved"]
            e = [p.energy for p in poses]
            assert e == sorted(e) and np.isfinite(e).all()
            for p in poses:
                c = p.coords[heavy]
                assert ((c >= lo - 1e-3) & (c <= hi + 1e-3)).all()
    poses = runs["port"][0][0] + runs["port"][0][1]
    np.testing.assert_allclose(
        k1_energies(eng, rec, lig, poses, center, size),
        [p.energy for p in poses], rtol=0, atol=1e-3)


def _sweep(n: int):
    """Dock n seeds on the JAX side and n runs of 2 on the port's; print the
    spread of the 3-run-mean difference that sets MARGIN."""
    import tempfile

    torch.set_num_threads(2)        # as under the test fixture
    path = _write_receptor(tempfile.mkdtemp())
    jb = np.array([best(r) for r in jax_runs(path, range(n)).values()])
    print("jax  best per seed:", np.round(jb, 3).tolist(), flush=True)
    port, _ = port_general_runs(path, range((n + 2) // 3))
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
        print("usage: python tests/test_torch_dock_general.py --sweep N")
