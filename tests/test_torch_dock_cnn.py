"""The CNN inside the search end to end: the port's general path under the
CNN-in-the-loop modes against the JAX package's, on the CPU (toy CNN; the
system of test_torch_cnn_objective.py: the ligand at the origin in a
synthetic receptor, a 10 A box).

A `refinement` dock (CNN Metropolis, CNN refinement of the saved poses,
the CNNscore sort) of 2 ligands x 4 chains x 8 MC steps on both sides.  A
batch's ligands dock independently (each has its own chains and random
streams on both sides), so one dock_batch of 6 copies is 3 runs of 2.  JAX
docks one run in a worker thread (its programs compile for about 100 s
meanwhile); the port docks one batch of 6 copies, 3 runs, and the other
modes' jobs in the main thread.  Check: the port's mean over its 3 runs
of each ligand's top CNNscore (averaged over the run's 2 ligands) lies
within MARGIN of JAX's run.

MARGIN comes from `python tests/test_torch_dock_cnn.py --sweep 24`, which
docks 24 runs of 2 on each side and prints the spread of the difference
between a 3-run mean of the port and one run of JAX.  Over runs 0-23 on an
8-core CPU host (CPU sweep): JAX's top CNNscore mean 0.9492 / sd 0.0138,
the port's 0.9402 / sd 0.0206; the difference has mean -0.0090 and sd
0.0182, and the margin below is |mean| + 4 sd = 0.0819, rounded up to
0.09.  The port sits 0.009 below JAX, 1.8 standard errors (0.0051) of the
difference of the two 24-run means: not resolved at this count.

The other modes (metrorescore, metrorefine, all) dock on the port and take
the general path; without a scorer every mode docks on the fused route,
as the JAX engine docks it without the CNN (tests/test_torch_dock_modes.py).
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

from gnina_tpu.docking import DockingEngine as JEngine  # noqa: E402
from gnina_tpu.docking import DockSettings as JSettings  # noqa: E402
from gnina_tpu_torch.constants import IS_HYDROGEN  # noqa: E402
from gnina_tpu_torch.docking import DockingEngine, DockSettings  # noqa: E402
from test_torch_cnn_objective import load_system, toy_scorers, \
    write_system  # noqa: E402

SETTINGS = dict(cnn_scoring="refinement", num_mc_steps=8, exhaustiveness=4,
                num_mc_saved=9)
MARGIN = 0.09     # CNNscore, see the module docstring
OTHER_MODES = ("metrorescore", "metrorefine", "all")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def top_score(results):
    """Mean over a run's ligands of each ligand's top CNNscore."""
    return float(np.mean([r[0].cnnscore for r in results]))


def jax_runs(system, js, copies: int, seed: int = 0):
    """One JAX dock_batch (general path) of `copies` ligands: runs of 2."""
    eng = JEngine(JSettings(fused_search="off", **SETTINGS), cnn_scorer=js)
    res = eng.dock_batch(system["jrec"], [system["jlig"]] * copies,
                         system["center"], system["size"], seed=seed)
    return [res[i:i + 2] for i in range(0, copies, 2)]


def port_runs(system, ts, batches):
    eng = DockingEngine(DockSettings(**SETTINGS), cnn_scorer=ts,
                        device="cpu")
    runs = []
    for b in batches:
        res = eng.dock_batch(system["trec"], [system["tlig"]] * 6,
                             system["center"], system["size"], seed=b)
        runs += [res[i:i + 2] for i in range(0, 6, 2)]
    return runs, eng


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    return load_system(*write_system(tmp_path_factory.mktemp("dock_cnn")))


@pytest.fixture(scope="module")
def runs(system):
    js, ts = toy_scorers(0)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(jax_runs, system, js, 2)
        calls = []
        real = DockingEngine._dock_general

        def spy(self, *a, **kw):
            calls.append(self.settings.cnn_scoring)
            return real(self, *a, **kw)

        DockingEngine._dock_general = spy
        try:
            port, eng = port_runs(system, ts, [0])
            others = {}
            for mode in OTHER_MODES:
                # 1 ligand x 2 chains x 2 steps
                e = DockingEngine(DockSettings(**dict(
                    SETTINGS, cnn_scoring=mode, num_mc_steps=2,
                    exhaustiveness=2, num_mc_saved=4, num_modes=4)),
                    cnn_scorer=ts, device="cpu")
                assert not e._fused_route([system["tlig"]])
                others[mode] = e.dock(system["trec"], system["tlig"],
                                      system["center"], system["size"],
                                      seed=3)
        finally:
            DockingEngine._dock_general = real
        jres = fut.result(timeout=900)
    return dict(port=port, jax=jres, eng=eng, ts=ts, calls=calls,
                others=others)


def test_refinement_dock_top_cnnscore_within_margin_of_jax(runs):
    port = np.mean([top_score(r) for r in runs["port"]])
    jx = np.mean([top_score(r) for r in runs["jax"]])
    assert abs(port - jx) <= MARGIN, (port, jx)
    assert runs["calls"][0] == "refinement"


def test_refinement_dock_poses_sorted_scored_and_in_the_box(runs, system):
    """Every ligand returns up to num_modes poses sorted by CNNscore, heavy
    atoms in the box (the refinement stages escalate the box slope), and
    CNNscore / CNNaffinity equal to score_poses_multi on the poses'
    coordinates within 1e-5."""
    lig = system["tlig"]
    heavy = ~IS_HYDROGEN[lig.types]
    lo = system["center"] - system["size"] / 2
    hi = system["center"] + system["size"] / 2
    ts = runs["ts"]
    for run in runs["port"]:
        for poses in run:
            assert 1 <= len(poses) <= 9
            sc = [p.cnnscore for p in poses]
            assert sc == sorted(sc, reverse=True)
            assert all(0.0 < x < 1.0 for x in sc)
            for p in poses:
                c = p.coords[heavy]
                assert np.isfinite(p.energy)
                assert ((c >= lo - 1e-3) & (c <= hi + 1e-3)).all()
            s, a, _l, _v = ts.score_poses(system["trec"], lig,
                                          np.stack([p.coords for p in poses]))
            np.testing.assert_allclose(sc, s, rtol=0, atol=1e-5)
            np.testing.assert_allclose([p.cnnaffinity for p in poses], a,
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("mode", OTHER_MODES)
def test_cnn_modes_dock_on_the_general_path(runs, mode):
    """Each other CNN-in-the-loop mode with a scorer docks through
    _dock_general (1 ligand x 2 chains x 2 steps, in the fixture): finite
    poses sorted by CNNscore."""
    res = runs["others"][mode]
    assert runs["calls"].count(mode) == 1 and 1 <= len(res) <= 4
    sc = [p.cnnscore for p in res]
    assert sc == sorted(sc, reverse=True)
    assert np.isfinite([p.energy for p in res]).all()


def _sweep(n: int):
    """Dock n runs of 2 on each side; print the spread of the difference
    of the top CNNscore between a 3-run mean of the port and one run of JAX
    that sets MARGIN."""
    import tempfile
    from pathlib import Path

    torch.set_num_threads(2)        # as under the test fixture
    system = load_system(*write_system(Path(tempfile.mkdtemp())))
    js, ts = toy_scorers(0)
    jb = np.array([top_score(r) for r in jax_runs(system, js, 2 * n)])
    print("jax  top CNNscore per run:", np.round(jb, 4).tolist(), flush=True)
    port, _ = port_runs(system, ts, range((n + 2) // 3))
    pb = np.array([top_score(r) for r in port[:n]])
    print("port top CNNscore per run:", np.round(pb, 4).tolist(), flush=True)
    diff_sd = np.sqrt(jb.var(ddof=1) + pb.var(ddof=1) / 3)
    print(f"jax  top: mean {jb.mean():.4f} sd {jb.std(ddof=1):.4f}")
    print(f"port top: mean {pb.mean():.4f} sd {pb.std(ddof=1):.4f}")
    print(f"port 3-run mean - jax run: mean {pb.mean() - jb.mean():.4f} "
          f"sd {diff_sd:.4f}; |mean| + 4 sd = "
          f"{abs(pb.mean() - jb.mean()) + 4 * diff_sd:.4f}")


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--sweep":
        _sweep(int(sys.argv[2]))
    else:
        print("usage: python tests/test_torch_dock_cnn.py --sweep N")
