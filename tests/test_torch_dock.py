"""The ported docking route end to end against the JAX package.

The port's DockingEngine.dock_batch (device="cpu", the kernels' plain
versions) docks 2 copies of the minout.sdf ligand x 4 chains for 64 MC
steps (window S=16) into a synthetic receptor of a few hundred atoms; the
JAX package's dock_batch with fused_search="off" (its general XLA path,
which runs on the CPU) docks the same job.  The JAX engine is built once
and all seeds go through it, in a worker thread that compiles while the
port docks.

Check: the port's mean best energy over 3 seeds lies within MARGIN of
JAX's.  (The per-pose checks against the JAX exact rescore are in
test_torch_dock_api.py, which needs no JAX docking run.)

MARGIN comes from `python tests/test_torch_dock.py --sweep 24`, which docks
24 seeds on each side and prints the spread of a 3-seed mean difference.
Over seeds 0-23 on an 8-core CPU host, the per-seed best (mean of the two
ligands) had mean -6.891 / sd 0.224 kcal/mol for JAX and mean -6.643 /
sd 0.230 for the port; the 3-seed-mean difference then has mean 0.248 and
sd 0.185, and the margin below is |mean| + 4 sd = 0.989, rounded up.  The
port sits above JAX here because it runs the fused route (which the JAX
package takes only on a TPU), not the general one: its pooled tick budget
(16 evaluations per step, shared over a 16-step window) ends windows
before all their steps complete, and it refines at full v once per
window, where the general path minimises every step to its end and
refines every 8 steps.  With a tick budget of 64 (`--sweep 12 64`) the
gap over seeds 0-11 fell from 0.236 to 0.138 kcal/mol.
`--sweep N BUDGET` docks the port side with another tick budget.
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


from gnina_tpu.chem import ingest as jingest  # noqa: E402
from gnina_tpu.docking import DockingEngine as JEngine  # noqa: E402
from gnina_tpu.docking import DockSettings as JSettings  # noqa: E402
from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem import ingest as tingest  # noqa: E402
from gnina_tpu_torch.docking import DockingEngine, DockSettings  # noqa: E402

SETTINGS = dict(cnn_scoring="none", num_mc_steps=64, exhaustiveness=4,
                num_mc_saved=9)
SEEDS = (0, 1, 2)
BOX = 12.0
CUBE = 18.0
MARGIN = 1.0      # kcal/mol, see the module docstring


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _write_receptor(directory) -> str:
    center = fx.ligand_center(fx.ligand())
    path = os.path.join(str(directory), "rec.pdb")
    with open(path, "w") as f:
        f.write(fx.receptor_pdb_text(center, seed=0, cube=CUBE))
    return path


def _box():
    center, _ = tingest.autobox_ligand(fx.LIGAND_SDF)
    return np.asarray(center, np.float32), np.full(3, BOX, np.float32)


def jax_runs(path, seeds):
    """JAX dock_batch (general XLA path) for each seed."""
    rec = jingest.Receptor.from_file(path)
    lig = next(jingest.iter_ligands(fx.LIGAND_SDF))
    center, size = _box()
    eng = JEngine(JSettings(fused_search="off", **SETTINGS))
    return {s: eng.dock_batch(rec, [lig, lig], center, size, seed=s)
            for s in seeds}


def port_runs(path, seeds, **settings):
    rec = tingest.Receptor.from_file(path)
    lig = fx.ligand()
    center, size = _box()
    eng = DockingEngine(DockSettings(**SETTINGS, **settings), device="cpu")
    return {s: eng.dock_batch(rec, [lig, lig], center, size, seed=s)
            for s in seeds}


def best(results):
    """Mean over the batch's ligands of each ligand's top pose energy."""
    return float(np.mean([r[0].energy for r in results]))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = _write_receptor(tmp_path_factory.mktemp("dock"))
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(jax_runs, path, SEEDS)
        port = port_runs(path, SEEDS)
        jres = fut.result(timeout=900)
    return dict(path=path, port=port, jax=jres)


def test_port_mean_best_within_margin_of_jax(runs):
    port = np.mean([best(runs["port"][s]) for s in SEEDS])
    jx = np.mean([best(runs["jax"][s]) for s in SEEDS])
    assert abs(port - jx) <= MARGIN, (port, jx)
    # both found bound poses in the synthetic pocket
    assert port < 0 and jx < 0


def _sweep(n: int, tick_budget: int = 0):
    """Dock seeds 0..n-1 on both sides; print the spread of the
    3-seed-mean difference that sets MARGIN.  tick_budget > 0 docks the
    port side with that fused_mc_tick_budget."""
    import tempfile

    torch.set_num_threads(2)        # as under the test fixture
    path = _write_receptor(tempfile.mkdtemp())
    seeds = range(n)
    jb = np.array([best(r) for r in jax_runs(path, seeds).values()])
    print("jax  best per seed:", np.round(jb, 3).tolist(), flush=True)
    extra = {"fused_mc_tick_budget": tick_budget} if tick_budget else {}
    pb = np.array([best(r) for r in port_runs(path, seeds,
                                              **extra).values()])
    print("port best per seed:", np.round(pb, 3).tolist(), flush=True)
    diff_sd = np.sqrt(jb.var(ddof=1) / 3 + pb.var(ddof=1) / 3)
    print(f"jax  best: mean {jb.mean():.3f} sd {jb.std(ddof=1):.3f}")
    print(f"port best: mean {pb.mean():.3f} sd {pb.std(ddof=1):.3f}")
    print(f"3-seed mean difference: mean {pb.mean() - jb.mean():.3f} "
          f"sd {diff_sd:.3f}; |mean| + 4 sd = "
          f"{abs(pb.mean() - jb.mean()) + 4 * diff_sd:.3f}")


if __name__ == "__main__":
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--sweep":
        _sweep(*[int(a) for a in sys.argv[2:]])
    else:
        print("usage: python tests/test_torch_dock.py --sweep N [BUDGET]")
