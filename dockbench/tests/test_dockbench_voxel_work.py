"""The voxeliser's yardstick (dockbench/voxel_work.py) and its reader
(voxelize_roofline) on hand-sized cases."""

import os
import sys
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import gen, lookup, roofline, voxel_work  # noqa: E402

DEFAULT = ["dense_1_3", "dense_1_3_PT_KD_3", "crossdock_default2018_KD_4"]
MODELS = os.path.join(ROOT, "gnina_tpu", "data", "models")
ARGV = ["run.py", "--workload", "gnina_default.screen", "--seed", "1"]


@pytest.fixture
def no_library(monkeypatch):
    """The traffic's library is not drawn here."""
    monkeypatch.setattr(gen.Screen, "__init__",
                        lambda self, t, cache: setattr(self, "t", t))


def test_bytes_and_bound():
    group = dict(channels=28, points=48)
    assert voxel_work.grid_bytes(3, group) == 3 * 28 * 48 ** 3 * 4
    # 2 poses in 1 call, 100 receptor atoms, 20 ligand atoms a pose: the
    # grids and 16 B an atom
    nb = 2 * 28 * 48 ** 3 * 4 + 16 * (100 + 2 * 20)
    got = voxel_work.bound_s([group], 2, 1, 100, 20)
    assert got == nb / roofline.HBM_RATE


def test_the_default_ensemble_is_one_group():
    """The three models of gnina's default ensemble share one grid: 28
    channels at 48^3, 0.5 A."""
    groups = voxel_work.grid_groups(DEFAULT, MODELS)
    assert groups == [dict(channels=28, points=48, resolution=0.5)]


def test_the_bytes_decide_the_bound(no_library):
    """Every atom of the traffic's pocket and of its largest ligands, each
    reaching the whole cube of 1.5 r around it at the largest radius,
    at 14 float32 operations a point (the squared distance 8, the tail 5,
    the sum 1), takes less time at the peak than one pose's grid takes to
    write: the operations cannot decide the bound."""
    from dockbench.reference import chem

    traffic = lookup.traffic("screen_druglike")
    xyz, _types = gen.Screen(traffic, "").receptor()
    g = voxel_work.grid_groups(DEFAULT, MODELS)[0]
    side = 2 * np.ceil(1.5 * float(chem.XS_RADIUS.max()) / g["resolution"]) \
        + 1
    # the largest class's heavy atoms, twice over for its hydrogens
    lig_atoms = 2 * max(c["atoms"][1] for c in traffic["classes"].values())
    ops_s = (len(xyz) + lig_atoms) * side ** 3 * 14 / roofline.FP32_PEAK
    assert ops_s < voxel_work.grid_bytes(1, g) / roofline.HBM_RATE


def test_the_window_bound():
    """The scored poses at the mean atoms of the written ligands, the
    receptor read once a call; nothing without poses or a CNN."""
    g = voxel_work.grid_groups(DEFAULT, MODELS)
    ctx = types.SimpleNamespace(
        tracer=types.SimpleNamespace(scored=[100, 28]), calls=[{}] * 2,
        rec_atoms=2000, ligand_work={"a": dict(atoms=20),
                                     "b": dict(atoms=40)})
    assert voxel_work.window_bound_s(ctx, ARGV) == voxel_work.bound_s(
        g, 128, 2, 2000, 30.0)
    ctx.tracer.scored = []
    assert voxel_work.window_bound_s(ctx, ARGV) is None
    ctx.tracer.scored = [128]
    assert voxel_work.window_bound_s(
        ctx, ["run.py", "--workload", "vina_nocnn.screen"]) is None


def test_the_cell_comes_from_the_command_line():
    assert voxel_work.cell_config(ARGV)["cnn_models"] == DEFAULT
    assert voxel_work.cell_config(["run.py", "--workload=vina_nocnn.screen"]
                                  )["cnn_models"] == []
    assert voxel_work.cell_config(["pytest", "-q"]) is None
    assert voxel_work.cell_config(["run.py", "--workload", "no.cell"]) is None


@pytest.mark.parametrize("kernels,bound,want", [
    ([], 1.0, None),                                     # no device trace
    ([("k_async_mc(PackArgs)", 0, 10 ** 9)], 1.0, None),  # the parent
    ([("k_voxelize(VoxArgs, float*)", 0, 4 * 10 ** 9)], None, None),
    ([("k_voxelize(VoxArgs, float*)", 0, 4 * 10 ** 9)], 1.0, 25.0)])
def test_the_reader(monkeypatch, kernels, bound, want):
    """The card's time in k_voxelize by name from the trace, over which
    the bound is a share; nothing without the kernel or a bound."""
    monkeypatch.setattr(voxel_work, "window_bound_s",
                        lambda ctx, argv: bound)
    ctx = types.SimpleNamespace(kernels=kernels)
    assert lookup.reader("voxelize_roofline")(ctx) == want
