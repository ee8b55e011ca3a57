"""The yardstick (dockbench/roofline.py): the counted work does not depend
on which receptor atoms a kernel tests, only on the poses and the atoms
inside the cutoff."""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import gen, lookup, roofline  # noqa: E402


def _system():
    t = lookup.traffic("screen_druglike")
    pts, _ = gen.receptor.lattice(t["receptor"]["center"], 0, 40.0, 2.7,
                                  9.0, 0.15)
    rng = np.random.default_rng(0)
    center = np.asarray(t["receptor"]["center"])
    poses = center + rng.normal(scale=3.0, size=(5, 20, 3))
    return pts, poses


def test_ops_count_the_same_for_every_pair_or_the_cutoff_pairs():
    rec, poses = _system()
    # a brute-force kernel tests every receptor atom; a cell list only those
    # near the pose; the pairs inside the cutoff, and so the operations, are
    # the same
    d = np.sqrt(((poses.reshape(-1, 1, 3) - rec[None]) ** 2).sum(-1))
    near = rec[(d < roofline.CUTOFF).any(0)]
    every = roofline.in_cutoff_pairs(poses, rec)
    cells = roofline.in_cutoff_pairs(poses, near)
    assert np.array_equal(every, cells)
    far = np.concatenate([rec, rec + 100.0])
    assert np.array_equal(roofline.in_cutoff_pairs(poses, far), every)
    assert roofline.eval_ops(every, 3, 2) == roofline.eval_ops(cells, 3, 2)


def test_in_cutoff_pairs_by_brute_force():
    rec, poses = _system()
    d2 = ((poses[:, :, None] - rec[None, None]) ** 2).sum(-1)
    assert np.array_equal(roofline.in_cutoff_pairs(poses, rec),
                          (d2 < 64.0).sum((1, 2)))


def test_ops_bytes_and_bound():
    ops = roofline.eval_ops(np.array([100, 200]), np.array([2, 0]),
                            np.array([1, 3]))
    assert ops == 100 * (2 * 46 + 72) + 200 * 3 * 72
    nb = roofline.launch_bytes(1000, 4, 24, 50, 3, stream_rows=8)
    assert nb == 16000 + 4 * (24 * 16 + 50 * 8) + 4 * 2 * 40 + 4 * 8 * 52
    assert roofline.bound_s(67e12, 1.0) == 1.0
    assert roofline.bound_s(0.0, 3.35e12) == 1.0


def test_model_flops_of_a_default_model():
    from dockbench.reference import cnn

    m = cnn.Model("dense_1_3", os.path.join(ROOT, "gnina_tpu", "data",
                                            "models"), "cpu")
    f = roofline.model_flops(m.spec, m.params, m.rec_channels
                             + m.lig_channels, m.points)
    # a dense 3-D CNN on a 48^3 grid: billions of operations a pose
    assert 1e9 < f < 1e12
