"""The port's replay of JAX's threefry draws (gnina_tpu_torch/ops/jax_random.py)
against jax.random on the CPU, and gninagrid --random_rotation's files
against the JAX tool's.

PRNGKey and bits must be equal; normal within 1e-6 (torch.erfinv against
XLA's erf_inv, both float32); the rotation within 1e-6; the grid files within
1e-4, the voxelizers' bound (tests/test_torch_gninagrid.py).
"""

import os

import jax
import numpy as np
import pytest
import torch

from gnina_tpu.ops.quat import quaternion_to_matrix as jquat_to_matrix, \
    random_orientation as jrandom_orientation
from gnina_tpu.tools import gninagrid as jg
from gnina_tpu_torch.ops import jax_random as jr
from gnina_tpu_torch.tools import gninagrid as tg

from test_torch_gninagrid import write_origin_system

SEEDS = list(range(1000)) + [2 ** 31 - 1, 2 ** 31, 2 ** 32 + 5, 2 ** 40 + 3,
                             2 ** 63 - 1, -1, -5, -(2 ** 31), -(2 ** 40) - 7,
                             -(2 ** 63)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _jax_keys(seeds):
    return np.stack([np.asarray(jax.random.key_data(jax.random.PRNGKey(s)))
                     for s in seeds])


def test_prngkey_equals_jax():
    want = _jax_keys(SEEDS)
    got = np.stack([jr.PRNGKey(s) for s in SEEDS])
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)


def test_prngkey_refuses_seeds_beyond_int64():
    with pytest.raises(OverflowError):
        jr.PRNGKey(2 ** 63)
    with pytest.raises(OverflowError):
        jr.PRNGKey(-(2 ** 63) - 1)


@pytest.mark.parametrize("shape", [(4,), (3, 5), (1000,)],
                         ids=["4", "3x5", "1000"])
def test_bits_equal_jax(shape):
    batch = jax.jit(jax.vmap(lambda k: jax.random.bits(k, shape)))
    keys = [jr.PRNGKey(s) for s in SEEDS[:200]]
    want = np.asarray(batch(jax.numpy.asarray(np.stack(keys))))
    got = np.stack([jr.bits(k, shape) for k in keys])
    assert got.dtype == np.uint32
    assert np.array_equal(got, want)


def test_normal_and_uniform_within_1e6():
    keys = np.stack([jr.PRNGKey(s) for s in SEEDS])
    jk = jax.numpy.asarray(keys)
    want_n = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.normal(k, (4,))))(jk))
    want_u = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, (4,), minval=-2.0, maxval=3.0)))(jk))
    got_n = np.stack([jr.normal(k, (4,)).numpy() for k in keys])
    got_u = np.stack([jr.uniform(k, (4,), -2.0, 3.0).numpy() for k in keys])
    assert np.abs(got_u - want_u).max() <= 1e-6
    assert np.abs(got_n - want_n).max() <= 1e-6


def test_random_rotation_equals_jax():
    """tools/gninagrid.random_rotation(s) is JAX's
    quaternion_to_matrix(random_orientation(PRNGKey(s)))."""
    rot = jax.jit(jax.vmap(
        lambda k: jquat_to_matrix(jrandom_orientation(k))))
    seeds = SEEDS[:300] + SEEDS[-10:]
    want = np.asarray(rot(jax.numpy.asarray(
        np.stack([jr.PRNGKey(s) for s in seeds]))))
    got = np.stack([tg.random_rotation(s) for s in seeds])
    assert np.abs(got - want).max() <= 1e-6


@pytest.mark.parametrize("seed", [0, 11])
def test_random_rotation_files_equal_the_jax_tools(tmp_path, seed):
    """gninagrid --random_rotation --random_translate writes the JAX tool's
    files, name for name, within 1e-4."""
    lig, rec = write_origin_system(tmp_path, cavity=3.5)
    args = ["-r", rec, "-l", lig, "--random_rotation", "--random_translate",
            "0.8", "--seed", str(seed), "--dimension", "6"]
    os.mkdir(tmp_path / "jax")
    os.mkdir(tmp_path / "port")
    assert jg.main(args + ["-o", str(tmp_path / "jax" / "g")]) == 0
    assert tg.main(args + ["-o", str(tmp_path / "port" / "g"),
                           "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names and names == sorted(os.listdir(tmp_path / "port"))
    for name in names:
        want = np.fromfile(tmp_path / "jax" / name, np.float32)
        got = np.fromfile(tmp_path / "port" / name, np.float32)
        assert got.shape == want.shape
        assert np.abs(want).max() > 0.1
        assert np.abs(got - want).max() <= 1e-4, name
