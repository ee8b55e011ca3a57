"""The host side of the fused kernels' shared-memory design: the plan that
decides whether a pose block keeps the receptor resident or streams it
through tiles (ops/fused_dock.smem_plan), its mirror of the CUDA source's
layout, and the probe K11's shape checks.  CPU only: the kernels themselves
are held against their plain versions on a card
(test_torch_kernels_cuda.py)."""

import os
import re

import numpy as np
import pytest
import torch

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import probes
from gnina_tpu_torch.ops import fused_dock as fd
from gnina_tpu_torch.scoring.builtin import get_scoring_function

torch.set_num_threads(2)

CU = os.path.join(os.path.dirname(fd.__file__), os.pardir, "csrc",
                  "fused_dock.cu")


def _source():
    with open(CU) as f:
        return f.read()


def _define(src, name):
    return int(re.search(rf"#define {name} (\d+)", src).group(1))


def test_layout_constants_match_the_cuda_source():
    """The plan's constants are the kernel's: threads a block, queue
    entries a warp, the bytes before the receptor."""
    src = _source()
    assert _define(src, "NT") == fd.BLOCK_THREADS
    assert _define(src, "QCAP") == fd.QUEUE_CAP
    assert _define(src, "REC_OFFSET") == fd.REC_OFFSET


@pytest.mark.parametrize("n,m,d", [(24, 4, 9), (8, 1, 6), (64, 40, 45),
                                   (40, 12, 17)])
def test_state_floats_is_the_cuda_formula(n, m, d):
    """state_floats evaluates smem_floats of csrc/fused_dock.cu: the C
    expression, read from the source, gives the same count."""
    src = _source()
    body = re.search(r"inline int smem_floats\(int N, int M, int D\) \{\s*"
                     r"return (.*?);\s*\}", src, re.S).group(1)
    body = " ".join(re.sub(r"//[^\n]*", "", body).split())
    s_count = int(re.search(r"S_COUNT = (\d+)", src).group(1))
    got = eval(body, {"N": n, "M": m, "D": d,
                      "MAXWARPS": fd.BLOCK_THREADS // 32, "S_COUNT": s_count})
    assert got == fd.state_floats(n, m, d)


def test_main_path_receptor_stays_resident():
    """K = 2,157 (the main path's pruned receptor) is one resident copy of
    69 KB beside the pose state."""
    plan = fd.smem_plan(24, 4, 9, 2157)
    assert plan.resident and plan.n_tiles == 1 and plan.rec_tile == 2157
    fixed = (fd.REC_OFFSET + 4 * fd.state_floats(24, 4, 9)
             + 4 * (fd.BLOCK_THREADS // 32) * fd.QUEUE_CAP)
    assert plan.nbytes == fixed + 2157 * fd.REC_ROW_BYTES
    assert plan.nbytes <= fd.SMEM_LIMIT


@pytest.mark.parametrize("k", [6145, 6154, 8192, 20000, 100000])
def test_large_receptor_streams_through_two_tiles(k):
    """Above REC_RESIDENT_BYTES the receptor streams: two buffers of
    REC_TILE_ATOMS, ceil(K / tile) tiles an evaluation, the same bytes
    whatever K."""
    plan = fd.smem_plan(24, 4, 9, k)
    assert not plan.resident
    assert plan.rec_tile == fd.REC_TILE_ATOMS
    assert plan.n_tiles == -(-k // fd.REC_TILE_ATOMS)
    assert plan.nbytes == fd.smem_plan(24, 4, 9, 6145).nbytes
    assert plan.nbytes <= fd.SMEM_LIMIT


def test_resident_threshold():
    """Resident up to REC_RESIDENT_BYTES of receptor rows, streamed above."""
    k_max = fd.REC_RESIDENT_BYTES // fd.REC_ROW_BYTES
    assert fd.smem_plan(24, 4, 9, k_max).resident
    assert not fd.smem_plan(24, 4, 9, k_max + 1).resident
    assert fd.smem_plan(24, 4, 9, 0) == fd.SmemPlan(0, True, 0,
                                                    fd.smem_plan(24, 4, 9, 0)
                                                    .nbytes)


def test_a_large_state_shrinks_the_tiles_or_raises():
    """A ligand whose state leaves less room gets smaller tiles, resident
    receptors that no longer fit stream, and a state beyond the card
    raises."""
    n, m = 96, 40
    d = 6 + m - 1
    plan = fd.smem_plan(n, m, d, 4000)
    assert not plan.resident and plan.rec_tile < fd.REC_TILE_ATOMS
    assert plan.nbytes <= fd.SMEM_LIMIT
    with pytest.raises(ValueError):
        fd.smem_plan(256, 64, 69, 4000)


def test_pack_args_carry_the_plan():
    """The kernels' argument block names the plan's tile: K at the main
    path's receptor, REC_TILE_ATOMS above the budget."""
    sf = get_scoring_function("vina")
    lig = fx.ligand()
    for k, tile in ((2157, 2157), (7000, fd.REC_TILE_ATOMS)):
        rng = np.random.default_rng(k)
        pack = fd.build_pack([lig], rng.normal(size=(k, 3)) * 20.0,
                             rng.integers(0, 4, k), np.ones(k, np.float32), 2,
                             sf.table, m_pad=4, device="cpu")
        a = fd._pack_args(pack, torch.device("cpu"))
        assert (a.K, a.rec_tile) == (k, tile)


def test_probe_mxu_shape_checks():
    """K11's wrapper refuses what the wgmma tiling does not take before any
    launch: rows not a multiple of 64, a depth not a multiple of 16 or
    beyond what one block's shared memory holds."""
    tgt = torch.zeros((128, 1), dtype=torch.int32)
    ok = torch.zeros((896, probes.ROW_WIDTH), dtype=torch.bfloat16)
    for t, g in ((tgt[:100].contiguous(), ok),
                 (tgt, ok[:888].contiguous()),
                 (tgt, torch.zeros((probes.MXU_KMAX + 16, probes.ROW_WIDTH),
                                   dtype=torch.bfloat16))):
        with pytest.raises(ValueError):
            probes._launch_mxu(t, g, 1)
