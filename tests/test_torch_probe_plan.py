"""K9's and K10's launch geometry on the CPU (gnina_tpu_torch/probes.py).

pairs_plan and gather_plan make the grids that the wrappers pass to
csrc/probes.cu; the kernels compute nothing outside them.  The partitions
below restate the kernels' index formulas (csrc/probes.cu, K9 and K10) over
those grids.  Here: they cover every (ligand atom, receptor atom, lane) and
every (lookup, repetition) exactly once at ragged sizes, the tile constants
equal the CUDA source's, and K9's checksum summed in the kernel's order
(each thread's accumulators, then blocks) equals the plain version within
2e-5 of the sum of the terms' magnitudes (float32 sums of 10^5-10^6 terms
taken in another order).  The kernels themselves are held to their plain
versions at the same ragged sizes by tests/test_torch_kernels_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from gnina_tpu_torch import probes

CU = os.path.join(os.path.dirname(probes.__file__), "csrc", "probes.cu")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def pairs_partition(lanes, n, k):
    """Every real (atom, receptor, lane) triple with the block and thread
    that compute it under pairs_plan, in the order a thread visits them
    (atom, then lane, then its receptor atom j): int64 arrays `block`
    (x + gx (y + gy z)), `thread`, `atom`, `rec`, `lane`."""
    plan = probes.pairs_plan(lanes, n, k)
    gx, gy, gz = plan["grid"]
    na = plan["atoms"]
    # one axis per loop, outermost first: block (z, y, x), thread, then
    # the thread's own loops: atom, lane, j
    z, y, x, t, ia, il, j = np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx),
        np.arange(probes.PAIRS_THREADS), np.arange(na),
        np.arange(probes.PAIRS_LT), np.arange(probes.PAIRS_KT),
        indexing="ij")
    atom = z * na + ia
    rec = (x * probes.PAIRS_KT + j) * probes.PAIRS_THREADS + t
    lane = y * probes.PAIRS_LT + il
    real = (atom < n) & (rec < k) & (lane < lanes)
    out = {"block": x + gx * (y + gy * z), "thread": t, "atom": atom,
           "rec": rec, "lane": lane}
    return {key: v[real].astype(np.int64) for key, v in out.items()}


def pairs_sum_in_order(e, reps):
    """K9's checksum from pair energies e (N, K, L) in float32, summed as
    the kernel sums them: each thread's accumulators over its atoms and
    lanes (one per receptor slot j, the first started from carry * 1e-30),
    added into the thread's carry each repetition; then each block's
    threads, and the blocks in their order."""
    n, k, lanes = e.shape
    nt, lt, kt = probes.PAIRS_THREADS, probes.PAIRS_LT, probes.PAIRS_KT
    plan = probes.pairs_plan(lanes, n, k)
    gx, gy, gz = plan["grid"]
    na = plan["atoms"]
    # (gz, gy, gx, thread, atom, lane, j), padding 0
    pad = torch.zeros((gz * na, gx * kt * nt, gy * lt), dtype=torch.float32)
    pad[:n, :k, :lanes] = e.float()
    pad = pad.reshape(gz, na, gx, kt, nt, gy, lt).permute(0, 5, 2, 4, 1, 6, 3)
    carry = torch.zeros(pad.shape[:4], dtype=torch.float32)
    for _ in range(reps):
        acc = torch.zeros(pad.shape[:4] + (kt,), dtype=torch.float32)
        acc[..., 0] = carry * 1e-30
        for i in range(na):
            for il in range(lt):
                acc = acc + pad[..., i, il, :]
        s = acc[..., 0]
        for j in range(1, kt):
            s = s + acc[..., j]
        carry = carry + s
    return carry.sum(3).reshape(-1).sum()


def gather_partition(a, reps):
    """The (lookup, repetition) of every unit a thread loads, with its
    block, thread and turn, under gather_plan."""
    plan = probes.gather_plan(a, reps)
    grid = plan["blocks"] * probes.GATHER_THREADS
    g, k = np.meshgrid(np.arange(grid), np.arange(probes.GATHER_UNITS),
                       indexing="ij")
    u = (g + k * grid).reshape(-1)
    g, k = g.reshape(-1), k.reshape(-1)
    real = u < plan["units"]
    u, g, k = u[real], g[real], k[real]
    return {"block": g // probes.GATHER_THREADS,
            "thread": g % probes.GATHER_THREADS, "turn": k, "lookup": u % a,
            "rep": u // a}


def _define(name):
    with open(CU) as f:
        m = re.search(rf"^#define {name} (\S+)", f.read(), re.M)
    return int(m.group(1))


def test_tiles_match_the_cuda_source():
    assert probes.PAIRS_THREADS == _define("K9_THREADS")
    assert probes.PAIRS_LT == _define("K9_LT")
    assert probes.PAIRS_KT == _define("K9_KT")
    assert probes.GATHER_THREADS == _define("K10_THREADS")
    assert probes.GATHER_UNITS == _define("K10_UNITS")
    # each probe's C entry point launches its kernel (K9 one of its two
    # instances) and nothing else, and the kernel ends in block_finish
    with open(CU) as f:
        src = f.read()
    assert probes.LAUNCHES_PER_CALL == 1
    for fn, kernel in (("gt_probe_pairs", "k_probe_pairs<"),
                       ("gt_probe_gather", "k_probe_gather<<<"),
                       ("gt_probe_mxu", "k_probe_mxu<<<")):
        body = src[src.index(f"int {fn}("):]
        body = body[:body.index("\n}\n")]
        assert kernel in body
        assert len(re.findall(r"\w+(?:<\w+>)?<<<", body)) == (
            2 if fn == "gt_probe_pairs" else 1)
    assert src.count("block_finish(") == 4     # its definition, 3 calls


@pytest.mark.parametrize("lanes,n,k", [(100, 7, 1000), (16, 4, 64),
                                       (1, 1, 1), (128, 33, 300),
                                       (3, 2, 257)])
def test_pairs_partition_covers_every_triple_once(lanes, n, k):
    part = pairs_partition(lanes, n, k)
    key = (part["atom"] * k + part["rec"]) * lanes + part["lane"]
    assert len(key) == n * k * lanes
    assert np.array_equal(np.sort(key), np.arange(n * k * lanes))
    plan = probes.pairs_plan(lanes, n, k)
    assert part["block"].max() < plan["blocks"]
    assert part["thread"].max() < plan["threads"]
    # a thread holds at most PAIRS_KT receptor atoms and PAIRS_LT lanes,
    # the same ones for every atom of its range
    tid = part["block"] * plan["threads"] + part["thread"]
    for col, most in (("rec", probes.PAIRS_KT), ("lane", probes.PAIRS_LT)):
        pairs = np.unique(np.stack([tid, part[col]]), axis=1)
        assert np.bincount(pairs[0]).max() <= most
    atoms = np.unique(np.stack([tid, part["atom"]]), axis=1)
    assert np.bincount(atoms[0]).max() <= plan["atoms"]


def test_pairs_plan_grid():
    plan = probes.pairs_plan(128, 32, 1280)
    assert plan["grid"] == (5, 64, 4) and plan["blocks"] == 1280
    assert plan["atoms"] == 8
    assert probes.gather_plan(4096, 20)["blocks"] == 128
    # a long ligand splits further so that a block's atoms fit 48 KB
    big = probes.pairs_plan(4, 5000, 10)
    assert big["atoms"] <= probes.PAIRS_ATOMS_MAX
    assert big["grid"][2] * big["atoms"] >= 5000
    assert (big["grid"][2] - 1) * big["atoms"] < 5000
    with pytest.raises(ValueError):
        probes.pairs_plan(0, 4, 4)


@pytest.mark.parametrize("a,reps", [(700, 3), (4096, 20), (1, 1), (129, 2),
                                    (641, 1)])
def test_gather_partition_covers_every_unit_once(a, reps):
    part = gather_partition(a, reps)
    key = part["rep"] * a + part["lookup"]
    assert np.array_equal(np.sort(key), np.arange(a * reps))
    plan = probes.gather_plan(a, reps)
    assert part["block"].max() < plan["blocks"]
    assert part["turn"].max() < probes.GATHER_UNITS
    # no block more than the work needs
    per_block = plan["threads"] * probes.GATHER_UNITS
    assert (plan["blocks"] - 1) * per_block < a * reps
    # a thread takes at most GATHER_UNITS units
    tid = part["block"] * plan["threads"] + part["thread"]
    assert np.bincount(tid).max() <= probes.GATHER_UNITS


def test_pairs_sum_in_kernel_order_equals_plain():
    lanes, n, k, reps = 100, 7, 1000, 3
    x = probes.make_inputs(11, lanes, n, k, device="cpu")
    args = (x["lig"], x["ligp"], x["rec"], x["recp"])
    e = probes.pair_energies(*args)
    mag = reps * float(e.abs().sum())
    got = float(pairs_sum_in_order(e, reps))
    ref = float(probes.probe_pairs_plain(*args, reps))
    assert abs(got - ref) <= 2e-5 * mag
    assert got != 0.0 and np.isfinite(got)


@pytest.mark.parametrize("name", ["gt_probe_pairs", "gt_probe_gather",
                                  "gt_probe_mxu", "gt_probe_empty"])
def test_bound_signatures_match_the_cuda_entry_points(name):
    """ctypes binds each probe entry point with as many arguments as the C
    function takes."""
    from gnina_tpu_torch.ops import _cuda

    class Lib:
        pass

    lib = Lib()
    for fn in ("gt_probe_pairs", "gt_probe_gather", "gt_probe_mxu",
               "gt_probe_empty", "gt_probe_error_string"):
        setattr(lib, fn, type("Fn", (), {})())
    _cuda._bind_probes(lib)
    with open(CU) as f:
        m = re.search(rf"\bint {name}\((.*?)\)\s*\{{", f.read(), re.S)
    params = [p for p in m.group(1).split(",") if p.strip()]
    assert len(getattr(lib, name).argtypes) == len(params)
