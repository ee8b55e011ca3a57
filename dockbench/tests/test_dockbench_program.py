"""The readers of the program's own record (dockbench/program.py and the
metrics that read it), on a synthetic snapshot and kernel list: the idle
gaps inside dock.search's device intervals, charged to mc.merge by their
midpoints; kernels counted by where they start; the counters' ratios;
None where the record is empty or the program has no recorder."""

import os
import sys
import types

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import lookup  # noqa: E402
from dockbench.trace import union  # noqa: E402

PROGRAM = ["cli_host_share", "batch_lanes", "search_dev_s_per_lig",
           "window_gap_ms", "window_kernels", "window_gap_merge_share",
           "mc_steps_done", "finish_dev_s_per_lig", "cnn_dev_ms_per_pose",
           "voxelize_dev_share"]


def _span(i, name, t0, t1, d=None, parent=None, call=1):
    return dict(id=i, parent=parent, call=call, name=name, t0=t0, t1=t1,
                thread=0, attrs={}, d0=d[0] if d else None,
                d1=d[1] if d else None, self_ns=None)


def _ctx(offset=0):
    """One call: a batch whose search's device interval is [1000, 2000] ns
    and holds two windows, each with its K3 kernel; the kernels leave
    three gaps there: [1000, 1100] (midpoint in the first mc.merge span),
    [1300, 1500] (midpoint 1400, in no merge span) and [1900, 2000] (in
    the second merge span).  offset: the device trace's placement off by
    so many ns."""
    spans = [
        _span(1, "cli.main", 0, 10000),
        _span(2, "screen.batch", 500, 8500, parent=1),
        _span(3, "dock.search", 900, 2100, d=(1000, 2000), parent=2),
        _span(10, "mc.window", 950, 1500, d=(1000, 1500), parent=3),
        _span(11, "mc.window", 1500, 2050, d=(1500, 2000), parent=3),
        _span(4, "mc.merge", 1000, 1120, parent=10),
        _span(5, "mc.merge", 1850, 1990, parent=11),
        _span(6, "dock.finish", 2100, 2600, d=(2050, 2550), parent=2),
        _span(7, "cnn.score", 3000, 4000, d=(3000, 3800), parent=2),
        _span(8, "cnn.voxelize", 3100, 3300, d=(3100, 3300), parent=7),
        _span(9, "cnn.voxelize", 3400, 3500, d=(3400, 3500), parent=7),
    ]
    counters = {"dock.batches": 2, "dock.lanes": 128, "dock.ligands": 4,
                "mc.windows": 2, "mc.steps_scheduled": 1000,
                "mc.steps_completed": 437, "cnn.poses": 8}
    kernels = [("before", 800, 1000), ("k_async_mc", 1100, 1300),
               ("k_async_mc", 1500, 1600), ("Memcpy HtoD", 1600, 1650),
               ("small", 1640, 1900), ("after", 2000, 2200)]
    kernels = [(n, s + offset, t + offset) for n, s, t in kernels]
    return types.SimpleNamespace(
        program=dict(spans=spans, counters=counters, kernel_launches={},
                     clock_err_ns=5),
        kernels=kernels, merged=union(kernels))


def read(name, ctx):
    return lookup.reader(name)(ctx)


def test_window_gaps_and_their_share_charged_to_the_merge():
    ctx = _ctx()
    # 100 + 200 + 100 ns idle over 2 windows
    assert read("window_gap_ms", ctx) == pytest.approx(400 / 1e6 / 2)
    # the gaps whose midpoints lie in an mc.merge span: 100 + 100 of 400
    assert read("window_gap_merge_share", ctx) == pytest.approx(50.0)


def test_a_gap_counts_by_its_midpoint_not_its_overlap():
    ctx = _ctx()
    # the first merge span now ends before the first gap's midpoint
    # (1050), though it still covers most of the gap
    first = [s for s in ctx.program["spans"] if s["id"] == 4][0]
    first["t1"] = 1049
    assert read("window_gap_merge_share", ctx) == pytest.approx(25.0)
    first["t1"] = 1050
    assert read("window_gap_merge_share", ctx) == pytest.approx(50.0)


def test_kernels_count_by_where_they_start():
    ctx = _ctx()
    # the K3 kernels and small start inside [1000, 2000]; "before" ends
    # at its start and "after" starts at its end, which is inside; the
    # copy is not a kernel
    assert read("window_kernels", ctx) == pytest.approx(4 / 2)
    ctx = _ctx()
    ctx.kernels = [k for k in ctx.kernels if k[0] != "after"]
    assert read("window_kernels", ctx) == pytest.approx(3 / 2)


@pytest.mark.parametrize("offset", [-88_000_000, -3_000, 2_500_000])
def test_the_device_trace_is_moved_onto_the_programs_clock(offset):
    """The trace's placement off by milliseconds changes nothing: the
    second K3 kernel starts at its window's entry event (the least lead),
    which sets the move."""
    for name in ("window_gap_ms", "window_kernels",
                 "window_gap_merge_share"):
        assert read(name, _ctx(offset)) == pytest.approx(read(name, _ctx()))
    ctx = _ctx(offset)
    assert read("window_gap_ms", ctx) is not None
    assert ctx.program_trace[0][1] == ("k_async_mc", 1100, 1300)


def test_a_drifting_trace_is_moved_window_by_window():
    """Three calls of 30 windows of 1,000 ns; the trace is off by -85,000
    ns in the first, by -3,000 ns drifting 10 ns a window in the second,
    and in the third by -3,000 ns that jumps to -3,150 at window 15.  Every
    third K3 kernel (800 ns) starts at its window's entry, the others 30
    ns later.  Moved, each kernel lies within the drift of NEAR windows of
    where it ran, and each K3 inside its window."""
    from dockbench import program

    spans, true, seen = [], [], []
    for c, (off, drift, jump) in enumerate(((-85_000, 0, 0), (-3_000, 10, 0),
                                            (-3_000, 0, 150))):
        main = 100 + c
        spans.append(_span(main, "cli.main", c * 10 ** 6 - 500,
                           c * 10 ** 6 + 40_000, call=main))
        for i in range(30):
            d0 = c * 10 ** 6 + 1000 * i
            spans.append(_span(1000 * main + i, "mc.window", d0, d0 + 1000,
                               d=(d0, d0 + 1000), call=main))
            lam = 0 if i % 3 == 0 else 30
            e = off + drift * i - (jump if i >= 15 else 0)
            for name, s0, s1 in (("k_async_mc", lam, lam + 800),
                                 ("merge", 960, 990)):
                tag = f"{name} {c} {i}"
                true.append((tag, d0 + s0, d0 + s1))
                seen.append((tag, d0 + s0 + e, d0 + s1 + e))
    ctx = types.SimpleNamespace(
        program=dict(spans=spans, counters={}, kernel_launches={},
                     clock_err_ns=5),
        kernels=sorted(seen, key=lambda k: k[1]))
    moved, _merged = program.placed(ctx, ctx.program)
    at = {k[0]: k for k in moved}
    err = [at[t[0]][1] - t[1] for t in true]
    assert err[:60] == [0] * 60             # the first call: no drift
    assert max(abs(x) for x in err[60:120]) <= program.NEAR * 10
    # across the jump a K3 kernel errs by less than its window's slack;
    # another kernel at the end of the window before the jump may take the
    # next window's move, off by the jump
    tail = [(t[0], x) for t, x in zip(true[120:], err[120:])]
    assert max(abs(x) for n, x in tail if n.startswith("k_async")) < 170
    assert max(abs(x) for _n, x in tail) <= 150
    k3 = sorted(k for k in moved if k[0].startswith("k_async_mc"))
    win = sorted((s["d0"], s["d1"]) for s in spans if s["name"] == "mc.window")
    k3.sort(key=lambda k: k[1])
    assert all(w0 <= k[1] and k[2] <= w1 for k, (w0, w1) in zip(k3, win))


def test_no_window_metric_without_one_k3_kernel_a_window():
    ctx = _ctx()
    ctx.kernels = [k for k in ctx.kernels if k[1] != 1500]
    for n in ("window_gap_ms", "window_kernels", "window_gap_merge_share"):
        assert read(n, ctx) is None


def test_counters_and_device_times():
    ctx = _ctx()
    assert read("batch_lanes", ctx) == 64
    assert read("mc_steps_done", ctx) == pytest.approx(43.7)
    assert read("search_dev_s_per_lig", ctx) == pytest.approx(1000 / 4e9)
    assert read("finish_dev_s_per_lig", ctx) == pytest.approx(500 / 4e9)
    assert read("cnn_dev_ms_per_pose", ctx) == pytest.approx(800 / 8e6)
    assert read("voxelize_dev_share", ctx) == pytest.approx(37.5)
    # 10000 ns of cli.main, 8000 of them in screen.batch
    assert read("cli_host_share", ctx) == pytest.approx(20.0)


def test_none_on_an_empty_record():
    ctx = _ctx()
    ctx.program = None
    assert all(read(n, ctx) is None for n in PROGRAM)
    # a record without the device trace gives no window metric
    ctx = _ctx()
    ctx.kernels = []
    for n in ("window_gap_ms", "window_kernels", "window_gap_merge_share"):
        assert read(n, ctx) is None
    # nor without device intervals (a run on the CPU)
    ctx = _ctx()
    for s in ctx.program["spans"]:
        s["d0"] = s["d1"] = None
    for n in ("window_gap_ms", "search_dev_s_per_lig", "voxelize_dev_share",
              "cnn_dev_ms_per_pose", "finish_dev_s_per_lig"):
        assert read(n, ctx) is None


def test_none_from_a_program_without_the_recorder(monkeypatch):
    import gnina_tpu_torch

    monkeypatch.setitem(sys.modules, "gnina_tpu_torch.trace", None)
    monkeypatch.delattr(gnina_tpu_torch, "trace", raising=False)
    ctx = types.SimpleNamespace(kernels=[("k", 0, 1)], merged=[[0, 1]])
    assert all(read(n, ctx) is None for n in PROGRAM)
