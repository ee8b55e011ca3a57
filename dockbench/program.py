"""The program's own record of a traced run: the port's recorder
(gnina_tpu_torch.trace) holds the spans and counters of the window's
command-line calls, since the profiler's session turns it on for each
call and the first such call clears what the warm-up left.  `record`
takes its snapshot once a run and keeps it on ctx; the helpers below are
what the per-layer readers of the program's spans share.  A program
without the recorder, or a run in which it recorded nothing, gives None.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from dockbench.trace import union


def record(ctx) -> Optional[dict]:
    if not hasattr(ctx, "program"):
        ctx.program = None
        try:
            from gnina_tpu_torch import trace
        except ImportError:
            return None
        snap = trace.snapshot()
        if snap["spans"]:
            ctx.program = snap
    return ctx.program


def counter(snap: dict, name: str) -> Optional[int]:
    return snap["counters"].get(name)


def spans(snap: dict, name: str) -> List[dict]:
    return [s for s in snap["spans"] if s["name"] == name]


def device_intervals(snap: dict, name: str) -> List[Tuple[int, int]]:
    """(start, end) ns on the host's clock of the spans' device intervals."""
    return [(s["d0"], s["d1"]) for s in spans(snap, name)
            if s["d0"] is not None]


def device_s(snap: dict, name: str) -> Optional[float]:
    iv = device_intervals(snap, name)
    return sum(b - a for a, b in iv) / 1e9 if iv else None


def gaps_in(merged, intervals) -> np.ndarray:
    """(n, 2) ns: the parts of the intervals in which the card ran nothing,
    from the merged kernel intervals (dockbench/trace.union)."""
    starts = np.array([m[0] for m in merged], np.int64)
    ends = np.array([m[1] for m in merged], np.int64)
    out = []
    for a, b in intervals:
        i0 = int(np.searchsorted(ends, a, side="right"))
        i1 = int(np.searchsorted(starts, b, side="left"))
        s = np.clip(starts[i0:i1], a, b)
        e = np.clip(ends[i0:i1], a, b)
        g0 = np.concatenate([[a], e])
        g1 = np.concatenate([s, [b]])
        keep = g1 > g0
        out.append(np.stack([g0[keep], g1[keep]], 1))
    return np.concatenate(out) if out else np.zeros((0, 2), np.int64)


def inside(points: np.ndarray, intervals) -> np.ndarray:
    """Which points lie in one of the intervals, which do not overlap."""
    iv = np.array(sorted(intervals), np.int64).reshape(-1, 2)
    if not len(iv) or not len(points):
        return np.zeros(len(points), bool)
    k = np.searchsorted(iv[:, 0], points, side="right") - 1
    ok = k >= 0
    ok[ok] = points[ok] <= iv[k[ok], 1]
    return ok


K3 = "k_async_mc"
NEAR = 4


def placed(ctx, snap: dict):
    """(kernels, merged): the run's device trace (ctx.kernels) moved onto
    the program's clock, or None without one K3 kernel a window.

    The trace's own placement rests on one marker kernel at the profiler's
    start; against the host's clock it is off by up to 0.14 s and drifts
    by milliseconds within a call (PERF.md).  Each K3 kernel runs inside
    one mc.window span, between the window's entry and exit events, and
    starts within microseconds of the entry whenever the card was still
    busy as the window opened.  So a window's stretch of the trace is
    moved by the least lead of a K3 start over its window's entry among
    the NEAR windows of the same call on either side, of those leads that
    keep the window's own K3 before its exit event; a K3 kernel takes its
    window's move, another kernel that of the last window whose entry
    precedes it (near a jump of the trace's clock, possibly the next
    window's)."""
    if hasattr(ctx, "program_trace"):
        return ctx.program_trace
    ctx.program_trace = None
    kernels = getattr(ctx, "kernels", None)
    if not kernels:
        return None
    k3 = np.array(sorted((s, t) for n, s, t in kernels if K3 in n),
                  np.int64).reshape(-1, 2)
    win = sorted((s["d0"], s["d1"], s["call"])
                 for s in spans(snap, "mc.window") if s["d0"] is not None)
    if not win or len(k3) != len(win):
        return None
    d0 = np.array([w[0] for w in win], np.int64)
    d1 = np.array([w[1] for w in win], np.int64)
    call = np.array([w[2] for w in win])
    lead = k3[:, 0] - d0
    least = k3[:, 1] - d1           # the least move that ends K3 by d1
    move = np.empty_like(lead)
    for i in range(len(win)):
        j = np.arange(max(i - NEAR, 0), min(i + NEAR + 1, len(win)))
        near = lead[j[call[j] == call[i]]]
        move[i] = near[near >= least[i]].min()
    starts = np.array([s for _n, s, _t in kernels], np.int64)
    by = move[np.maximum(np.searchsorted(d0 + move, starts, side="right")
                         - 1, 0)]
    is_k3 = np.array([K3 in n for n, _s, _t in kernels])
    by[is_k3] = move[np.searchsorted(k3[:, 0], starts[is_k3])]
    moved = sorted(((n, int(s - m), int(t - m))
                    for (n, s, t), m in zip(kernels, by)),
                   key=lambda x: x[1])
    ctx.program_trace = (moved, union(moved))
    return ctx.program_trace


def search_windows(ctx):
    """(snapshot, device intervals of dock.search, MC windows, kernels and
    merged kernel intervals on the program's clock) of a traced run on the
    card, or None."""
    snap = record(ctx)
    if snap is None:
        return None
    iv = device_intervals(snap, "dock.search")
    windows = counter(snap, "mc.windows")
    trace = placed(ctx, snap)
    if not iv or not windows or trace is None:
        return None
    return snap, iv, windows, trace[0], trace[1]
