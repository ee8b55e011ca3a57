"""Spans and counts from the benchmark's own side, and the device's kernel
intervals, for a traced run (`--trace 1`) only.

The port's functions are wrapped at run time by attribute replacement,
where their callers look them up: `DockingEngine.dock_batch`,
`CNNScorer.score_poses_multi` and `CNNScorer.voxelize_group` on their
classes, `mc_fused.fused_mc_chunk_inkernel` and the kernels
`fused_dock.async_mc_window` (K3), `bfgs_minimize` (K2) and `eval_fg` (K1)
on their modules.  A span synchronises the card at its end, so its host
interval holds its device work; a kernel call is only recorded (lanes,
steps, the stats it returns), never synchronised.  torch.profiler records
the card's activity alone, and one marker kernel launched on an idle card
places the device's clock on the host's.
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List

import numpy as np


class Tracer:
    def __init__(self, torch):
        self.torch = torch
        self.spans: List[tuple] = []          # (name, t0 ns, t1 ns)
        self.batches: List[dict] = []         # one per dock_batch call
        self.launches: List[dict] = []        # kernel calls
        self.scored: List[int] = []           # poses per score_poses_multi
        self._undo = []
        self.sync = (torch.cuda.synchronize if torch.cuda.is_available()
                     else (lambda: None))

    # -- wrapping --------------------------------------------------------------

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def span(self, owner, attr, name, before=None):
        sync = self.sync

        def make(orig):
            def wrapped(*a, **k):
                if before is not None:
                    before(a, k)
                t0 = time.perf_counter_ns()
                try:
                    return orig(*a, **k)
                finally:
                    sync()
                    self.spans.append((name, t0, time.perf_counter_ns()))
            return wrapped
        self._patch(owner, attr, make)

    def kernel(self, owner, attr, name):
        def make(orig):
            def wrapped(terms, rigid, tors, scal, pack, *a, **k):
                out = orig(terms, rigid, tors, scal, pack, *a, **k)
                self.launches.append(dict(
                    kernel=name, batch=len(self.batches) - 1,
                    lanes=int(rigid.shape[0]), lane_lig=pack.lane_lig,
                    steps=int(a[1]) if name == "k3" else 0,
                    stats=out[2] if name != "k1" else None))
                return out
            return wrapped
        self._patch(owner, attr, make)

    def install(self):
        from gnina_tpu_torch import cli, docking
        from gnina_tpu_torch.models import scorer
        from gnina_tpu_torch.ops import fused_dock, mc_fused

        def batch(a, k):
            ligs = a[2]
            self.batches.append(dict(names=[l.name for l in ligs],
                                     lanes=len(ligs) * a[0].settings
                                     .exhaustiveness))

        def scored(a, k):
            self.scored.append(sum(len(c) for _l, c in a[2]))

        self.span(cli, "main", "cli.main")
        self.span(docking.DockingEngine, "dock_batch", "dock_batch",
                  before=batch)
        self.span(mc_fused, "fused_mc_chunk_inkernel", "mc_chunk")
        self.span(scorer.CNNScorer, "score_poses_multi", "cnn_score",
                  before=scored)
        self.span(scorer.CNNScorer, "voxelize_group", "voxelize")
        self.kernel(fused_dock, "async_mc_window", "k3")
        self.kernel(fused_dock, "bfgs_minimize", "k2")
        self.kernel(fused_dock, "eval_fg", "k1")

    def uninstall(self):
        for owner, attr, orig in reversed(self._undo):
            setattr(owner, attr, orig)
        self._undo = []

    # -- the device's trace ------------------------------------------------------

    def start_profiler(self):
        from torch.profiler import ProfilerActivity, profile

        torch = self.torch
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self.t_marker = time.perf_counter_ns()
        torch.cuda._sleep(100000)
        torch.cuda.synchronize()

    def stop_profiler(self):
        """Kernel intervals (name, start ns, end ns) on the host's clock,
        sorted by start, the marker left out."""
        self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        from torch.autograd import DeviceType

        evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        self.prof = None
        if not evs:
            return []
        evs.sort(key=lambda e: e[1])
        off = evs[0][1] - self.t_marker
        return [(n, s - off, t - off) for n, s, t in evs[1:]]


def union(intervals: List[tuple]) -> List[tuple]:
    """Merged (start, end) of intervals sorted by start."""
    out = []
    for _n, s, t in intervals:
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1][1] = t
        else:
            out.append([s, t])
    return out


def busy_in(merged, t0: int, t1: int) -> int:
    """ns of [t0, t1] covered by the merged intervals."""
    starts = np.array([m[0] for m in merged], np.int64)
    ends = np.array([m[1] for m in merged], np.int64)
    if not len(starts):
        return 0
    return int(np.clip(np.minimum(ends, t1) - np.maximum(starts, t0), 0,
                       None).sum())


def breakdown(kernels, merged, spans, t0: int, t1: int) -> dict:
    """The ten device operations that took most time, and the ten spans in
    whose own time (not a child span's) the card idled longest."""
    by_name: Dict[str, int] = collections.Counter()
    for n, s, t in kernels:
        if t0 <= s < t1:
            by_name[n[:160]] += t - s
    ops = [[n, v / 1e9] for n, v in by_name.most_common(10)]
    idle: Dict[str, int] = collections.Counter()
    gaps = []
    prev = t0
    for s, t in merged:
        if s > prev:
            gaps.append((prev, min(s, t1)))
        prev = max(prev, t)
    if prev < t1:
        gaps.append((prev, t1))
    # innermost span around each gap's middle
    order = sorted(spans, key=lambda x: x[1])
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        inner = "outside cli.main"
        width = None
        for name, s0, s1 in order:
            if s0 > mid:
                break
            if s1 >= mid and (width is None or s1 - s0 < width):
                inner, width = name, s1 - s0
        idle[inner] += g1 - g0
    gaps_out = [[n, v / 1e9] for n, v in idle.most_common(10)]
    return dict(device_ops=ops, idle_gaps=gaps_out)
