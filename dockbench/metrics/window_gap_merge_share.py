"""Percent of window_gap_ms's idle time charged to the container merge:
an idle gap inside dock.search's device intervals (the device trace moved
onto the program's clock, dockbench/program.placed) counts here when its
midpoint lies in one of the program's mc.merge host spans, the midpoint
rule of dockbench/trace.breakdown."""

from dockbench.program import gaps_in, inside, search_windows, spans


def read(ctx):
    got = search_windows(ctx)
    if got is None:
        return None
    snap, iv, _windows, _kernels, merged = got
    g = gaps_in(merged, iv)
    total = float((g[:, 1] - g[:, 0]).sum())
    if total <= 0:
        return None
    merge = [(s["t0"], s["t1"]) for s in spans(snap, "mc.merge")]
    mid = (g[:, 0] + g[:, 1]) // 2
    hit = inside(mid, merge)
    return 100.0 * float((g[hit, 1] - g[hit, 0]).sum()) / total
