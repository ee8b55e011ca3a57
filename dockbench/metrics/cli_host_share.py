"""Percent of the command line's calls (the program's `cli.main` spans)
spent outside their `screen.batch` spans: the ingest, the scorer's load,
bucketing and the writer.  The program's twin of screen_host_share."""

from dockbench.program import record, spans
from dockbench.trace import busy_in, union


def read(ctx):
    snap = record(ctx)
    if snap is None:
        return None
    total = outside = 0
    for m in spans(snap, "cli.main"):
        inner = union(sorted(("", s["t0"], s["t1"])
                             for s in spans(snap, "screen.batch")
                             if s["call"] == m["call"]))
        d = m["t1"] - m["t0"]
        total += d
        outside += d - busy_in(inner, m["t0"], m["t1"])
    return 100.0 * outside / total if total > 0 else None
