"""Percent of the command line's calls spent outside dock_batch: argument
parsing, the receptor and ligand ingest, the scorer's load, bucketing and
the SDF writer."""

from dockbench.work import span_s


def read(ctx):
    total = span_s(ctx, "cli.main")
    if total <= 0:
        return None
    return 100.0 * (total - span_s(ctx, "dock_batch")) / total
