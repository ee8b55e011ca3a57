"""Percent of the MC driver's chunk time in which the card ran nothing:
the host's share of the search."""

from dockbench.work import busy_s_in, span_s


def read(ctx):
    total = span_s(ctx, "mc_chunk")
    if total <= 0 or not ctx.kernels:
        return None
    return 100.0 * (1.0 - busy_s_in(ctx, "mc_chunk") / total)
