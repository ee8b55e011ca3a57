"""Seconds a docked ligand spends in the MC driver's chunks
(mc_fused.fused_mc_chunk_inkernel)."""

from dockbench.work import docked, span_s


def read(ctx):
    n = docked(ctx)
    return span_s(ctx, "mc_chunk") / n if n else None
