"""Seconds a docked ligand spends in dock_batch outside the MC chunk loop
and the CNN scorer: the pack, the merge, the five finish stages, K1's
rescore and the assembly."""

from dockbench.work import docked, span_s


def read(ctx):
    n = docked(ctx)
    if not n:
        return None
    return (span_s(ctx, "dock_batch") - span_s(ctx, "mc_chunk")
            - span_s(ctx, "cnn_score")) / n
