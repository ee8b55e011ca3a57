"""Percent of the CNN rescore spent voxelizing (CNNScorer.voxelize_group)."""

from dockbench.work import span_s


def read(ctx):
    total = span_s(ctx, "cnn_score")
    return 100.0 * span_s(ctx, "voxelize") / total if total > 0 else None
