"""Milliseconds of the CNN rescore (CNNScorer.score_poses_multi) per pose
scored."""

from dockbench.work import span_s


def read(ctx):
    n = sum(ctx.tracer.scored)
    return 1e3 * span_s(ctx, "cnn_score") / n if n else None
