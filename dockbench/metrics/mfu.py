"""The whole step's share of the card's float32 peak, in percent: the
counted operations of every K1, K2 and K3 call and of the CNN forwards of
every pose scored, over the traced window at 67 TFLOP/s."""

from dockbench import roofline
from dockbench.work import launch_ops


def read(ctx):
    if not ctx.kernels:
        return None
    ops = [launch_ops(ctx, x) for x in ctx.tracer.launches]
    if any(o is None for o in ops):
        return None
    total = sum(ops) + ctx.cnn_flops_per_pose * sum(ctx.tracer.scored)
    return 100.0 * total / (ctx.window_s * roofline.FP32_PEAK)
