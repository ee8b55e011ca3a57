"""Percent of the traced window in which the card ran no kernel."""


def read(ctx):
    if not ctx.kernels:
        return None
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s)
