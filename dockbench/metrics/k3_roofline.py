"""K3 (k_async_mc): the least time of its counted work over its time on
the card, in percent (dockbench/roofline.py)."""

from dockbench.work import roofline_share


def read(ctx):
    return roofline_share(ctx, "k3", "k_async_mc")
