"""K2 (k_bfgs), the in-loop refines and the finish stages: the least time
of its counted work over its time on the card, in percent."""

from dockbench.work import roofline_share


def read(ctx):
    return roofline_share(ctx, "k2", "k_bfgs")
