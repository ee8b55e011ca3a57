"""Milliseconds a Monte Carlo window leaves the card idle: the time inside
the device intervals of the program's dock.search spans in which the
device trace (moved onto the program's clock: dockbench/program.placed)
holds no operation, over the mc.windows counter."""

from dockbench.program import gaps_in, search_windows


def read(ctx):
    got = search_windows(ctx)
    if got is None:
        return None
    _snap, iv, windows, _kernels, merged = got
    g = gaps_in(merged, iv)
    return float((g[:, 1] - g[:, 0]).sum()) / 1e6 / windows
