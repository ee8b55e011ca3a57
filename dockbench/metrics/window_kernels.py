"""Kernels a Monte Carlo window launches: the device trace's kernels (its
memory copies and fills left out; the trace moved onto the program's
clock, dockbench/program.placed) that start inside the device intervals
of the program's dock.search spans, over the mc.windows counter."""

import numpy as np

from dockbench.program import inside, search_windows


def read(ctx):
    got = search_windows(ctx)
    if got is None:
        return None
    _snap, iv, windows, kernels, _merged = got
    starts = np.array([s for n, s, _t in kernels
                       if not n.startswith(("Memcpy", "Memset"))], np.int64)
    return float(inside(starts, iv).sum()) / windows
