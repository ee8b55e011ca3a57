"""The CNN rescore's voxeliser (k_voxelize): the least time of its bytes
over the card's time in the kernel, in percent (dockbench/voxel_work.py).
The run's cell is the one its command line names; a program without the
kernel gives nothing to read."""

import sys

from dockbench import voxel_work
from dockbench.work import kernel_s

KERNEL = "k_voxelize"


def read(ctx):
    if not getattr(ctx, "kernels", None):
        return None
    dev = kernel_s(ctx, KERNEL)
    if dev <= 0:
        return None
    bound = voxel_work.window_bound_s(ctx, sys.argv)
    return None if bound is None else 100.0 * bound / dev
