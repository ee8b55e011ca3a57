"""Percent of the CNN rescore's device time spent voxelizing: the device
intervals of the program's cnn.voxelize spans over those of cnn.score.
The device twin of voxelize_share."""

from dockbench.program import device_s, record


def read(ctx):
    snap = record(ctx)
    if snap is None:
        return None
    score = device_s(snap, "cnn.score")
    vox = device_s(snap, "cnn.voxelize")
    if not score or vox is None:
        return None
    return 100.0 * vox / score
