"""Milliseconds of the card a pose takes in the CNN rescore: the device
intervals of the program's cnn.score spans over its cnn.poses counter.
The device twin of cnn_ms_per_pose."""

from dockbench.program import counter, device_s, record


def read(ctx):
    snap = record(ctx)
    if snap is None or not counter(snap, "cnn.poses"):
        return None
    dev = device_s(snap, "cnn.score")
    return 1e3 * dev / counter(snap, "cnn.poses") if dev is not None \
        else None
