"""Seconds of the card a docked ligand spends in the finish (the
containers' merge, the five refinement stages, K1's rescore): the device
intervals of the program's dock.finish spans over dock.ligands.  The
device twin of finish_s_per_lig."""

from dockbench.program import counter, device_s, record


def read(ctx):
    snap = record(ctx)
    if snap is None or not counter(snap, "dock.ligands"):
        return None
    dev = device_s(snap, "dock.finish")
    return dev / counter(snap, "dock.ligands") if dev is not None else None
