"""Seconds of the card a docked ligand spends in the MC search: the device
intervals of the program's dock.search spans (the chunk loop of a shard)
over its dock.ligands counter.  The device twin of search_s_per_lig."""

from dockbench.program import counter, device_s, record


def read(ctx):
    snap = record(ctx)
    if snap is None or not counter(snap, "dock.ligands"):
        return None
    dev = device_s(snap, "dock.search")
    return dev / counter(snap, "dock.ligands") if dev is not None else None
