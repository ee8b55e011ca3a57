"""Mean lanes (ligands x exhaustiveness) of a dock_batch call, from the
program's counters dock.lanes and dock.batches: the twin of
lanes_per_dock."""

from dockbench.program import counter, record


def read(ctx):
    snap = record(ctx)
    if snap is None or not counter(snap, "dock.batches"):
        return None
    return counter(snap, "dock.lanes") / counter(snap, "dock.batches")
