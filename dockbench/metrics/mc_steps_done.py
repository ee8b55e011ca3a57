"""Percent of the Monte Carlo steps scheduled in the program's windows
that completed (its counters mc.steps_completed, K3's stats row 4, over
mc.steps_scheduled): the twin of k3_steps_done."""

from dockbench.program import counter, record


def read(ctx):
    snap = record(ctx)
    if snap is None or not counter(snap, "mc.steps_scheduled"):
        return None
    return 100.0 * counter(snap, "mc.steps_completed") / counter(
        snap, "mc.steps_scheduled")
