"""Sums over a traced run that several per-layer readers share: span
times, the card's time in a kernel, and each kernel call's counted
operations and least bytes (dockbench/roofline.py)."""

from __future__ import annotations

import numpy as np

from dockbench import roofline
from dockbench.trace import busy_in


def span_s(ctx, name: str) -> float:
    return sum(t1 - t0 for n, t0, t1 in ctx.tracer.spans if n == name) / 1e9


def spans(ctx, name: str):
    return [(t0, t1) for n, t0, t1 in ctx.tracer.spans if n == name]


def busy_s_in(ctx, name: str) -> float:
    return sum(busy_in(ctx.merged, t0, t1) for t0, t1 in spans(ctx, name)) \
        / 1e9


def kernel_s(ctx, key: str) -> float:
    """Seconds the card spent in kernels whose name holds `key`."""
    return sum(t - s for n, s, t in ctx.kernels if key in n) / 1e9


def docked(ctx) -> int:
    return sum(len(b["names"]) for b in ctx.tracer.batches)


def _lane_work(ctx, launch):
    names = ctx.tracer.batches[launch["batch"]]["names"]
    w = [ctx.ligand_work.get(names[int(i)]) for i in launch["lane_lig"]]
    if any(x is None for x in w):
        return None
    return w


def launch_ops(ctx, launch):
    """Counted operations of one kernel call, None without the written poses
    of its ligands."""
    w = _lane_work(ctx, launch)
    if w is None:
        return None
    pairs = np.array([x["inter"] + x["intra"] for x in w])
    s = launch["stats"]
    if launch["kernel"] == "k3":
        # a value and gradient for each candidate's start (row 4, completed
        # steps) and each accepted Armijo trial (row 3); a value for every
        # other tick (row 2, evaluations)
        derivs = s[:, 4] + s[:, 3]
        values = np.clip(s[:, 2] - derivs, 0, None)
    elif launch["kernel"] == "k2":
        # a value and gradient for the start and each accepted trial (row
        # 4); a value for every other trial (row 2)
        derivs = 1 + s[:, 4]
        values = s[:, 2] - s[:, 4]
    else:
        derivs, values = np.ones(len(w)), np.zeros(len(w))
    return roofline.eval_ops(pairs, values, derivs)


def launch_bound_s(ctx, launch):
    ops = launch_ops(ctx, launch)
    if ops is None:
        return None
    w = _lane_work(ctx, launch)
    nbytes = roofline.launch_bytes(
        ctx.rec_atoms, launch["lanes"], max(x["atoms"] for x in w),
        max(x["intra"] for x in w), max(x["torsions"] for x in w),
        launch["steps"])
    return roofline.bound_s(ops, nbytes)


def roofline_share(ctx, kernel: str, device_key: str):
    """Percent: the least time of every call of `kernel` over the card's
    time in kernels named `device_key`."""
    launches = [x for x in ctx.tracer.launches if x["kernel"] == kernel]
    dev = kernel_s(ctx, device_key)
    if not launches or dev <= 0:
        return None
    bounds = [launch_bound_s(ctx, x) for x in launches]
    if any(b is None for b in bounds):
        return None
    return 100.0 * sum(bounds) / dev
