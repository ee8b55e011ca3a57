"""Percent of the Monte Carlo steps scheduled in K3's windows that
completed within the tick budget (stats row 4 over steps x lanes)."""


def read(ctx):
    ls = [x for x in ctx.tracer.launches if x["kernel"] == "k3"]
    sched = sum(x["steps"] * x["lanes"] for x in ls)
    if not sched:
        return None
    return 100.0 * sum(float(x["stats"][:, 4].sum()) for x in ls) / sched
