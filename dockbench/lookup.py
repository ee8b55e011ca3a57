"""The harness's data: every cell, configuration, traffic mix, limit set
and metric is found by its name in BENCHMARK.json, in a file of its own, so
that a later change adds one by adding files.

- a configuration: the `file` its BENCHMARK.json entry names (JSON);
- a traffic mix: dockbench/traffic/<traffic>.json;
- the limits of a cell's comparison: dockbench/limits/<cell>.json;
- a metric: dockbench/metrics/<name>.py, whose `read(ctx)` returns a
  number, or None where the run gives it nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "traffic", f"{name}.json"))


def limits(cell_name: str, here: str = HERE) -> dict:
    return _json(os.path.join(here, "limits", f"{cell_name}.json"))


def metrics(bench: dict, cell_name: str, trace: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace False) or per-layer ones.  A
    metric with a `workloads` list belongs to those cells; an end-to-end
    one without belongs to every cell, a per-layer one without to every
    cell that reports the end-to-end metric it moves."""
    def listed(m):
        return cell_name in m["workloads"] if "workloads" in m else None

    e2e = [m for m in bench["end_to_end"] if listed(m) is not False]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if listed(m) or (listed(m) is None and m["moves"] in names)]


def reader(name: str, here: str = HERE) -> Callable:
    path = os.path.join(here, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"dockbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
