"""The harness (dockbench/run.py, lookup.py): a configuration, traffic mix,
limit set or metric added as a file is found by its name with no edit; a
rehearsal on the CPU, through the port's plain versions, loads no module
of the JAX package; and with the timed path broken underneath, each fault
a screen can have makes `correct` come out false (the run's look for a
card is skipped: the CPU runs the plain versions at a small size)."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from dockbench import lookup  # noqa: E402

torch.set_num_threads(2)

TINY = '''
def shrink(cfg, traffic):
    cfg, traffic = dict(cfg), dict(traffic)
    f = list(cfg["flags"])
    f[f.index("--exhaustiveness") + 1] = "1"
    f[f.index("--num_mc_steps") + 1] = "2"
    f[f.index("--num_modes") + 1] = "3"
    cfg["flags"] = f + ["--num_mc_saved", "4"]
    cfg["check"] = dict(cfg["check"], num_modes=3)
    traffic.update(ligands_per_call=2, rounds_in_pool=1, warmup_mc_steps=2)
    traffic["receptor"] = dict(traffic["receptor"], cube=26.0)
    return cfg, traffic
'''
exec(TINY)


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "repo"
    here = root / "dockbench"
    for sub in ("configs", "traffic", "limits", "metrics"):
        (here / sub).mkdir(parents=True)
    bench = lookup.benchmark()
    bench["configs"].append(dict(bench["configs"][0], name="new_cfg",
                                 file="dockbench/configs/new_cfg.json"))
    bench["workloads"].append(dict(name="new_cfg.new_mix", config="new_cfg",
                                   traffic="new_mix", chips=1, why="x"))
    bench["end_to_end"].append(dict(name="new_e2e", unit="s",
                                    better="lower", bound=0.1,
                                    source="host_clock",
                                    workloads=["new_cfg.new_mix"]))
    bench["per_layer"].append(dict(name="new_layer", unit="%",
                                   better="higher", source="program_span",
                                   layer="engine", moves="new_e2e"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (here / "configs" / "new_cfg.json").write_text('{"flags": ["--x"]}')
    (here / "traffic" / "new_mix.json").write_text('{"ligands_per_call": 3}')
    (here / "limits" / "new_cfg.new_mix.json").write_text('{"pose_gap": 1}')
    (here / "metrics" / "new_layer.py").write_text(
        "def read(ctx):\n    return ctx.value * 2\n")
    b = lookup.benchmark(str(root))
    cell = lookup.cell(b, "new_cfg.new_mix")
    assert lookup.config(b, cell["config"], str(root)) == {"flags": ["--x"]}
    assert lookup.traffic(cell["traffic"], str(here)) == \
        {"ligands_per_call": 3}
    assert lookup.limits(cell["name"], str(here)) == {"pose_gap": 1}
    e2e = [m["name"] for m in lookup.metrics(b, cell["name"], False)]
    assert "new_e2e" in e2e and "setup_s" in e2e
    layer = [m["name"] for m in lookup.metrics(b, cell["name"], True)]
    assert layer == ["new_layer"]
    assert lookup.reader("new_layer", str(here))(
        type("C", (), {"value": 21})()) == 42
    # the existing cells keep their metrics
    assert "new_layer" not in [m["name"] for m in lookup.metrics(
        b, "vina_nocnn.screen", True)]


def test_cpu_rehearsal_loads_no_jax_module():
    code = TINY + f'''
import sys, json
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads(2)
from dockbench import run
out = run.run("vina_nocnn.screen", 2 ** 31 + 3, 0.0, True, device="cpu",
              shrink=shrink)
print(json.dumps(dict(found=run.forbidden_modules(),
                      correct=out["result"]["correct"],
                      metrics=sorted(out["result"]["metrics"]))))
'''
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["found"] == []
    assert res["correct"] is True
    assert "lanes_per_dock" in res["metrics"]


def _fault(kind, monkeypatch):
    def plant(cli):
        from gnina_tpu_torch.docking import DockingEngine

        orig = DockingEngine.dock_batch

        def broken(self, rec, ligs, center, size, seed=None, mesh=None):
            res = orig(self, rec, ligs, center, size, seed=seed, mesh=mesh)
            if kind == "unchanged":
                # the search's state comes back as it went in
                for lig, rs in zip(ligs, res):
                    for r in rs:
                        r.coords = lig.orig_coords.copy()
            elif kind == "half_left_out":
                res = res[:len(res) // 2] + [[] for _ in res[len(res) // 2:]]
            elif kind == "affinity_altered":
                res[0][0].energy += 0.1
            elif kind == "pose_altered":
                res[0][0].coords = res[0][0].coords.copy()
                res[0][0].coords[0] += [0.1, 0.0, 0.0]
            return res

        monkeypatch.setattr(DockingEngine, "dock_batch", broken)
    return plant


@pytest.mark.parametrize("kind", ["unchanged", "half_left_out",
                                  "affinity_altered", "pose_altered"])
def test_a_broken_timed_path_is_not_correct(kind, monkeypatch):
    from dockbench import run

    out = run.run("vina_nocnn.screen", 2 ** 31 + 11, 0.0, False,
                  device="cpu", shrink=shrink, fault=_fault(kind,
                                                            monkeypatch))
    assert out["result"]["correct"] is False, out["rows"]


def test_the_control_is_not_correct():
    """The control at a small size on the CPU (coordinates and the Vina
    affinity in bfloat16; TF32 exists on the card only, so the CNN's
    control runs in dockbench/control.py there)."""
    from dockbench import run

    out = run.run("vina_nocnn.screen", 2 ** 31 + 13, 0.0, False,
                  device="cpu", shrink=shrink, control=True)
    assert out["result"]["correct"] is True, out["rows"]
    assert out["control"][0] is False, out["control"][1]
