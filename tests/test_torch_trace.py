"""The port's recorder (gnina_tpu_torch/trace.py): off, every site is the
shared no-op and nothing is recorded, no clock read and no event made; on
(under a CPU torch.profiler, or for --verbosity 2), spans nest with their
parents, calls and self times, counters add, device counters sum the
tensors they hold, worker threads inherit the caller's span, the record
clears when a call turns recording on after one that had it off, spans
past the cap are counted as dropped, and the profiler sees no event of the
recorder's.  A tiny dock through the command line gives the span tree of
the screen."""

import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import cli, trace
from gnina_tpu_torch.docking import _run_shards
from gnina_tpu_torch.ops import mc_fused


@pytest.fixture(autouse=True)
def _fresh_record():
    trace.reset()
    yield
    trace.reset()


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _names(snap):
    return sorted(s["name"] for s in snap["spans"])


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("read or made while recording is off")

    monkeypatch.setattr(trace.time, "perf_counter_ns", boom)
    monkeypatch.setattr(torch.cuda, "Event", boom)
    sites = [trace.span("a"), trace.span("b", device="cpu", lanes=3),
             trace.adopt(7)]
    assert all(s is trace.NOOP for s in sites)
    with trace.span("a"):
        with trace.span("b", device="cpu"):
            trace.count("n", 4)
            trace.count_device("d", torch.ones(3))
    assert trace.current() is None
    monkeypatch.undo()
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counters"] == {}


def test_spans_nest_with_parents_calls_and_self_times():
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.command(False) as call:
            with trace.span("outer", lanes=8):
                time.sleep(0.02)
                with trace.span("inner"):
                    time.sleep(0.03)
                with trace.span("inner"):
                    time.sleep(0.01)
    with trace.command(False):
        with trace.span("outside"):       # no profiler, no table: off
            pass
    snap = trace.snapshot()
    by = {}
    for s in snap["spans"]:
        by.setdefault(s["name"], []).append(s)
    assert set(by) == {"cli.main", "outer", "inner"}
    main, outer = by["cli.main"][0], by["outer"][0]
    assert main["parent"] is None and outer["parent"] == main["id"]
    assert all(s["parent"] == outer["id"] for s in by["inner"])
    assert {s["call"] for s in snap["spans"]} == {call}
    assert outer["attrs"] == {"lanes": 8}
    assert all(s["d0"] is None for s in snap["spans"])
    inner_ns = sum(s["t1"] - s["t0"] for s in by["inner"])
    assert outer["self_ns"] == outer["t1"] - outer["t0"] - inner_ns
    assert 0.015e9 < outer["self_ns"] < outer["t1"] - outer["t0"]
    assert all(s["self_ns"] == s["t1"] - s["t0"] for s in by["inner"])
    assert main["self_ns"] == main["t1"] - main["t0"] - (
        outer["t1"] - outer["t0"])


def test_counters_and_device_counters_sum_their_references():
    t = torch.tensor([1.0, 2.0, 3.0])
    with trace.command(True) as call:
        trace.count("n")
        trace.count("n", 4)
        trace.count_device("d", t)
        trace.count_device("d", torch.tensor([[5.0], [6.0]]))
        t.add_(1.0)         # a reference: the sum is read in snapshot
    assert trace.snapshot()["counters"] == {"n": 5, "d": 9 + 11}
    with trace.command(True):
        trace.count("n", 2)
    assert trace.snapshot()["counters"]["n"] == 7
    assert trace.snapshot(call)["counters"] == {"n": 5, "d": 20}


def test_shard_threads_inherit_the_callers_span():
    seen = {}

    def fn(i):
        with trace.span("shard", i=i):
            seen[i] = threading.get_ident()
        return i

    devices = [torch.device("cpu")] * 3
    with trace.command(True):
        with trace.span("batch"):
            assert _run_shards(devices, fn) == [0, 1, 2]
    snap = trace.snapshot()
    batch = [s for s in snap["spans"] if s["name"] == "batch"][0]
    shards = [s for s in snap["spans"] if s["name"] == "shard"]
    assert len(shards) == 3
    assert all(s["parent"] == batch["id"] for s in shards)
    assert {s["thread"] for s in shards} == set(seen.values())
    assert batch["self_ns"] <= batch["t1"] - batch["t0"]


def test_the_record_clears_when_recording_turns_on_after_an_off_call():
    for name, on in (("a", True), ("b", True), (None, False), ("c", True),
                     ("d", True)):
        with trace.command(on):
            if name:
                with trace.span(name):
                    pass
            trace.count("calls")
    snap = trace.snapshot()
    assert _names(snap) == ["c", "cli.main", "cli.main", "d"]
    assert snap["counters"] == {"calls": 2}
    trace.reset()
    assert trace.snapshot()["spans"] == []


def test_spans_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(trace, "CAP", 5)
    with trace.command(True):
        for _ in range(9):
            with trace.span("s"):
                pass
    snap = trace.snapshot()
    # the first five opened are kept: cli.main and four of the nine
    assert _names(snap) == ["cli.main"] + ["s"] * 4
    assert snap["counters"]["trace.dropped"] == 5


def test_the_profiler_sees_no_event_of_the_recorder():
    names = {"cli.main", "probe.outer", "probe.inner"}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.command(False):
            with trace.span("probe.outer"):
                with trace.span("probe.inner", device="cpu"):
                    torch.ones(8).sum()
    assert {s["name"] for s in trace.snapshot()["spans"]} == names
    seen = {e.name for e in prof.events()}
    assert "aten::sum" in seen
    assert not any(n in e for n in names for e in seen)


class _Event:
    """A stand-in for a timing event: its time on the card's clock, ms."""

    def __init__(self, ms):
        self.ms = ms

    def elapsed_time(self, other):
        return other.ms - self.ms


def test_device_times_lie_on_the_line_through_two_references():
    slow = 1 - 3e-6                   # the card's clock 3 ppm slow
    ref = (_Event(100.0), 5_000_000, 10, None)
    close = (_Event(100.0 + 60_000.0 * slow), 5_000_000 + 60 * 10 ** 9, 10,
             None)
    place = trace._placer(ref, close)
    for host_s in (0.0, 1.0, 30.0, 59.5):
        ev = _Event(100.0 + host_s * 1e3 * slow)
        assert place(ev) == pytest.approx(5_000_000 + host_s * 1e9, abs=2)
    # from the first reference alone, 30 s on: 90 us early
    ev = _Event(100.0 + 30_000.0 * slow)
    assert ref[1] + ref[0].elapsed_time(ev) * 1e6 == pytest.approx(
        5_000_000 + 30 * 10 ** 9 - 90_000, abs=2)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("trace")
    lig = fx.ligand()
    rec = d / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(lig), seed=4,
                                        cube=22.0))
    with open(fx.LIGAND_SDF) as f:
        blocks = f.read().split("$$$$\n")
    one = d / "one.sdf"
    one.write_text(blocks[0] + "$$$$\n")
    two = d / "two.sdf"
    two.write_text(blocks[0] + "$$$$\n" + blocks[1] + "$$$$\n")
    return dict(rec=str(rec), one=str(one), two=str(two), out=str(d / "o"))


def test_a_screen_under_the_profiler_gives_the_span_tree(files, monkeypatch):
    monkeypatch.setenv("GNINA_TPU_FUSED_MC_STEPS", "8")
    monkeypatch.setenv("GNINA_TPU_FUSED_MC_TICK_BUDGET", "2")
    chunks = []
    orig = mc_fused.fused_mc_chunk_inkernel

    def counted(carry, gen, num_steps, fused_mc, *a, **k):
        chunks.append(num_steps // fused_mc.mc_steps)
        return orig(carry, gen, num_steps, fused_mc, *a, **k)

    monkeypatch.setattr(mc_fused, "fused_mc_chunk_inkernel", counted)
    argv = ["-r", files["rec"], "-l", files["two"], "--autobox_ligand",
            files["one"], "--cnn_scoring", "none", "--num_mc_steps", "32",
            "--exhaustiveness", "2", "--num_mc_saved", "4", "--num_modes",
            "3", "-o", files["out"] + ".sdf", "--device", "cpu", "-q"]
    with profile(activities=[ProfilerActivity.CPU]):
        assert cli.main(argv) == 0
    snap = trace.snapshot()
    by_id = {s["id"]: s for s in snap["spans"]}

    def parent(s):
        return by_id[s["parent"]]["name"] if s["parent"] else None

    tree = {(s["name"], parent(s)) for s in snap["spans"]}
    assert tree == {
        ("cli.main", None), ("cli.ingest", "cli.main"),
        ("screen.batch", "cli.main"), ("cli.write", "cli.main"),
        ("dock.pack", "screen.batch"), ("dock.search", "screen.batch"),
        ("mc.window", "dock.search"), ("mc.k3", "mc.window"),
        ("mc.fk", "mc.window"), ("mc.refine", "mc.window"),
        ("mc.merge", "mc.window"), ("dock.finish", "screen.batch"),
        ("dock.assemble", "screen.batch")}
    c = snap["counters"]
    assert c["dock.ligands"] == 2 and c["dock.batches"] == 1
    assert c["dock.lanes"] == 4
    assert chunks and c["mc.windows"] == sum(chunks)
    assert sum(s["name"] == "mc.window" for s in snap["spans"]) == \
        sum(chunks)
    assert c["mc.steps_scheduled"] == 8 * 4 * sum(chunks)
    assert 0 < c["mc.steps_completed"] <= c["mc.steps_scheduled"]
    batch = [s for s in snap["spans"] if s["name"] == "screen.batch"][0]
    assert batch["attrs"]["ligands"] == 2 and "bucket" in batch["attrs"]
    search = [s for s in snap["spans"] if s["name"] == "dock.search"][0]
    assert search["attrs"]["lanes"] == 4
    assert search["attrs"]["chunks"] == len(chunks)


def test_verbosity_2_prints_the_summary_table(files, capsys):
    argv = ["-r", files["rec"], "-l", files["one"], "--cnn_scoring", "none",
            "--score_only", "--device", "cpu", "--verbosity", "2"]
    assert cli.main(argv) == 0
    out = capsys.readouterr().out
    assert "Trace (seconds" in out
    head = out[out.index("Trace (seconds"):].splitlines()
    assert head[1].split() == ["span", "count", "total", "self", "device"]
    rows = {r.split()[0]: r.split()[1:] for r in head[2:] if r.strip()}
    assert rows["cli.main"][0] == "1" and rows["cli.ingest"][0] == "1"
    assert rows["cli.main"][3] == "-"
    # no table without --verbosity 2, and nothing recorded
    trace.reset()
    argv[-1] = "1"
    assert cli.main(argv) == 0
    assert "Trace (seconds" not in capsys.readouterr().out
    assert trace.snapshot()["spans"] == []


def test_a_dock_counts_the_cards_k3_slots(files, monkeypatch):
    """dock_batch counts screen.slots, the K3 pose blocks resident on its
    cards (SMs x blocks an SM x the mesh's cards), beside dock.lanes; none
    where the occupancy is unknown (the CPU) or K3 does not run."""
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.docking import DockingEngine, DockSettings
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.parallel.mesh import Mesh

    rec = ingest.Receptor.from_file(files["rec"])
    lig = fx.ligand()
    center, size = ingest.autobox_ligand(files["one"])
    kw = dict(cnn_scoring="none", num_mc_steps=8, exhaustiveness=2,
              num_mc_saved=2, num_modes=2, minimize_iters=2)

    def counters(mesh=None, **extra):
        eng = DockingEngine(DockSettings(**kw, **extra), device="cpu")
        with trace.command(True):
            eng.dock_batch(rec, [lig, lig], center, size, seed=1, mesh=mesh)
        c = trace.snapshot()["counters"]
        trace.reset()
        return c

    assert "screen.slots" not in counters()
    monkeypatch.setattr(fd, "k3_occupancy", lambda dev, smem: (66, 2))
    c = counters(mesh=Mesh.of(["cpu", "cpu"]))
    assert c["screen.slots"] == 2 * 132 and c["dock.lanes"] == 4
    assert c["dock.batches"] == 1
    assert "screen.slots" not in counters(fused_mc_in_kernel=False)
