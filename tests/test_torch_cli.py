"""The port's command line (python -m gnina_tpu_torch) against the JAX
package's: the same flags and defaults, the same log lines within the
printed precision on the in-repo fixture (the minout.sdf ligand in a
synthetic receptor written to tmp_path), the screen with its checkpoint,
and the refusals.  Everything runs with --device cpu (the kernels' plain
versions); card-only cases are in test_torch_kernels_cuda.py.
"""

import argparse
import dataclasses
import re

import numpy as np
import pytest
import torch

from gnina_tpu import cli as jcli
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import cli as tcli
from gnina_tpu_torch.docking import DockSettings, batch_ligands

NUM = re.compile(r"-?\d+\.\d+")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    lig = fx.ligand()
    rec = d / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(lig), seed=4,
                                        cube=22.0))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    one = d / "one.sdf"
    one.write_text(first)
    three = d / "three.sdf"
    names = ["ligA", "ligB", "ligC"]
    three.write_text("".join(n + first[first.index("\n"):] for n in names))
    return dict(dir=d, rec=str(rec), one=str(one), three=str(three),
                names=names)


def run(mod, argv, log):
    rc = mod.main(argv + ["--log", str(log), "-q"])
    return rc, log.read_text()


def numbers(line):
    return [float(x) for x in NUM.findall(line)]


# ------------------------------------------------------------- parser ----

def _options(parser):
    return {a.option_strings[0]: a for a in parser._actions
            if a.option_strings}


def test_parsers_have_the_same_flags_and_defaults():
    """Every option string of the JAX parser, with the same default, type,
    choices and destination.  The one difference is --device: a torch
    device (default: the card) where the JAX flag takes gnina's GPU number
    and ignores it."""
    jo, to = _options(jcli.build_parser()), _options(tcli.build_parser())
    assert set(jo) == set(to)
    for key, ja in jo.items():
        ta = to[key]
        assert sorted(ja.option_strings) == sorted(ta.option_strings), key
        assert ja.dest == ta.dest and type(ja) is type(ta), key
        if key in ("--device", "--version"):
            continue
        assert ja.default == ta.default, key
        assert ja.type == ta.type and ja.choices == ta.choices, key
    assert to["--device"].default is None and to["--device"].type is None
    args = tcli.build_parser().parse_args(["--cnn_rotation", "3"])
    assert args.cnn_rotations == 3


def test_config_file_and_tee(files, capsys):
    cfg = files["dir"] / "opts.txt"
    cfg.write_text("# options\nexhaustiveness = 3\nscore_only\n")
    p = tcli.build_parser()
    argv = tcli.parse_config_file(str(cfg), p, ["--seed", "2"])
    assert argv == jcli.parse_config_file(str(cfg), jcli.build_parser(),
                                          ["--seed", "2"])
    args = p.parse_args(argv)
    assert args.exhaustiveness == 3 and args.score_only and args.seed == 2
    logf = files["dir"] / "tee.log"
    tee = tcli.Tee(str(logf), quiet=False)
    tee.write("hello\n")
    tee.close()
    assert logf.read_text() == "hello\n"
    assert capsys.readouterr().out == "hello\n"


# ---------------------------------------------------- modes against JAX ----

def test_score_only_log_lines_equal_jax(files):
    """--score_only: the same lines, every printed number within 1e-3 (five
    decimals are printed; the float32 sums differ in the fifth)."""
    argv = ["-r", files["rec"], "-l", files["one"], "--score_only",
            "--cnn_scoring", "none"]
    out = files["dir"] / "t_score.sdf"
    rc_t, t = run(tcli, argv + ["--device", "cpu", "-o", str(out)],
                  files["dir"] / "t_score.log")
    rc_j, j = run(jcli, argv, files["dir"] / "j_score.log")
    assert rc_t == rc_j == 0
    tl = [x for x in t.splitlines() if not x.startswith("Loop time")]
    jl = [x for x in j.splitlines() if not x.startswith("Loop time")]
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert NUM.sub("#", a) == NUM.sub("#", b)
        np.testing.assert_allclose(numbers(a), numbers(b), atol=1e-3,
                                   rtol=1e-5)
    assert any(x.startswith("Affinity:") for x in tl)
    assert any(x.startswith("Term values, before weighting:") for x in tl)
    text = out.read_text()
    assert text.count("$$$$") == 1 and ">  <minimizedAffinity>" in text
    assert "CNNscore" not in text


def test_minimize_log_lines_equal_jax(files):
    """--minimize (force cap 10, accurate line search, to convergence): the
    same lines; affinity and intramolecular energy within 0.05 kcal/mol
    and RMSD within 0.1 A (two float32 searches of some hundred iterations
    end in one basin, not at one point; measured 1e-3 and 1e-2)."""
    argv = ["-r", files["rec"], "-l", files["one"], "--minimize",
            "--cnn_scoring", "none"]
    out = files["dir"] / "t_min.sdf"
    rc_t, t = run(tcli, argv + ["--device", "cpu", "-o", str(out)],
                  files["dir"] / "t_min.log")
    rc_j, j = run(jcli, argv, files["dir"] / "j_min.log")
    assert rc_t == rc_j == 0
    tl = [x for x in t.splitlines() if not x.startswith("Loop time")]
    jl = [x for x in j.splitlines() if not x.startswith("Loop time")]
    assert [NUM.sub("#", x) for x in tl] == [NUM.sub("#", x) for x in jl]
    for a, b in zip(tl, jl):
        tol = 0.1 if a.startswith("RMSD") else 0.05
        np.testing.assert_allclose(numbers(a), numbers(b), atol=tol)
    text = out.read_text()
    assert ">  <RMSD>" in text and ">  <minimizedAffinity>" in text


def test_randomize_only_and_local_only(files):
    argv = ["-r", files["rec"], "-l", files["one"], "--cnn_scoring", "none",
            "--device", "cpu"]
    out = files["dir"] / "rand.sdf"
    rc, log = run(tcli, argv + ["--randomize_only", "--num_modes", "2", "-o",
                                str(out)], files["dir"] / "rand.log")
    assert rc == 0 and log.count("Clash penalty:") == 2
    assert out.read_text().count("$$$$") == 2
    rc, log = run(tcli, argv + ["--local_only", "--minimize_iters", "2"],
                  files["dir"] / "local.log")
    assert rc == 0 and "Affinity:" in log and "RMSD:" in log


# ------------------------------------------------------------ the screen ----

DOCK = ["--cnn_scoring", "none", "--num_mc_steps", "16", "--exhaustiveness",
        "2", "--num_mc_saved", "4", "--num_modes", "3", "--device", "cpu"]


def test_tiny_screen_writes_blocks_and_tags(files, monkeypatch):
    """A dock of three ligands through the screen: one table per ligand in
    input order, as many SDF blocks as poses listed, each tagged; the
    .partial checkpoint is gone at the end; GNINA_TPU_FUSED_DONE_FRAC
    reaches the engine's settings."""
    seen = {}
    real = tcli.DockingEngine

    def spy(settings, **kw):
        seen["settings"] = settings
        return real(settings, **kw)

    monkeypatch.setattr(tcli, "DockingEngine", spy)
    monkeypatch.setenv("GNINA_TPU_FUSED_DONE_FRAC", "0.9")
    out = files["dir"] / "dock.sdf"
    rc, log = run(tcli, ["-r", files["rec"], "-l", files["three"],
                         "--autobox_ligand", files["one"], "-o", str(out),
                         "--atom_term_data"] + DOCK,
                  files["dir"] / "dock.log")
    assert rc == 0
    assert seen["settings"].fused_done_frac == 0.9
    assert seen["settings"].canonical_shapes is False
    heads = [x for x in log.splitlines() if x.startswith("## ")]
    assert heads == [f"## {n}" for n in files["names"]]
    rows = [x for x in log.splitlines() if re.match(r"^\s+\d+\s+-?\d", x)]
    text = out.read_text()
    assert 3 <= len(rows) <= 9 and text.count("$$$$") == len(rows)
    assert text.count(">  <minimizedAffinity>") == len(rows)
    assert text.count(">  <atomic_interaction_terms>") == len(rows)
    first = [b for b in text.split("$$$$\n") if b.strip()][0]
    assert first.splitlines()[0] == "ligA"
    assert not (files["dir"] / "dock.sdf.partial").exists()
    # the table's first affinity is the first block's tag
    aff = float(first.split(">  <minimizedAffinity>\n")[1].splitlines()[0])
    assert abs(aff - float(rows[0].split()[1])) <= 5e-3
    assert "mode |  affinity  |  intramol  |    CNN     |   CNN" in log


def test_resume_docks_only_the_rest(files):
    """A .partial file holding ligand 0 (and a block whose name does not
    match): --resume keeps block 0 verbatim, warns about the other and
    docks ligands 1 and 2."""
    out = files["dir"] / "res.sdf"
    part = files["dir"] / "res.sdf.partial"
    body = "ligA\nKEPT VERBATIM\n$$$$\n"
    part.write_text(f"#GNINA_TPU_IDX 0 ligA\n{body}"
                    "#GNINA_TPU_IDX 1 other\nSTALE\n$$$$\n")
    rc, log = run(tcli, ["-r", files["rec"], "-l", files["three"],
                         "--autobox_ligand", files["one"], "-o", str(out),
                         "--resume"] + DOCK, files["dir"] / "res.log")
    assert rc == 0
    assert "Resuming: 1 of 3 ligand(s) already docked" in log
    assert "WARNING: partial block 1 names 'other'" in log
    assert "## ligA (resumed)" in log
    assert "## ligB\n" in log and "## ligC\n" in log
    text = out.read_text()
    assert text.startswith(body) and "STALE" not in text
    assert text.count("$$$$") >= 3 and not part.exists()
    # without --resume a stale partial is overwritten, not trusted
    part.write_text(f"#GNINA_TPU_IDX 0 ligA\n{body}")
    rc, log = run(tcli, ["-r", files["rec"], "-l", files["three"],
                         "--autobox_ligand", files["one"], "-o", str(out)]
                  + DOCK, files["dir"] / "res2.log")
    assert rc == 0 and "resumed" not in log
    assert "KEPT VERBATIM" not in out.read_text()


def test_a_failing_batch_is_retried_per_ligand(files, monkeypatch):
    """dock_batch raising on the batch: each ligand is retried alone, and a
    ligand that fails alone costs only itself."""
    real = tcli.DockingEngine.dock_batch

    def flaky(self, rec, ligs, *a, **kw):
        if len(ligs) > 1:
            raise RuntimeError("poisoned batch")
        if ligs[0].name == "ligB":
            raise ValueError("bad molecule")
        return real(self, rec, ligs, *a, **kw)

    monkeypatch.setattr(tcli.DockingEngine, "dock_batch", flaky)
    out = files["dir"] / "retry.sdf"
    rc, log = run(tcli, ["-r", files["rec"], "-l", files["three"],
                         "--autobox_ligand", files["one"], "-o", str(out)]
                  + DOCK, files["dir"] / "retry.log")
    assert rc == 0
    assert "WARNING: batch failed (poisoned batch); retrying per-ligand" in log
    assert "ERROR processing ligand ligB: bad molecule" in log
    blocks = [b for b in out.read_text().split("$$$$\n") if b.strip()]
    assert {b.splitlines()[0] for b in blocks} == {"ligA", "ligC"}


# ------------------------------------------------- the screen's batches ----

@pytest.mark.parametrize("sms,per_sm,e,n_dev,k3,want", [
    (None, 0, 8, 1, True, 8),
    (132, 1, 8, 1, True, 16),
    (132, 1, 16, 1, True, 8),
    (132, 1, 32, 1, True, 8),
    (132, 1, 1, 1, True, 132),
    (132, 1, 8, 2, True, 32),
    (132, 1, 8, 1, False, 8),
], ids=["cpu", "h100", "e16", "e32", "e1", "two_cards", "general_route"])
def test_batch_ligands_fills_k3s_slots(sms, per_sm, e, n_dev, k3, want):
    """A batch per card fills K3's resident pose blocks (SMs x blocks an
    SM) at one lane a chain, never below 8; 8 a card off the card and off
    K3's route; the dp mesh multiplies it by its cards."""
    assert batch_ligands(sms, per_sm, e, n_dev, k3) == want


def test_a_bucket_docks_as_one_batch_that_fills_the_slots(files,
                                                          monkeypatch):
    """With K3's slots reported as 128 (128 SMs x 1 block), a file of 16
    ligands of one shape bucket at exhaustiveness 2 docks as one
    screen.batch of 16 (64 a card; the JAX CLI's 8 would make two), and
    the poses are written in input order.  Unpatched on the CPU, and on the
    general route, the batch stays at 8."""
    from torch.profiler import ProfilerActivity, profile

    from gnina_tpu_torch import trace
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.docking import DockingEngine
    from gnina_tpu_torch.ops import fused_dock as fd

    with open(fx.LIGAND_SDF) as f:
        records = f.read().split("$$$$\n")[:16]
    names = [f"lig{i:02d}" for i in range(16)]
    sixteen = files["dir"] / "sixteen.sdf"
    sixteen.write_text("".join(n + r[r.index("\n"):] + "$$$$\n"
                               for n, r in zip(names, records)))
    rec = ingest.Receptor.from_file(files["rec"])
    ligs = [fx.ligand()] * 16
    center, size = ingest.autobox_ligand(files["one"])

    def batch(**kw):
        eng = DockingEngine(DockSettings(exhaustiveness=2, **kw),
                            device="cpu")
        return eng.screen_batch(rec, ligs, center, size)

    assert batch() == 8
    monkeypatch.setattr(fd, "k3_occupancy", lambda dev, smem: (128, 1))
    assert batch() == 64
    assert batch(fused_search="off") == 8
    assert batch(fused_async_mc=False) == 8

    out = files["dir"] / "sixteen_out.sdf"
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        rc, log = run(tcli, ["-r", files["rec"], "-l", str(sixteen),
                             "--autobox_ligand", files["one"], "-o",
                             str(out), "--minimize_iters", "2"] + DOCK,
                        files["dir"] / "sixteen.log")
    snap = trace.snapshot()
    trace.reset()
    assert rc == 0
    batches = [s["attrs"] for s in snap["spans"]
               if s["name"] == "screen.batch"]
    assert len(batches) == 1 and batches[0]["ligands"] == 16
    assert snap["counters"]["dock.lanes"] == 32
    assert snap["counters"]["screen.slots"] == 128
    heads = [x for x in log.splitlines() if x.startswith("## ")]
    assert heads == [f"## {n}" for n in names]
    blocks = [b.splitlines()[0] for b in out.read_text().split("$$$$\n")
              if b.strip()]
    assert len(blocks) >= 16
    assert [n for i, n in enumerate(blocks)
            if i == 0 or blocks[i - 1] != n] == names


# ------------------------------------- fused_done_frac through the engine ----

MODES = {"default": {}, "fused_async_ls": dict(fused_async_ls=True),
         "lockstep_windows": dict(fused_async_mc=False),
         "host_driven": dict(fused_mc_in_kernel=False)}


@pytest.mark.parametrize("mode", list(MODES))
def test_done_frac_docks_in_every_search_mode(files, mode):
    """DockSettings(fused_done_frac=0.9) docks in every search mode (K8 in
    the refine, the finish stages and, with lockstep windows, the window),
    giving finite poses sorted by energy; 1.0 is bit for bit the dock
    without the setting."""
    from gnina_tpu_torch.chem import ingest
    from gnina_tpu_torch.docking import DockingEngine

    rec = ingest.Receptor.from_file(files["rec"])
    lig = fx.ligand()
    center, size = ingest.autobox_ligand(files["one"])
    kw = dict(cnn_scoring="none", num_mc_steps=16, exhaustiveness=2,
              num_mc_saved=3, num_modes=3, minimize_iters=3, **MODES[mode])

    def dock(**extra):
        eng = DockingEngine(DockSettings(**kw, **extra), device="cpu")
        return eng.dock_batch(rec, [lig], center, size, seed=3)

    cut = dock(fused_done_frac=0.9)
    assert len(cut) == 1 and all(cut)
    for res in cut:
        e = [p.energy for p in res]
        assert e == sorted(e) and np.isfinite(e).all()
        assert all(np.isfinite(p.coords).all() for p in res)
    if mode != "default":
        return
    base, one = dock(), dock(fused_done_frac=1.0)
    for ra, rb in zip(base, one):
        assert len(ra) == len(rb)
        for a, b in zip(ra, rb):
            assert a.energy == b.energy
            assert np.array_equal(a.coords, b.coords)


# -------------------------------------------------------------- refusals ----

def test_errors_return_one(files, capsys):
    base = ["-r", files["rec"], "-l", files["one"], "--cnn_scoring", "none",
            "--device", "cpu"]
    assert tcli.main(base + ["--no_such_flag"]) == 1
    assert "ERROR: unrecognized option(s): --no_such_flag" \
        in capsys.readouterr().out
    assert tcli.main(["-l", files["one"]]) == 1
    assert "ERROR: receptor (-r) required" in capsys.readouterr().out
    assert tcli.main(["-r", files["rec"]]) == 1
    assert "ERROR: ligand (-l) required" in capsys.readouterr().out
    assert tcli.main(["-r", files["rec"] + ".missing", "-l",
                      files["one"]]) == 1
    assert "ERROR: cannot read file" in capsys.readouterr().out
    assert tcli.main(["-r", files["rec"], "-l", "/nonexistent/lig.sdf"]) == 1
    assert "ERROR: cannot read file" in capsys.readouterr().out
    # docking without a box
    assert tcli.main(base) == 1
    assert "ERROR: search box required" in capsys.readouterr().out
    empty = files["dir"] / "empty.sdf"
    empty.write_text("")
    assert tcli.main(["-r", files["rec"], "-l", str(empty), "--score_only",
                      "--cnn_scoring", "none", "--device", "cpu"]) == 1
    assert "ERROR: no ligands could be read" in capsys.readouterr().out


# every flag of the JAX CLI is ported: the general path's flags
# (test_torch_cli_general.py), the flex, covalent and --outputmin flags
# (test_torch_cli_flex.py), the CNN-in-the-loop and CNN debug flags
# (test_torch_cli_cnn.py), --cnn_model (test_torch_torchscript.py) and
# --dist_nprocs (test_torch_multihost.py)


def test_dist_nprocs_from_the_environment(files, monkeypatch):
    """The JAX CLI's environment contract: GNINA_TPU_NPROCS, _PROCID and
    _COORDINATOR reach the rendezvous (parallel/multihost.init) when no
    flag is given; the flags override them."""
    from gnina_tpu_torch.parallel import multihost

    seen = []

    class Stop(Exception):
        pass

    def spy(coord, nprocs, pid, timeout=None):
        seen.append((coord, nprocs, pid))
        raise Stop

    monkeypatch.setattr(multihost, "init", spy)
    monkeypatch.setenv("GNINA_TPU_NPROCS", "4")
    monkeypatch.setenv("GNINA_TPU_PROCID", "3")
    monkeypatch.setenv("GNINA_TPU_COORDINATOR", "127.0.0.1:1")
    base = ["-r", files["rec"], "-l", files["one"], "-q", "--device", "cpu"]
    with pytest.raises(Stop):
        tcli.main(base)
    with pytest.raises(Stop):
        tcli.main(base + ["--dist_nprocs", "2", "--dist_procid", "0",
                          "--dist_coordinator", "127.0.0.1:2"])
    assert seen == [("127.0.0.1:1", 4, 3), ("127.0.0.1:2", 2, 0)]
    monkeypatch.setenv("GNINA_TPU_NPROCS", "1")
    seen.clear()
    assert tcli.main(base + ["--score_only", "--cnn_scoring", "none"]) == 0
    assert seen == []


def test_table_dumps_equal_jax(capsys):
    assert tcli.main(["--print_terms"]) == 0
    t = capsys.readouterr().out
    assert jcli.main(["--print_terms"]) == 0
    assert t == capsys.readouterr().out
    assert tcli.main(["--print_atom_types"]) == 0
    t = capsys.readouterr().out
    assert jcli.main(["--print_atom_types"]) == 0
    assert t == capsys.readouterr().out and "Hydrogen" in t


def test_env_knobs_keep_their_names(files, monkeypatch):
    """Each GNINA_TPU_FUSED_* knob the JAX CLI reads reaches DockSettings."""
    seen = {}

    class Stop(Exception):
        pass

    def spy(settings, **kw):
        seen["s"] = settings
        raise Stop

    monkeypatch.setattr(tcli, "DockingEngine", spy)
    env = {"FUSED_ASYNC_LS": "1", "FUSED_ASYNC_MC": "0",
           "FUSED_MC_IN_KERNEL": "0", "FUSED_MC_TICK_BUDGET": "24",
           "FUSED_MC_STEPS": "32", "FUSED_LS_TRIALS": "5",
           "FUSED_LS_FACTOR": "4.0", "FUSED_REFINE_EVERY": "8",
           "FUSED_DONE_FRAC": "0.75"}
    for k, v in env.items():
        monkeypatch.setenv("GNINA_TPU_" + k, v)
    with pytest.raises(Stop):
        tcli.main(["-r", files["rec"], "-l", files["one"], "--cnn_scoring",
                   "none", "--device", "cpu", "-q", "--minimize"])
    s = seen["s"]
    assert dataclasses.asdict(s) == dataclasses.asdict(dataclasses.replace(
        DockSettings(cnn_scoring="none", forcecap=10.0,
                     sort_order="CNNscore"),
        fused_async_ls=True, fused_async_mc=False, fused_mc_in_kernel=False,
        fused_mc_tick_budget=24, fused_mc_steps=32, fused_ls_trials=5,
        fused_ls_factor=4.0, fused_refine_every=8, fused_done_frac=0.75))
