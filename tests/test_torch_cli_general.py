"""The command line's general-path flags against the JAX package's CLI:
--custom_scoring, --scoring dkoes_scoring|dkoes_scoring_old|dkoes_fast|
ad4_scoring, --user_grid and --user_grid_lambda, --simple_ascent and
--minimize_single_full.  The in-repo fixture as in test_torch_cli.py (the
minout.sdf ligand in a synthetic receptor), with a term file and an AD4 map
written to tmp_path from a numpy seed.  Score-only and minimisation log
lines are held to JAX's; docking runs (the port's general path, which the
JAX CLI would compile for minutes here) are held to their own invariants.
Everything runs with --device cpu.
"""

import re

import numpy as np
import pytest
import torch

from gnina_tpu import cli as jcli
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import cli as tcli

NUM = re.compile(r"-?\d+\.\d+")
TERMS = """# weights and terms, custom_terms format
-0.035579 gauss(o=0,_w=0.5,_c=8)
-0.005156 gauss(o=3,_w=2,_c=8)
0.840245 repulsion(o=0,_c=8)
0.0099 vdw(i=4,_j=8,_s=0,_^=100,_c=8)
0.048934 ad4_solvation(d-sigma=3.6,_s/q=0.01097,_c=8)
-0.587439 non_dir_h_bond(g=-0.7,_b=0,_c=8)
0.317267 num_tors_sqr
"""


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_general")
    lig = fx.ligand()
    center = fx.ligand_center(lig)
    rec = d / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(center, seed=4, cube=22.0))
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    one = d / "one.sdf"
    one.write_text(first)
    terms = d / "terms.score"
    terms.write_text(TERMS)
    # an AD4 map of 21^3 points, 0.4 A apart, around the ligand: a smooth
    # bias plus seeded noise
    rng = np.random.default_rng(5)
    n, spacing = 21, 0.4
    ax = (np.arange(n) - n // 2) * spacing
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    vals = 0.05 * (x * x + y * y + z * z) - 0.3 + 0.05 * rng.normal(
        size=x.shape)
    grid = d / "bias.map"
    with open(grid, "w") as f:
        f.write("GRID_PARAMETER_FILE t.gpf\nGRID_DATA_FILE t.fld\n"
                "MACROMOLECULE rec.pdbqt\nSPACING 0.4\n"
                f"NELEMENTS {n - 1} {n - 1} {n - 1}\n"
                f"CENTER {center[0]:.3f} {center[1]:.3f} {center[2]:.3f}\n")
        # x fastest
        f.write("\n".join(f"{v:.4f}" for v in vals.transpose(2, 1, 0).ravel())
                + "\n")
    box = ["--center_x", f"{center[0]:.3f}", "--center_y",
           f"{center[1]:.3f}", "--center_z", f"{center[2]:.3f}",
           "--size_x", "8", "--size_y", "8", "--size_z", "8"]
    return dict(dir=d, rec=str(rec), one=str(one), terms=str(terms),
                grid=str(grid), box=box)


def run(mod, argv, log):
    rc = mod.main(argv + ["--log", str(log), "-q"])
    return rc, log.read_text()


def same_lines(t, j, atol):
    """The same log lines but for their numbers, which agree within atol
    (and rtol 1e-5); the loop time is left out."""
    tl = [x for x in t.splitlines() if not x.startswith("Loop time")]
    jl = [x for x in j.splitlines() if not x.startswith("Loop time")]
    assert [NUM.sub("#", x) for x in tl] == [NUM.sub("#", x) for x in jl]
    for a, b in zip(tl, jl):
        np.testing.assert_allclose([float(v) for v in NUM.findall(a)],
                                   [float(v) for v in NUM.findall(b)],
                                   atol=atol, rtol=1e-5)
    return tl


SCORE_FLAGS = {
    "dkoes_scoring": ["--scoring", "dkoes_scoring"],
    "dkoes_scoring_old": ["--scoring", "dkoes_scoring_old"],
    "dkoes_fast": ["--scoring", "dkoes_fast"],
    "ad4_scoring": ["--scoring", "ad4_scoring"],
    "custom_scoring": ["--custom_scoring", "TERMS"],
    "user_grid": ["--user_grid", "GRID"],
    "user_grid_lambda": ["--user_grid", "GRID", "--user_grid_lambda", "0.6"],
}


@pytest.mark.parametrize("case", list(SCORE_FLAGS))
def test_score_only_log_lines_equal_jax(files, case):
    """--score_only under each flag: the same lines as the JAX CLI, every
    printed number within 1e-3 (five decimals are printed; the float32
    sums differ in the fifth)."""
    flags = [files["terms"] if f == "TERMS" else files["grid"]
             if f == "GRID" else f for f in SCORE_FLAGS[case]]
    argv = ["-r", files["rec"], "-l", files["one"], "--score_only",
            "--cnn_scoring", "none"] + flags
    rc_t, t = run(tcli, argv + ["--device", "cpu"],
                  files["dir"] / f"t_{case}.log")
    rc_j, j = run(jcli, argv, files["dir"] / f"j_{case}.log")
    assert rc_t == rc_j == 0
    tl = same_lines(t, j, 1e-3)
    assert any(x.startswith("Affinity:") for x in tl)


def test_user_grid_moves_the_affinity(files):
    """The user grid's bias reaches the affinity, and --user_grid_lambda
    rescales both the terms and the grid (set_scaling_factor)."""
    base = ["-r", files["rec"], "-l", files["one"], "--score_only",
            "--cnn_scoring", "none", "--device", "cpu"]
    affinity = {}
    for name, extra in (("plain", []), ("grid", ["--user_grid",
                                                 files["grid"]]),
                        ("lambda", ["--user_grid", files["grid"],
                                    "--user_grid_lambda", "0.6"])):
        rc, log = run(tcli, base + extra, files["dir"] / f"ug_{name}.log")
        assert rc == 0
        line = next(x for x in log.splitlines() if x.startswith("Affinity:"))
        affinity[name] = float(NUM.findall(line)[0])
    assert abs(affinity["grid"] - affinity["plain"]) > 0.1
    assert len(set(affinity.values())) == 3


def test_simple_ascent_minimize_log_lines_equal_jax(files):
    """--minimize --simple_ascent (the legacy steepest descent for 60
    trials at force cap 10): the same lines as the JAX CLI; affinity and
    intramolecular energy within 0.05 kcal/mol and RMSD within 0.05 A."""
    argv = ["-r", files["rec"], "-l", files["one"], "--minimize",
            "--simple_ascent", "--minimize_iters", "60",
            "--cnn_scoring", "none"]
    rc_t, t = run(tcli, argv + ["--device", "cpu"],
                  files["dir"] / "t_ssd.log")
    rc_j, j = run(jcli, argv, files["dir"] / "j_ssd.log")
    assert rc_t == rc_j == 0
    same_lines(t, j, 0.05)
    rc_b, b = run(tcli, argv[:-4] + ["--minimize_iters", "60",
                                     "--cnn_scoring", "none", "--device",
                                     "cpu"], files["dir"] / "t_bfgs.log")
    assert rc_b == 0 and b != t


DOCK = ["--cnn_scoring", "none", "--num_mc_steps", "8", "--exhaustiveness",
        "2", "--num_mc_saved", "4", "--num_modes", "3", "--device", "cpu"]


@pytest.mark.parametrize("case", ["minimize_single_full", "simple_ascent",
                                  "dkoes_fast", "user_grid_box"])
def test_docking_takes_the_general_path(files, case, monkeypatch):
    """A short dock under each flag runs the general path (counted at
    DockingEngine._dock_general) and writes poses with the
    minimizedAffinity tag (in container order: the CLI's default sort is
    by CNNscore, 0 without a CNN); --user_grid without a box docks in the
    map's box (setup_user_gd) and keeps every pose in it."""
    from gnina_tpu_torch.docking import DockingEngine

    calls = []
    orig = DockingEngine._dock_general

    def counted(self, *a, **k):
        calls.append(self.settings)
        return orig(self, *a, **k)

    monkeypatch.setattr(DockingEngine, "_dock_general", counted)
    flags = {"minimize_single_full": ["--minimize_single_full"] + files["box"],
             "simple_ascent": ["--simple_ascent"] + files["box"],
             "dkoes_fast": ["--scoring", "dkoes_fast"] + files["box"],
             "user_grid_box": ["--user_grid", files["grid"]]}[case]
    out = files["dir"] / f"dock_{case}.sdf"
    rc, log = run(tcli, ["-r", files["rec"], "-l", files["one"], "-o",
                         str(out)] + DOCK + flags,
                  files["dir"] / f"dock_{case}.log")
    assert rc == 0 and len(calls) == 1
    text = out.read_text()
    n = text.count("$$$$")
    assert 1 <= n <= 3
    e = [float(v) for v in re.findall(r">  <minimizedAffinity>\n(\S+)",
                                       text)]
    assert len(e) == n and np.isfinite(e).all()
    if case == "user_grid_box":
        center = fx.ligand_center(fx.ligand())
        # the map's box: 21 points 0.4 A apart, centred half a spacing up
        lo, hi = center + 0.2 - 4.2, center + 0.2 + 4.2
        blocks = text.split("$$$$\n")[:n]
        for blk in blocks:
            lines = blk.splitlines()
            na = int(lines[3][:3])
            xyz = np.array([[float(v) for v in ln.split()[:3]]
                            for ln in lines[4:4 + na]])
            sym = [ln.split()[3] for ln in lines[4:4 + na]]
            heavy = xyz[[s != "H" for s in sym]]
            assert ((heavy >= lo - 1e-2) & (heavy <= hi + 1e-2)).all()
    else:
        assert calls[0].minimize_single_full == (
            case == "minimize_single_full")
        assert calls[0].simple_ascent == (case == "simple_ascent")


def test_unknown_scoring_function_raises_like_jax(files):
    argv = ["-r", files["rec"], "-l", files["one"], "--score_only",
            "--cnn_scoring", "none", "--scoring", "nonesuch", "-q"]
    with pytest.raises(KeyError, match="nonesuch"):
        jcli.main(argv)
    with pytest.raises(KeyError, match="nonesuch"):
        tcli.main(argv + ["--device", "cpu"])
