"""The CNN-in-the-loop flags of the port's command line on the CPU, and the
CNN debug outputs against the JAX package's models/debug_out.py.

Every flag of the CNN group that the port used to refuse (--cnn_scoring
refinement|metrorescore|metrorefine|all, --cnn_mix_emp_force,
--cnn_mix_emp_energy, --cnn_empirical_weight, --cnn_outputxyz,
--cnn_outputdx, --cnn_xyzprefix, --cnn_gradient_check, --cnn_verbose) runs
through cli.main with the toy CNN (test_torch_cnn_objective.py) standing in
for the named model: CNNScorer is replaced by one over the toy model for
the test.  The debug outputs (atom_gradients, the .dx grid gradients,
gradient_check's log lines) are held to JAX's on the same toy model within
1e-3 of their largest component; write_dx byte for byte.
"""

import io
import os
import re

import numpy as np
import pytest
import torch

from gnina_tpu.models import debug_out as jdebug
from gnina_tpu.tools.gninagrid import write_dx as jwrite_dx
from gnina_tpu_torch import cli as tcli
from gnina_tpu_torch.models import debug_out as tdebug
from gnina_tpu_torch.models import scorer as tscorer
from test_torch_cnn_objective import grad_close, load_system, toy_scorers, \
    write_system


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_cnn")
    lig, rec = write_system(d)
    return dict(dir=d, lig=lig, rec=rec)


@pytest.fixture(scope="module")
def scorers():
    return toy_scorers(0)


@pytest.fixture
def toy_cli(monkeypatch, scorers):
    """cli.main with every CNNScorer it builds over the toy model; records
    the scorers and the engines' settings."""
    toy = scorers[1].models
    seen = dict(scorers=[], settings=[])

    class ToyScorer(tscorer.CNNScorer):
        def __init__(self, model_names=None, **kw):
            super().__init__(models=toy, **kw)
            seen["scorers"].append(self)

    real_init = tcli.DockingEngine.__init__

    def init(self, settings, *a, **kw):
        seen["settings"].append(settings)
        real_init(self, settings, *a, **kw)

    monkeypatch.setattr(tscorer, "CNNScorer", ToyScorer)
    monkeypatch.setattr(tcli.DockingEngine, "__init__", init)
    return seen


BOX = ["--center_x", "0", "--center_y", "0", "--center_z", "0", "--size_x",
       "10", "--size_y", "10", "--size_z", "10"]
DOCK = BOX + ["--num_mc_steps", "4", "--exhaustiveness", "2",
              "--num_mc_saved", "4", "--num_modes", "3"]
JOBS = {
    "refinement": DOCK + ["--cnn_scoring", "refinement"],
    "metrorescore": DOCK + ["--cnn_scoring", "metrorescore"],
    "metrorefine": DOCK + ["--cnn_scoring", "metrorefine"],
    "all": BOX + ["--cnn_scoring", "all", "--num_mc_steps", "2",
                  "--exhaustiveness", "2", "--num_mc_saved", "4",
                  "--num_modes", "3"],
    "minimize": ["--minimize", "--cnn_scoring", "refinement",
                 "--minimize_iters", "10"],
    "mix_force": DOCK + ["--cnn_scoring", "refinement",
                         "--cnn_mix_emp_force"],
    "mix_energy": DOCK + ["--cnn_scoring", "refinement",
                          "--cnn_mix_emp_energy"],
    "mix_both_weight": DOCK + ["--cnn_scoring", "refinement",
                               "--cnn_mix_emp_force", "--cnn_mix_emp_energy",
                               "--cnn_empirical_weight", "0.5"],
}


@pytest.mark.parametrize("job", list(JOBS))
def test_cnn_in_the_loop_jobs(files, toy_cli, job):
    """rc 0; every pose in the SDF carries a finite minimizedAffinity and a
    CNNscore in (0, 1); the settings carry the flags."""
    out = str(files["dir"] / f"{job}.sdf")
    rc = tcli.main(["-r", files["rec"], "-l", files["lig"], "--cnn", "fast",
                    "--device", "cpu", "-q", "-o", out] + JOBS[job])
    assert rc == 0
    text = open(out).read()
    aff = [float(v) for v in re.findall(r">  <minimizedAffinity>\n(\S+)",
                                        text)]
    cnn = [float(v) for v in re.findall(r">  <CNNscore>\n(\S+)", text)]
    assert text.count("$$$$") == len(aff) == len(cnn) >= 1
    assert np.isfinite(aff).all() and all(0.0 < c < 1.0 for c in cnn)
    s = toy_cli["settings"][-1]
    want_mode = "refinement" if job not in (
        "metrorescore", "metrorefine", "all") else job
    assert s.cnn_scoring == want_mode
    assert s.cnn_mix_emp_force == ("force" in job or "both" in job)
    assert s.cnn_mix_emp_energy == ("energy" in job or "both" in job)
    assert s.cnn_empirical_weight == (0.5 if "weight" in job else 1.0)
    if job in ("refinement", "metrorescore", "all"):
        cs = [float(v) for v in cnn]
        assert cs == sorted(cs, reverse=True)


def test_debug_output_flags(files, toy_cli):
    """--score_only with --cnn_outputxyz, --cnn_outputdx,
    --cnn_gradient_check, --cnn_verbose and --cnn_xyzprefix: the .xyz files
    (one row an atom: element, coordinates, gradient), one .dx file a
    channel (n^3 values), the gradient-check lines in the log, and the
    scorer built verbose."""
    prefix = str(files["dir"] / "dbg")
    log = str(files["dir"] / "dbg.log")
    rc = tcli.main(["-r", files["rec"], "-l", files["lig"], "--cnn", "fast",
                    "--device", "cpu", "-q", "--score_only",
                    "--cnn_outputxyz", "--cnn_outputdx",
                    "--cnn_gradient_check", "--cnn_verbose",
                    "--cnn_xyzprefix", prefix, "--log", log])
    assert rc == 0
    assert [s.verbose for s in toy_cli["scorers"]] == [True]
    m = toy_cli["scorers"][0].models[0]
    lig = load_system(files["lig"], files["rec"])["tlig"]
    rows = open(f"{prefix}_lig.xyz").read().splitlines()
    assert int(rows[0]) == lig.num_atoms == len(rows) - 2
    vals = np.array([[float(v) for v in r.split()[1:]] for r in rows[2:]])
    assert vals.shape == (lig.num_atoms, 6) and np.isfinite(vals).all()
    assert np.abs(vals[:, 3:]).max() > 0
    rec_rows = open(f"{prefix}_rec.xyz").read().splitlines()
    assert int(rec_rows[0]) == len(rec_rows) - 2 > 0
    dx = sorted(f for f in os.listdir(files["dir"])
                if f.startswith("dbg_grad_") and f.endswith(".dx"))
    assert len(dx) == m.num_channels
    n = m.grid_points
    for f in dx[:3]:
        assert len(_dx_values(str(files["dir"] / f))) == n ** 3
    text = open(log).read()
    assert len(re.findall(r"gradient_check atom \d axis \d: analytic",
                          text)) == 9
    assert re.search(r"gradient_check max relative error: \S+", text)


def _dx_values(path):
    lines = open(path).read().splitlines()
    start = next(i for i, ln in enumerate(lines) if "data follows" in ln)
    return np.array([float(v) for ln in lines[start + 1:]
                     for v in ln.split()])


# ------------------------------------------------- against JAX's writers ----

@pytest.fixture(scope="module")
def debug_inputs(files, scorers):
    system = load_system(files["lig"], files["rec"])
    js, ts = scorers
    lig = system["tlig"]
    rng = np.random.default_rng(2)
    coords = (lig.orig_coords + rng.normal(scale=0.2, size=(1, 3))).astype(
        np.float32)
    center = coords.mean(axis=0)
    rc, rt, rm = ts._receptor_arrays(system["trec"], center[None])
    return dict(js=js, ts=ts, jlig=system["jlig"], tlig=lig, coords=coords,
                center=center, rec=(rc, rt, rm))


def test_atom_gradients_match_jax(debug_inputs):
    d = debug_inputs
    rc, rt, rm = d["rec"]
    jl, jr = jdebug.atom_gradients(d["js"], rc, rt.astype(np.int32), rm,
                                   d["jlig"], d["coords"], d["center"])
    tl, tr = tdebug.atom_gradients(d["ts"], rc, rt, rm, d["tlig"],
                                   d["coords"], d["center"])
    grad_close(tl, jl)
    grad_close(tr[rm], np.asarray(jr)[rm])
    assert not tr[~rm].any()


def test_grid_gradient_dx_matches_jax(debug_inputs, tmp_path):
    d = debug_inputs
    rc, rt, rm = d["rec"]
    jlog, tlog = io.StringIO(), io.StringIO()
    jw = jdebug.write_grid_gradient_dx(str(tmp_path / "j"), d["js"], rc,
                                       rt.astype(np.int32), rm, d["jlig"],
                                       d["coords"], d["center"], log=jlog)
    tw = tdebug.write_grid_gradient_dx(str(tmp_path / "t"), d["ts"], rc, rt,
                                       rm, d["tlig"], d["coords"],
                                       d["center"], log=tlog)
    assert [os.path.basename(p)[1:] for p in tw] == \
        [os.path.basename(p)[1:] for p in jw]
    assert tlog.getvalue().replace(str(tmp_path / "t"), "P") == \
        jlog.getvalue().replace(str(tmp_path / "j"), "P")
    want = np.stack([_dx_values(p) for p in jw])
    got = np.stack([_dx_values(p) for p in tw])
    grad_close(got, want)
    for a, b in zip(jw, tw):      # the same header: origin and spacing
        assert open(a).read().split("data follows")[0] == \
            open(b).read().split("data follows")[0]


def test_gradient_check_log_matches_jax(debug_inputs):
    d = debug_inputs
    rc, rt, rm = d["rec"]
    jlog, tlog = io.StringIO(), io.StringIO()
    jworst = jdebug.gradient_check(d["js"], rc, rt.astype(np.int32), rm,
                                   d["jlig"], d["coords"], d["center"], jlog)
    tworst = tdebug.gradient_check(d["ts"], rc, rt, rm, d["tlig"],
                                   d["coords"], d["center"], tlog)
    pat = r"atom (\d) axis (\d): analytic (\S+) numeric (\S+) rel"
    jl = np.array(re.findall(pat, jlog.getvalue()), float)
    tl = np.array(re.findall(pat, tlog.getvalue()), float)
    assert jl.shape == tl.shape == (9, 4)
    np.testing.assert_array_equal(tl[:, :2], jl[:, :2])
    grad_close(tl[:, 2], jl[:, 2])
    np.testing.assert_allclose(tl[:, 3], jl[:, 3], rtol=0,
                               atol=1e-3 * np.abs(jl[:, 2]).max())
    assert np.isfinite([jworst, tworst]).all()


def test_write_dx_is_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(7, 7, 7)).astype(np.float32)
    center = np.asarray([1.25, -3.5, 0.125], np.float32)
    jwrite_dx(str(tmp_path / "j.dx"), grid, center, 0.375)
    tdebug.write_dx(str(tmp_path / "t.dx"), grid, center, 0.375)
    assert open(tmp_path / "t.dx", "rb").read() == \
        open(tmp_path / "j.dx", "rb").read()


def test_write_gradient_xyz_is_jax_byte_for_byte(tmp_path, debug_inputs):
    d = debug_inputs
    g = np.random.default_rng(1).normal(size=d["coords"].shape)
    jdebug.write_gradient_xyz(str(tmp_path / "j.xyz"), d["jlig"].types,
                              d["coords"], g)
    tdebug.write_gradient_xyz(str(tmp_path / "t.xyz"), d["tlig"].types,
                              d["coords"], g)
    assert open(tmp_path / "t.xyz").read() == open(tmp_path / "j.xyz").read()
