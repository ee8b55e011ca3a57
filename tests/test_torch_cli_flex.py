"""The command line's flex, covalent and --outputmin flags, write_flex_pdb,
the minimization trajectory and --atom_terms under flex, against the JAX
package.

Inputs: the port's receptor with real residues
(_fixtures.flex_receptor_pdb_text, a 24 A cube), the minout.sdf ligand, the
fixture's acrylamide warhead and a flex PDBQT written from the receptor
(_fixtures.flex_pdbqt_text), all in tmp_path.  Score-only and minimisation
log lines are held to the JAX CLI's (every number within 1e-3, five
decimals printed); docking jobs through the port's CLI (the general path,
which the JAX CLI would compile for minutes here) are held to their own
invariants.  Everything runs with --device cpu.
"""

import os
import re
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from gnina_tpu import cli as jcli
from gnina_tpu import docking as jdocking
from gnina_tpu import output as joutput
from gnina_tpu.chem import flexinfo as jflex
from gnina_tpu.chem import ingest as jingest
from gnina_tpu.chem.tree_build import attach_flex as jattach
from gnina_tpu.scoring.atom_terms import atom_terms_table as jatom_terms
from gnina_tpu.scoring.builtin import get_scoring_function as jget_sf
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import cli as tcli
from gnina_tpu_torch import docking as tdocking
from gnina_tpu_torch import output as toutput
from gnina_tpu_torch.chem import flexinfo as tflex
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.chem.tree_build import attach_flex as tattach
from gnina_tpu_torch.scoring.atom_terms import atom_terms_table as \
    tatom_terms
from gnina_tpu_torch.scoring.builtin import get_scoring_function as tget_sf
from test_torch_cli_general import run, same_lines

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")
SPEC = ",".join(f"{c}:{r}" for c, r, _ in fx.FLEXDIST_35)
CYS = next(r for n, r, _ in fx.FLEX_RESIDUES if n == "CYS")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_flex")
    lig = fx.ligand()
    text = fx.flex_receptor_pdb_text(lig, seed=2, cube=24.0)
    rec = d / "rec.pdb"
    rec.write_text(text)
    with open(fx.LIGAND_SDF) as f:
        first = f.read().split("$$$$\n")[0] + "$$$$\n"
    one = d / "one.sdf"
    one.write_text(first)
    warhead = d / "warhead.sdf"
    warhead.write_text(fx.ACRYLAMIDE_SDF)
    trec = tingest.Receptor.from_file(str(rec))
    pdbqt = d / "flex.pdbqt"
    pdbqt.write_text(fx.flex_pdbqt_text(trec, fx.FLEXDIST_35))
    # the --flex job's receptor: the four residues without their side
    # chains (strip_flex_from_receptor's cut, on the PDB lines)
    flex = {(c, r) for c, r, _ in fx.FLEXDIST_35}
    rigid = d / "rigid.pdb"
    rigid.write_text("".join(
        ln + "\n" for ln in text.splitlines()
        if not (ln.startswith("ATOM") and (ln[21], int(ln[22:26])) in flex
                and ln[12:16].strip() not in tflex.BACKBONE_RIGID)))
    center = fx.ligand_center(lig)
    box = ["--center_x", f"{center[0]:.3f}", "--center_y",
           f"{center[1]:.3f}", "--center_z", f"{center[2]:.3f}",
           "--size_x", "8", "--size_y", "8", "--size_z", "8"]
    return dict(dir=d, rec=str(rec), one=str(one), warhead=str(warhead),
                pdbqt=str(pdbqt), rigid=str(rigid), box=box, trec=trec,
                center=center)


def args_of(files, flags):
    names = {"REC": "rec", "ONE": "one", "WARHEAD": "warhead",
             "PDBQT": "pdbqt", "RIGID": "rigid"}
    return [files[names[f]] if f in names else f for f in flags]


def flexible_residues(log):
    hit = re.findall(r"Flexible residues: (.*)", log)
    return hit[0].split() if hit else []


ALL4 = [f"{c}:{r}" for c, r, _ in fx.FLEXDIST_35]   # closest first
BY_RESID = sorted(ALL4, key=lambda k: int(k.split(":")[1]))  # --flexres
SCORE_JOBS = {
    "flexdist": (["-r", "REC", "-l", "ONE", "--flexdist", "3.5",
                  "--flexdist_ligand", "ONE"], ALL4),
    "flexres": (["-r", "REC", "-l", "ONE", "--flexres", SPEC], BY_RESID),
    "flex_max": (["-r", "REC", "-l", "ONE", "--flexdist", "3.5",
                  "--flexdist_ligand", "ONE", "--flex_max", "2"], ALL4[:2]),
    "flex_pdbqt": (["-r", "RIGID", "-l", "ONE", "--flex", "PDBQT"], ALL4),
    "no_lig": (["-r", "REC", "--no_lig", "--flexres", SPEC], BY_RESID),
    "covalent": (["-r", "REC", "-l", "WARHEAD", "--covalent_rec_atom",
                  f"A:{CYS}:SG", "--covalent_lig_atom_pattern", "[$(C=C)]",
                  "--covalent_bond_order", "1"], []),
}


@pytest.mark.parametrize("case", list(SCORE_JOBS))
def test_score_only_log_lines_equal_jax(files, case):
    """--score_only of each flex and covalent job: the residues named in
    the log, and every line the JAX CLI's (numbers within 1e-3)."""
    flags, residues = SCORE_JOBS[case]
    argv = args_of(files, flags) + ["--score_only", "--cnn_scoring", "none"]
    rc_t, t = run(tcli, argv + ["--device", "cpu"],
                  files["dir"] / f"t_{case}.log")
    rc_j, j = run(jcli, argv, files["dir"] / f"j_{case}.log")
    assert rc_t == rc_j == 0
    lines = same_lines(t, j, 1e-3)
    assert flexible_residues(t) == residues
    aff = [float(x.split()[1]) for x in lines if x.startswith("Affinity:")]
    # the warhead's pattern matches both alkene carbons: two complexes
    assert len(aff) == (2 if case == "covalent" else 1)
    assert np.isfinite(aff).all()
    if case == "covalent":
        assert f"Covalent receptor atom: A:{CYS}:SG" in t


def test_flex_limit_raises_like_jax(files):
    argv = args_of(files, ["-r", "REC", "-l", "ONE", "--flexdist", "3.5",
                           "--flexdist_ligand", "ONE", "--flex_limit", "3",
                           "--score_only", "--cnn_scoring", "none", "-q"])
    for mod, extra in ((tcli, ["--device", "cpu"]), (jcli, [])):
        with pytest.raises(RuntimeError, match="flex_limit"):
            mod.main(argv + extra)


def test_minimize_with_flex_equals_jax(files):
    """--minimize of the ligand with the four flex residues (5 BFGS
    iterations: longer runs of two float32 codes part by more than the
    printed digits): the same log lines as the JAX CLI."""
    argv = args_of(files, ["-r", "REC", "-l", "ONE", "--flexres", SPEC,
                           "--minimize", "--minimize_iters", "5",
                           "--cnn_scoring", "none"])
    rc_t, t = run(tcli, argv + ["--device", "cpu"],
                  files["dir"] / "t_min.log")
    rc_j, j = run(jcli, argv, files["dir"] / "j_min.log")
    assert rc_t == rc_j == 0
    same_lines(t, j, 1e-3)


def sdf_blocks(text):
    """[(minimizedAffinity, (atoms, 3) coordinates)] of an SDF text."""
    out = []
    for blk in text.split("$$$$\n")[:-1]:
        lines = blk.splitlines()
        na = int(lines[3][:3])
        xyz = np.array([[float(v) for v in ln.split()[:3]]
                        for ln in lines[4:4 + na]])
        tag = re.findall(r">  <minimizedAffinity>\n(\S+)", blk)
        out.append((float(tag[0]) if tag else None, xyz))
    return out


DOCK = ["--cnn_scoring", "none", "--exhaustiveness", "2", "--num_mc_steps",
        "4", "--num_modes", "3", "--num_mc_saved", "4", "--seed", "3"]


def test_dock_with_out_flex_and_full_flex_output(files):
    """A docking job with --flexdist, --out_flex and --full_flex_output:
    one MODEL a written pose, each the stripped receptor's heavy atoms and
    the 16 flex atoms; the inflex anchors are not written, and a pose's
    flex atoms are the PDB's last ones."""
    d = files["dir"]
    argv = args_of(files, ["-r", "REC", "-l", "ONE", "--flexdist", "3.5",
                           "--flexdist_ligand", "ONE", "--out_flex",
                           str(d / "flex.pdb"), "--full_flex_output",
                           "-o", str(d / "dock.sdf"), "--device", "cpu"]
                   + files["box"] + DOCK)
    rc, log = run(tcli, argv, d / "dock.log")
    assert rc == 0 and flexible_residues(log) == ALL4
    poses = sdf_blocks((d / "dock.sdf").read_text())
    models = (d / "flex.pdb").read_text().split("ENDMDL\n")[:-1]
    assert 1 <= len(poses) == len(models) <= 3
    rigid = tflex.strip_flex_from_receptor(
        files["trec"], [tflex.extract_flex_residue(files["trec"], k)
                        for k in fx.FLEXDIST_35])
    n_rigid = sum(1 for a in rigid.mol.atoms if a.anum != 1)
    for m in models:
        atoms = [ln for ln in m.splitlines() if ln.startswith("ATOM")]
        assert len(atoms) == n_rigid + 16
        assert {ln[17:20] for ln in atoms[n_rigid:]} == {"SER", "CYS",
                                                         "GLU", "PHE"}


def test_dock_with_flex_pdbqt_and_the_screen_resume(files):
    """--flex on the fixture's PDBQT through the screen, then --resume of
    the same job: the out_flex chunk rides in the .partial checkpoint and
    comes back unchanged."""
    d = files["dir"]
    out, flex_out = d / "pdbqt.sdf", d / "pdbqt_flex.pdb"
    argv = args_of(files, ["-r", "RIGID", "-l", "ONE", "--flex", "PDBQT",
                           "-o", str(out), "--out_flex", str(flex_out),
                           "--device", "cpu"] + files["box"] + DOCK)
    rc, log = run(tcli, argv, d / "pdbqt.log")
    assert rc == 0 and flexible_residues(log) == ALL4
    first_sdf, first_flex = out.read_text(), flex_out.read_text()
    assert first_flex.count("MODEL") == len(sdf_blocks(first_sdf)) >= 1
    # the checkpoint of a finished run, as a killed run leaves it
    (d / "pdbqt.sdf.partial").write_text(
        "#GNINA_TPU_IDX 0 CHEMBL371307_PLANTS_09\n" + first_sdf
        + "#GNINA_TPU_FLEX 0\n" + first_flex)
    rc, log = run(tcli, argv + ["--resume"], d / "resume.log")
    assert rc == 0 and "(resumed)" in log
    assert out.read_text() == first_sdf
    assert flex_out.read_text() == first_flex


@pytest.mark.parametrize("case", ["placed", "position"])
def test_covalent_dock_pins_the_attachment_atom(files, case):
    """A covalent docking job onto the fixture's CYS SG: every pose's
    attachment atom (the warhead's first atom) where build_covalent_complex
    placed it (or at --covalent_lig_atom_position, with the fix and
    optimize flags), within 1e-3 A."""
    from gnina_tpu_torch.chem import covalent

    d = files["dir"]
    flags = ["-r", "REC", "-l", "WARHEAD", "--covalent_rec_atom",
             f"A:{CYS}:SG", "--covalent_lig_atom_pattern", "[$(C=C)]"]
    cinfo = covalent.CovInfo(covalent.CovOptions(
        covalent_rec_atom=f"A:{CYS}:SG",
        covalent_lig_atom_pattern="[$(C=C)]"), log=lambda *a: None)
    mol = next(tingest.iter_molecules(files["warhead"]))
    _, placed = covalent.build_covalent_complex(files["trec"], mol, cinfo)
    at = placed[0].orig_coords[0]
    if case == "position":
        at = np.round(at + np.array([0.2, -0.1, 0.1]), 3)
        flags += ["--covalent_lig_atom_position",
                  ",".join(f"{v:.3f}" for v in at),
                  "--covalent_fix_lig_atom_position",
                  "--covalent_optimize_lig"]
    argv = args_of(files, flags + ["-o", str(d / f"cov_{case}.sdf"),
                                   "--device", "cpu"] + files["box"] + DOCK)
    rc, log = run(tcli, argv, d / f"cov_{case}.log")
    assert rc == 0
    poses = sdf_blocks((d / f"cov_{case}.sdf").read_text())
    assert poses and all(np.isfinite(e) for e, _ in poses)
    for _, xyz in poses:
        np.testing.assert_allclose(xyz[0], at, rtol=0, atol=1e-3)


def test_outputmin_writes_the_trajectory(files, monkeypatch):
    """--minimize --outputmin 4 writes minout.sdf in the working directory:
    5 frames an accepted step (factors 0, 1/4, .., 1), each step starting
    where the last ended within 1e-2 A, the first frame the input and the
    last the minimized pose.  (A step's frames rotate by the rotation
    vector of q1 q0*, taken through arccos in float32 as the JAX package
    takes it: a rotation under about 1e-3 rad is lost, so a late, small
    step's last frame can sit a few 1e-3 A from the next step's first.)"""
    d = files["dir"]
    monkeypatch.chdir(d)
    argv = args_of(files, ["-r", "REC", "-l", "ONE", "--flexres", SPEC,
                           "--minimize", "--outputmin", "4", "-o",
                           str(d / "min.sdf"), "--cnn_scoring", "none",
                           "--device", "cpu"])
    rc, log = run(tcli, argv, d / "outputmin.log")
    assert rc == 0
    frames = np.array([x for _, x in sdf_blocks(
        (d / "minout.sdf").read_text())])
    assert f"Wrote minout.sdf ({len(frames)} frames)" in log
    assert len(frames) >= 5 and len(frames) % 5 == 0
    assert np.isfinite(frames).all()
    np.testing.assert_allclose(frames[4:-1:5], frames[5::5], atol=1e-2)
    lig = fx.ligand()
    np.testing.assert_allclose(frames[0], lig.orig_coords, atol=1e-3)
    minimized = sdf_blocks((d / "min.sdf").read_text())[0][1]
    np.testing.assert_allclose(frames[-1], minimized, atol=1e-3)


def test_python_m_entry_point_runs_a_flex_job(files):
    """`python -m gnina_tpu_torch` itself with --no_lig --flexres
    --score_only and --device cpu: rc 0, a finite affinity."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "gnina_tpu_torch", "-r", files["rec"],
         "--no_lig", "--flexres", SPEC, "--score_only", "--cnn_scoring",
         "none", "--device", "cpu"], capture_output=True, text=True,
        env=env, timeout=300, cwd=str(files["dir"]))
    assert out.returncode == 0, out.stderr
    aff = re.findall(r"Affinity: (\S+)", out.stdout)
    assert len(aff) == 1 and np.isfinite(float(aff[0]))
    assert flexible_residues(out.stdout) == BY_RESID


# ------------------------------------- writers and the trajectory vs JAX ----

@pytest.fixture(scope="module")
def complexes(files):
    """Both packages' complex of the ligand and the four residues, and
    their stripped receptors, from the same files."""
    jrec = jingest.Receptor.from_file(files["rec"])
    trec = files["trec"]
    jfr = [jflex.extract_flex_residue(jrec, k) for k in fx.FLEXDIST_35]
    tfr = [tflex.extract_flex_residue(trec, k) for k in fx.FLEXDIST_35]
    return dict(
        jc=jattach(next(jingest.iter_ligands(files["one"])), jfr),
        tc=tattach(next(tingest.iter_ligands(files["one"])), tfr),
        jrigid=jflex.strip_flex_from_receptor(jrec, jfr),
        trigid=tflex.strip_flex_from_receptor(trec, tfr))


@pytest.mark.parametrize("full", [False, True], ids=["flex", "full"])
def test_write_flex_pdb_equals_jax(complexes, full):
    """write_flex_pdb on the same three poses (the input moved by seeded
    noise), with and without the rigid receptor: byte for byte JAX's."""
    rng = np.random.default_rng(7)
    tc = complexes["tc"]
    poses = [types.SimpleNamespace(coords=tc.orig_coords + rng.normal(
        scale=0.5, size=tc.orig_coords.shape).astype(np.float32))
        for _ in range(3)]
    j = joutput.write_flex_pdb(
        complexes["jc"], poses,
        rigid=complexes["jrigid"].mol if full else None)
    t = toutput.write_flex_pdb(
        tc, poses, rigid=complexes["trigid"].mol if full else None)
    assert t == j
    assert t.count("MODEL") == 3
    assert toutput.write_flex_pdb(fx.ligand(), poses) == ""


def test_minimize_trajectory_equals_jax(complexes):
    """minimize_trajectory (--outputmin 4) of the flex complex: the same
    frame layout, and the frames of the first 10 accepted steps within
    1e-3 A of JAX's (two float32 codes part further with every step: the
    step counts themselves may differ)."""
    kw = dict(cnn_scoring="none", outputmin_frames=4)
    j = jdocking.DockingEngine(jdocking.DockSettings(**kw)) \
        .minimize_trajectory(complexes["jrigid"], complexes["jc"])
    t = tdocking.DockingEngine(tdocking.DockSettings(**kw), device="cpu") \
        .minimize_trajectory(complexes["trigid"], complexes["tc"])
    assert t.shape[1:] == j.shape[1:] == (43, 3)
    assert len(t) % 5 == 0 and len(j) % 5 == 0 and len(t) >= 50
    np.testing.assert_allclose(t[:50], j[:50], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(t[0], complexes["tc"].orig_coords)


def test_atom_terms_under_flex_equal_jax(complexes):
    """--atom_terms of a flex pose: the ligand's rows with the receptor
    and the flex and inflex atoms as partners, within 1e-5 relative of
    JAX's table."""
    rng = np.random.default_rng(8)
    tc = complexes["tc"]
    coords = tc.orig_coords + rng.normal(scale=0.3, size=tc.orig_coords.shape
                                         ).astype(np.float32)
    j = jatom_terms(jget_sf("vina"), complexes["jc"], complexes["jrigid"],
                    coords)
    t = tatom_terms(tget_sf("vina"), tc, complexes["trigid"], coords,
                    device="cpu")
    tl, jl = t.splitlines(), j.splitlines()
    assert len(tl) == len(jl) == tc.lig_atoms + 2
    assert tl[0] == jl[0] and tl[-1] == jl[-1] == "END"
    tv = np.array([[float(v) for v in x.split(") ")[1].split()]
                   for x in tl[1:-1]])
    jv = np.array([[float(v) for v in x.split(") ")[1].split()]
                   for x in jl[1:-1]])
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5 * np.abs(
        jv).max())
    # the flex atoms are partners: the table moves with them
    moved = coords.copy()
    moved[tc.lig_atoms:tc.movable_atoms] += 50.0
    t2 = tatom_terms(tget_sf("vina"), tc, complexes["trigid"], moved,
                     device="cpu")
    assert t2 != t
