"""The port's gninagrid (gnina_tpu_torch/tools/gninagrid.py) against the JAX
package's on the CPU.

The system is moved near the origin (the JAX voxelizer's expanded squared
distance is good to 1e-4 only within about 30 A of it): the first records
of minout.sdf shifted by one vector so that the first one's heavy centre
lies at the origin, and a synthetic receptor around it.  Grids are held to
JAX's within 1e-4 (text files: 1e-4 plus the print's rounding); file names
and header lines must be equal.  --random_rotation is held to JAX's
make_grid under the rotation that the port drew (the JAX tool draws from a
threefry key, which torch cannot replay).  --separate with -g is the one
layout that differs: the JAX file lacks the receptor channels.
"""

import os

import numpy as np
import pytest
import torch

from gnina_tpu.chem import ingest as jingest
from gnina_tpu.models.typer import default_lig_typer as jlig_typer, \
    default_rec_typer as jrec_typer
from gnina_tpu.tools import gninagrid as jg
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch.chem import ingest as tingest
from gnina_tpu_torch.models.typer import default_lig_typer, \
    default_rec_typer
from gnina_tpu_torch.tools import gninagrid as tg

TOL = 1e-4
DIM = ["--dimension", "6"]          # 13^3 points at the default 0.5 A
NPTS = 13


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once, and
    oversubscribed OpenMP threads spin instead of working."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def write_origin_system(directory, n_ligs: int = 3, seed: int = 2,
                        cube: float = 16.0, cavity: float = 7.0):
    """The first `n_ligs` records of minout.sdf moved by one vector so that
    the first one's heavy centre lies at the origin, and a synthetic
    receptor around the origin with a cavity of radius `cavity`: (ligand
    path, receptor path)."""
    shift = fx.ligand_center(fx.ligand())
    blocks = open(fx.LIGAND_SDF).read().split("$$$$\n")[:n_ligs]
    out = []
    for block in blocks:
        lines = block.splitlines()
        na = int(lines[3][:3])
        for i in range(4, 4 + na):
            xyz = [float(lines[i][10 * k:10 * k + 10]) - shift[k]
                   for k in range(3)]
            lines[i] = "".join(f"{v:10.4f}" for v in xyz) + lines[i][30:]
        out.append("\n".join(lines) + "\n$$$$\n")
    lig_path = os.path.join(str(directory), "ligs.sdf")
    rec_path = os.path.join(str(directory), "rec.pdb")
    with open(lig_path, "w") as f:
        f.write("".join(out))
    with open(rec_path, "w") as f:
        f.write(fx.receptor_pdb_text(np.zeros(3), seed=seed, cube=cube,
                                     cavity=cavity))
    return lig_path, rec_path


@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("gninagrid")
    # a small cavity, so that the 6 A grids hold receptor density too
    lig_path, rec_path = write_origin_system(d, cavity=3.5)
    return dict(lig=lig_path, rec=rec_path,
                jrec=jingest.Receptor.from_file(rec_path),
                trec=tingest.Receptor.from_file(rec_path),
                jligs=list(jingest.iter_ligands(lig_path)),
                tligs=list(tingest.iter_ligands(lig_path)))


# ---------------------------------------------------------- grid functions --

@pytest.mark.parametrize("binary", [False, True], ids=["density", "binary"])
def test_grid_channels_matches_jax(system, binary):
    rt = default_rec_typer()
    rec = system["trec"]
    center = system["tligs"][0].orig_coords.mean(axis=0)
    chans = rt.channels_for(rec.types)
    radii = rt.radii_for(rec.types)
    got = tg.grid_channels(rec.coords, chans, radii, center, rt.num_channels,
                           NPTS, 0.5, binary, device="cpu")
    want = jg.grid_channels(rec.coords, chans, radii, center,
                            rt.num_channels, NPTS, 0.5, binary)
    assert got.shape == want.shape == (rt.num_channels, NPTS, NPTS, NPTS)
    assert np.abs(got).max() > 0.5
    assert np.abs(got - want).max() <= TOL


def test_grid_channels_through_the_slab_window_matches_jax(tmp_path):
    """A receptor wider than the per-slab atom window (729 atoms in a 24 A
    cube, a 12 A grid of 25^3 points): the windowed densities equal JAX's
    voxelizer over every atom."""
    from gnina_tpu_torch.ops.voxelize import slab_window_size

    path = tmp_path / "wide.pdb"
    path.write_text(fx.receptor_pdb_text(np.zeros(3), seed=3, cube=24.0,
                                         cavity=3.5))
    rec = tingest.Receptor.from_file(str(path))
    rt = default_rec_typer()
    chans, radii = rt.channels_for(rec.types), rt.radii_for(rec.types)
    window = slab_window_size(np.sort(rec.coords[:, 0]),
                              1.5 * float(radii.max()) + 0.5)
    assert window < len(rec.types) - 128
    center = np.array([0.7, -0.4, 1.1], np.float32)
    got = tg.grid_channels(rec.coords, chans, radii, center, 14, 25, 0.5,
                           device="cpu")
    want = jg.grid_channels(rec.coords, chans, radii, center, 14, 25, 0.5)
    assert np.abs(got).max() > 0.5
    assert np.abs(got - want).max() <= TOL


_POSES = {
    "plain": (None, None),
    "rotation": (tg.random_rotation(7), None),
    "translation": (None, np.array([0.4, -0.9, 1.3], np.float32)),
    "both": (tg.random_rotation(8), np.array([-1.1, 0.2, 0.6], np.float32)),
}


@pytest.mark.parametrize("pose", list(_POSES))
def test_make_grid_matches_jax(system, pose):
    rotation, translation = _POSES[pose]
    rec = system["trec"]
    for lig in system["tligs"]:
        c = lig.orig_coords.mean(axis=0)
        got = tg.make_grid(rec.coords, rec.types, lig.orig_coords, lig.types,
                           c, default_rec_typer(), default_lig_typer(), 0.5,
                           6.0, rotation, translation, device="cpu")
        want = jg.make_grid(rec.coords, rec.types, lig.orig_coords,
                            lig.types, c, jrec_typer(), jlig_typer(), 0.5,
                            6.0, rotation, translation)
        assert got.shape == want.shape == (28, NPTS, NPTS, NPTS)
        assert np.abs(got[:14]).max() > 0.5      # the receptor and
        assert np.abs(got[14:]).max() > 0.5      # the ligand are on the grid
        assert np.abs(got - want).max() <= TOL


def test_random_rotation_is_a_rotation():
    r = tg.random_rotation(3)
    assert np.allclose(r @ r.T, np.eye(3), atol=1e-5)
    assert np.isclose(np.linalg.det(r), 1.0, atol=1e-5)
    assert np.array_equal(r, tg.random_rotation(3))
    assert not np.allclose(r, tg.random_rotation(4))


def test_dx_and_map_writers_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    grid = rng.random((7, 7, 7), dtype=np.float32) * 2.0
    grid[0, 0, :3] = [0.0, 1e-7, 123.456789]
    center = np.array([1.25, -3.5, 0.125])
    for name in ("write_dx", "write_map"):
        a, b = tmp_path / f"t_{name}", tmp_path / f"j_{name}"
        getattr(tg, name)(str(a), grid, center, 0.375)
        getattr(jg, name)(str(b), grid, center, 0.375)
        assert a.read_text() == b.read_text(), name
    tg.write_binmap(str(tmp_path / "t.binmap"), grid)
    jg.write_binmap(str(tmp_path / "j.binmap"), grid)
    assert (tmp_path / "t.binmap").read_bytes() \
        == (tmp_path / "j.binmap").read_bytes()
    dx = str(tmp_path / "t_write_dx")
    got, want = tg.read_dx(dx), jg.read_dx(dx)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1]) and got[2] == want[2] == 0.375
    assert np.abs(got[0] - grid).max() <= 6e-6     # 5 decimals printed
    assert np.allclose(got[1], center, atol=1e-5)


# ----------------------------------------------------------------- main() --

def _numbers(path):
    """(header lines, numbers) of a .dx or .map file."""
    head, vals = [], []
    for line in open(path).read().splitlines():
        try:
            vals.extend(float(v) for v in line.split())
        except ValueError:
            head.append(line)
    return head, np.array(vals)


def _compare_dirs(tdir, jdir):
    names = sorted(os.listdir(jdir))
    assert sorted(os.listdir(tdir)) == names
    assert names
    for name in names:
        a, b = os.path.join(tdir, name), os.path.join(jdir, name)
        if name.endswith(".binmap"):
            x, y = np.fromfile(a, np.float32), np.fromfile(b, np.float32)
            assert x.shape == y.shape, name
            assert np.abs(x - y).max() <= TOL, name
        else:
            (ha, va), (hb, vb) = _numbers(a), _numbers(b)
            assert ha == hb, name
            assert va.shape == vb.shape, name
            # the values' tolerance plus the print's rounding (5 decimals
            # in .dx, 6 significant digits in .map)
            assert np.all(np.abs(va - vb) <= TOL + 1e-5 + 1e-5 * np.abs(vb)), \
                name
    return names


def _run_both(tmp_path, system, flags, extra_t=(), extra_j=()):
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    tdir.mkdir()
    jdir.mkdir()
    base = ["-r", system["rec"], "-l", system["lig"]] + DIM + list(flags)
    assert tg.main(base + ["-o", str(tdir / "g"), "--device", "cpu"]
                   + list(extra_t)) == 0
    assert jg.main(base + ["-o", str(jdir / "g")] + list(extra_j)) == 0
    return str(tdir), str(jdir)


@pytest.fixture(scope="module")
def example_dx(system, tmp_path_factory):
    """A 13^3 .dx grid (one channel of the second ligand's grid) to place
    grids with: --example_grid and -g."""
    d = tmp_path_factory.mktemp("example")
    lig = system["jligs"][1]
    c = lig.orig_coords.mean(axis=0) + np.array([0.3, -0.2, 0.1])
    g = jg.make_grid(system["jrec"].coords, system["jrec"].types,
                     lig.orig_coords, lig.types, c, jrec_typer(),
                     jlig_typer(), 0.5, 6.0)
    path = str(d / "example.dx")
    jg.write_dx(path, g[2], c, 0.5)
    return path


MAIN_CASES = {
    "binmap": [],
    "dx": ["--dx"],
    "map": ["--map"],
    "binary_occupancy": ["--binary_occupancy"],
    "random_translate": ["--random_translate", "1.5", "--seed", "5"],
    "usergrid": ["-g", "EXAMPLE"],
    "usergrid_dx": ["-g", "EXAMPLE", "--dx"],
    "usergrid_map": ["-g", "EXAMPLE", "--map"],
    "separate": ["--separate", "--example_grid", "EXAMPLE"],
    "separate_dx": ["--separate", "--example_grid", "EXAMPLE", "--dx"],
}


@pytest.mark.parametrize("case", list(MAIN_CASES))
def test_main_files_equal_jax(tmp_path, system, example_dx, case):
    flags = [example_dx if f == "EXAMPLE" else f for f in MAIN_CASES[case]]
    names = _compare_dirs(*_run_both(tmp_path, system, flags))
    nlig = len(system["tligs"])
    if case in ("binmap", "binary_occupancy", "random_translate"):
        assert names == [f"g_{i}.{NPTS}.28.binmap" for i in range(nlig)]
    if case == "usergrid":
        assert names == [f"g_{i}.{NPTS}.29.binmap" for i in range(nlig)]
    if case == "usergrid_dx":
        assert "g_0_lig_0.dx" in names
    if case == "usergrid_map":
        assert "g_0_usergrid_0.dx" in names
    if case == "separate":
        assert names == [f"g.{NPTS}.14.binmap"] + [
            f"g_{i}.{NPTS}.14.binmap" for i in range(nlig)]


def test_random_rotation_against_jax_make_grid(tmp_path, system):
    """--random_rotation: each ligand's grid equals JAX's make_grid under the
    rotation the port drew for it (seed + i), the random translations being
    drawn alike."""
    out = str(tmp_path / "rot")
    seed = 11
    assert tg.main(["-r", system["rec"], "-l", system["lig"], "-o", out,
                    "--random_rotation", "--random_translate", "0.8",
                    "--seed", str(seed), "--device", "cpu"] + DIM) == 0
    rng = np.random.RandomState(seed)
    for i, lig in enumerate(system["jligs"]):
        translation = rng.uniform(-0.8, 0.8, 3).astype(np.float32)
        want = jg.make_grid(system["jrec"].coords, system["jrec"].types,
                            lig.orig_coords, lig.types,
                            lig.orig_coords.mean(axis=0), jrec_typer(),
                            jlig_typer(), 0.5, 6.0,
                            tg.random_rotation(seed + i), translation)
        got = np.fromfile(f"{out}_{i}.{NPTS}.28.binmap", np.float32)
        assert np.abs(got - want.ravel()).max() <= TOL
    unrotated = jg.make_grid(system["jrec"].coords, system["jrec"].types,
                             lig.orig_coords, lig.types,
                             lig.orig_coords.mean(axis=0), jrec_typer(),
                             jlig_typer(), 0.5, 6.0, None, translation)
    assert np.abs(got - unrotated.ravel()).max() > 0.1


def test_separate_with_usergrid_keeps_the_receptor(tmp_path, system,
                                                   example_dx):
    """--separate -g: the file is named for 1 user grid + 14 receptor
    channels.  The JAX tool's holds the user grid alone (a precedence slip
    in its concatenation); the port's holds the user grid followed by the
    receptor channels at the user grid's frame.  The ligand files agree."""
    tdir, jdir = _run_both(tmp_path, system, ["--separate", "-g", example_dx])
    name = f"g.{NPTS}.15.binmap"
    jax_full = np.fromfile(os.path.join(jdir, name), np.float32)
    port_full = np.fromfile(os.path.join(tdir, name), np.float32)
    n3 = NPTS ** 3
    assert jax_full.size == n3                   # the JAX slip: 1 channel
    assert port_full.size == 15 * n3
    user, center, res = jg.read_dx(example_dx)
    assert np.array_equal(port_full[:n3], user.ravel())
    assert np.array_equal(jax_full, user.ravel())
    rt = jrec_typer()
    rec = system["jrec"]
    want = jg.grid_channels(rec.coords, rt.channels_for(rec.types),
                            rt.radii_for(rec.types), center, 14, NPTS, res)
    assert np.abs(port_full[n3:] - want.ravel()).max() <= TOL
    assert np.abs(want).max() > 0.5
    for i in range(len(system["tligs"])):
        lig_name = f"g_{i}.{NPTS}.14.binmap"
        a = np.fromfile(os.path.join(tdir, lig_name), np.float32)
        b = np.fromfile(os.path.join(jdir, lig_name), np.float32)
        assert np.abs(a - b).max() <= TOL


def test_refusals_equal_jax(tmp_path, system, example_dx, capsys):
    base = ["-r", system["rec"], "-l", system["lig"], "-o",
            str(tmp_path / "x"), "--device", "cpu"] + DIM
    assert tg.main(base + ["--separate"]) == 1
    assert "--separate specified" in capsys.readouterr().err
    assert tg.main(base + ["-g", example_dx, "--random_rotation"]) == 1
    assert "not supported with user grids" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_main_defaults_to_the_card(system, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tg.main(["-r", system["rec"], "-l", system["lig"], "-o",
                 str(tmp_path / "x")] + DIM)
