"""The PyTorch port stands alone: importing it loads neither JAX nor any
module of the JAX package, and no port source imports one."""

import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "gnina_tpu_torch")
_IMPORT_JAX_PKG = re.compile(r"^\s*(from|import)\s+gnina_tpu(\.|\s|$)")
_IMPORT_JAX = re.compile(r"^\s*(from|import)\s+(jax|jaxlib)(\.|\s|$)")


def _port_sources():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(root, f)


_MODULES = ["gnina_tpu_torch", "gnina_tpu_torch.docking",
            "gnina_tpu_torch.ops.fused_dock", "gnina_tpu_torch.ops.mc_fused",
            "gnina_tpu_torch.convert", "gnina_tpu_torch._fixtures",
            "gnina_tpu_torch.ops.voxelize", "gnina_tpu_torch.models.typer",
            "gnina_tpu_torch.models.runtime",
            "gnina_tpu_torch.models.registry",
            "gnina_tpu_torch.models.scorer",
            "gnina_tpu_torch.models.debug_out", "gnina_tpu_torch.cli",
            "gnina_tpu_torch.probes", "gnina_tpu_torch.ops.bfgs",
            "gnina_tpu_torch.ops._cuda", "gnina_tpu_torch.output",
            "gnina_tpu_torch.scoring.atom_terms",
            "gnina_tpu_torch.chem.smarts", "gnina_tpu_torch.chem.flexinfo",
            "gnina_tpu_torch.chem.covalent", "gnina_tpu_torch.chem.molcache",
            "gnina_tpu_torch.models.torchscript_import",
            "gnina_tpu_torch.tools.gninagrid",
            "gnina_tpu_torch.tools.gninatyper",
            "gnina_tpu_torch.tools.gninavis", "gnina_tpu_torch.tools.server",
            "gnina_tpu_torch.tools.server_client",
            "gnina_tpu_torch.tools.tognina",
            "gnina_tpu_torch.tools.fromgnina",
            "gnina_tpu_torch.ops.jax_random",
            "gnina_tpu_torch.parallel.mesh",
            "gnina_tpu_torch.parallel.multihost",
            "gnina_tpu_torch.models.train", "gnina_tpu_torch.native"]


@pytest.mark.parametrize("module", _MODULES)
def test_import_loads_no_jax(module):
    code = (
        "import sys, importlib\n"
        f"importlib.import_module({module!r})\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') "
        "or m.startswith(('jax.', 'jaxlib.')) or m == 'gnina_tpu' "
        "or m.startswith('gnina_tpu.'))\n"
        "print(','.join(bad))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def test_no_port_source_imports_jax_package():
    offenders = []
    for path in _port_sources():
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f, 1):
                if _IMPORT_JAX_PKG.match(line) or _IMPORT_JAX.match(line):
                    offenders.append(f"{os.path.relpath(path, REPO)}:{i}")
    assert not offenders, offenders


def test_chip_smoke_imports_no_jax():
    """chip_smoke.py imports neither JAX nor the JAX package (it reads the
    converted CNN models as data files)."""
    with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as f:
        lines = f.read().splitlines()
    bad = [i for i, line in enumerate(lines, 1)
           if _IMPORT_JAX_PKG.match(line) or _IMPORT_JAX.match(line)]
    assert not bad, bad


def test_tf32_is_off_after_import():
    import torch

    import gnina_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_default_device_without_card_raises():
    """device=None means the card; with no card the engine refuses instead
    of running on the CPU."""
    import torch

    from gnina_tpu_torch.docking import DockingEngine, DockSettings

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DockingEngine(DockSettings(cnn_scoring="none"))


def test_entry_points_without_card_raise(tmp_path):
    """The command line and the probe script run on the card unless told
    otherwise: without one they raise, they do not fall back to the CPU."""
    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import cli, probes

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rec = tmp_path / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(fx.ligand()),
                                        seed=1, cube=12.0))
    argv = ["-r", str(rec), "-l", fx.LIGAND_SDF, "--score_only",
            "--cnn_scoring", "none", "-q"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(argv + ["--device", "0"])       # gnina's GPU number
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probes.main([])


@pytest.mark.parametrize("builder", [
    "build_pack", "scal_vector", "pad_ligand", "pad_receptor",
    "initial_conf", "empty_container", "randomize_conf", "mc_init",
    "random_orientation", "draw_mutation", "load_model", "SpecModule",
    "CNNScorer", "cnn_model_from_numpy", "per_atom_term_values",
    "atom_terms_table"])
def test_building_blocks_default_to_the_card(builder):
    """The public building blocks take device=None as the card too: with no
    card they raise instead of building CPU tensors."""
    import numpy as np
    import torch

    from gnina_tpu_torch import _fixtures as fx
    from gnina_tpu_torch import convert
    from gnina_tpu_torch.models import registry, runtime, scorer
    from gnina_tpu_torch.ops import fused_dock as fd
    from gnina_tpu_torch.ops import mc, quat
    from gnina_tpu_torch.scoring import atom_terms
    from gnina_tpu_torch.scoring.builtin import get_scoring_function
    from gnina_tpu_torch.types import initial_conf, pad_ligand, pad_receptor

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    lig = fx.ligand()
    gen = torch.Generator().manual_seed(0)
    z = np.zeros(3)
    calls = {
        "build_pack": lambda: fd.build_pack(
            [lig], np.zeros((1, 3)), [0], np.ones(1), 1,
            get_scoring_function("vina").table),
        "scal_vector": lambda: fd.scal_vector(1, 1, 1, 1, z, z),
        "pad_ligand": lambda: pad_ligand(lig, 24, 4, 96),
        "pad_receptor": lambda: pad_receptor(np.zeros((1, 3)), [0], [0.0], 8),
        "initial_conf": lambda: initial_conf(lig, 3),
        "empty_container": lambda: mc.empty_container((1,), 2, 3, 8),
        "randomize_conf": lambda: mc.randomize_conf(2, z, z + 1, 3, gen),
        "mc_init": lambda: mc.mc_init(2, 4, mc.MCParams(), z, z + 1, 8, gen,
                                      lambda r, t: None),
        "random_orientation": lambda: quat.random_orientation((2,), gen),
        "draw_mutation": lambda: mc.draw_mutation(
            gen, torch.tensor([3, 3]), torch.tensor([True, True])),
        "load_model": lambda: registry.load_model(registry.FAST_MODEL),
        "SpecModule": lambda: runtime.SpecModule(
            {"input": "x", "ops": [], "output": ["x"]}, {}),
        "CNNScorer": lambda: scorer.CNNScorer(["fast"]),
        "cnn_model_from_numpy": lambda: convert.cnn_model_from_numpy(
            {"input": "x", "ops": [], "output": ["x"]}, {}),
        "per_atom_term_values": lambda: atom_terms.per_atom_term_values(
            get_scoring_function("vina"), lig.types, lig.orig_coords,
            lig.charges, lig.types, lig.orig_coords, lig.charges),
        "atom_terms_table": lambda: atom_terms.atom_terms_table(
            get_scoring_function("vina"), lig,
            fx.receptor(fx.ligand_center(lig), 1, cube=12.0)),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[builder]()
