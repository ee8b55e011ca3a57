"""Multi-process screens in the port (gnina_tpu_torch/parallel/multihost.py
and the command line's --dist_* flags) on the CPU, over gloo on 127.0.0.1.

- env_config, host_shard, part_path and merge_part_outputs give what the
  JAX package's give, on the same part files;
- allgather_scalars and barrier across two real processes;
- a rendezvous that cannot complete raises within its timeout;
- a two-process screen (`python -m gnina_tpu_torch --dist_nprocs 2`, two
  subprocesses that meet at a free port): the merged SDF holds every
  ligand once, in input order, and each process's ligands equal a
  one-process screen of that process's round-robin subset, byte for byte
  (a screen docks each batch with the one --seed and the kernels key their
  streams on a ligand's lane in its batch, so the subset screen, not the
  whole one, is what each process reproduces).

Every subprocess and rendezvous is timed out.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch

from gnina_tpu.parallel import multihost as jmh
from gnina_tpu_torch import _fixtures as fx
from gnina_tpu_torch import cli as tcli
from gnina_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240          # seconds for any subprocess
NLIGS = 4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """Two intra-op threads: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "2"
    for k in ("GNINA_TPU_NPROCS", "GNINA_TPU_PROCID",
              "GNINA_TPU_COORDINATOR"):
        env.pop(k, None)
    return env


# ------------------------------------------------------ the copied helpers --

def test_env_config_equals_jax(monkeypatch):
    for k in ("GNINA_TPU_COORDINATOR", "GNINA_TPU_NPROCS",
              "GNINA_TPU_PROCID"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.env_config() == jmh.env_config() == (None, 1, 0)
    monkeypatch.setenv("GNINA_TPU_COORDINATOR", "host0:8476")
    monkeypatch.setenv("GNINA_TPU_NPROCS", "4")
    monkeypatch.setenv("GNINA_TPU_PROCID", "2")
    assert tmh.env_config() == jmh.env_config() == ("host0:8476", 4, 2)


@pytest.mark.parametrize("nprocs", [1, 2, 3, 5])
def test_host_shard_and_part_path_equal_jax(nprocs):
    items = [f"lig{i}" for i in range(11)]
    for pid in range(nprocs):
        got = list(tmh.host_shard(items, pid, nprocs))
        assert got == list(jmh.host_shard(items, pid, nprocs))
        assert all(i % nprocs == pid for i, _ in got)
        assert tmh.part_path("out.sdf", pid) == jmh.part_path("out.sdf", pid)
    shards = [i for pid in range(nprocs)
              for i, _ in tmh.host_shard(items, pid, nprocs)]
    assert sorted(shards) == list(range(11))


def test_merge_part_outputs_equals_jax(tmp_path):
    """Three processes' part files, one missing, blocks out of order and
    one without a trailing newline: the same merged file and count."""
    parts = {0: "#GNINA_TPU_IDX 3 d\nD1\n$$$$\n#GNINA_TPU_IDX 0 a\nA\n$$$$\n",
             2: "#GNINA_TPU_IDX 2 c\nC\n$$$$\n#GNINA_TPU_IDX 5 f\nF\n$$$$"}
    for name in ("port", "jax"):
        for pid, text in parts.items():
            with open(tmp_path / f"{name}.sdf.part{pid}", "w") as f:
                f.write(text)
    n_t = tmh.merge_part_outputs(str(tmp_path / "port.sdf"), 3)
    n_j = jmh.merge_part_outputs(str(tmp_path / "jax.sdf"), 3)
    assert n_t == n_j == 4
    got = (tmp_path / "port.sdf").read_text()
    assert got == (tmp_path / "jax.sdf").read_text()
    assert got == "A\n$$$$\nC\n$$$$\nD1\n$$$$\nF\n$$$$"


def test_single_process_is_a_no_op():
    assert tmh.init(None, 1, 0) is False
    tmh.barrier()
    assert tmh.allgather_scalars([1.5, 2.0]) == [1.5, 2.0]
    with pytest.raises(ValueError, match="coordinator"):
        tmh.init(None, 2, 0)


# ------------------------------------------------------- real processes --

_GATHER = """
import sys
from gnina_tpu_torch.parallel import multihost as mh
pid = int(sys.argv[1])
assert mh.init(sys.argv[2], 2, pid, timeout=60)
mh.barrier()
print(mh.allgather_scalars([pid, pid + 0.5]))
mh.shutdown()
"""


def test_allgather_scalars_across_two_processes():
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _GATHER, str(pid),
                               coord], cwd=REPO, env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in range(2)]
    outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert out.strip() == "[0.0, 0.5, 1.0, 1.5]"


def test_a_rendezvous_that_cannot_complete_raises():
    """Process 1 of 2 alone, at a port where nobody listens: init raises
    after its timeout instead of hanging."""
    code = ("from gnina_tpu_torch.parallel import multihost as mh\n"
            "import sys\n"
            "try:\n"
            f"    mh.init('127.0.0.1:{_free_port()}', 2, 1, timeout=3)\n"
            "except Exception as e:\n"
            "    print('raised', type(e).__name__)\n"
            "    sys.exit(0)\n"
            "sys.exit(1)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_env(),
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.startswith("raised")


@pytest.fixture(scope="module")
def screen_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    lig = fx.ligand()
    rec = d / "rec.pdb"
    rec.write_text(fx.receptor_pdb_text(fx.ligand_center(lig), seed=4,
                                        cube=22.0))
    blocks = open(fx.LIGAND_SDF).read().split("$$$$\n")[:NLIGS]
    named = [f"lig_{i}" + b[b.index("\n"):] + "$$$$\n"
             for i, b in enumerate(blocks)]
    (d / "ligs.sdf").write_text("".join(named))
    for pid in range(2):
        (d / f"subset{pid}.sdf").write_text("".join(named[pid::2]))
    return d


def _screen_args(d, ligs, out):
    return ["-r", str(d / "rec.pdb"), "-l", str(ligs), "--autobox_ligand",
            str(d / "ligs.sdf"), "--cnn_scoring", "none", "--num_mc_steps",
            "16", "--exhaustiveness", "2", "--num_mc_saved", "2",
            "--num_modes", "2", "--seed", "5", "-o", str(out),
            "--device", "cpu"]


def _records_by_name(text):
    """{ligand name: its records' text}, in order of appearance."""
    out = {}
    for rec in text.split("$$$$\n"):
        if rec.strip():
            name = rec.split("\n", 1)[0]
            out[name] = out.get(name, "") + rec + "$$$$\n"
    return out


def test_two_process_screen(screen_files):
    d = screen_files
    out = d / "merged.sdf"
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "gnina_tpu_torch"]
        + _screen_args(d, d / "ligs.sdf", out)
        + ["--dist_nprocs", "2", "--dist_procid", str(pid),
           "--dist_coordinator", coord], cwd=str(d), env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (o, err) in zip(procs, outs):
        assert p.returncode == 0, o + err
    assert "Merged 4 ligand(s) from 2 process part files" in outs[0][0]
    merged = _records_by_name(out.read_text())
    assert list(merged) == [f"lig_{i}" for i in range(NLIGS)]
    for pid in range(2):
        sub = d / f"subset{pid}.out.sdf"
        assert tcli.main(_screen_args(d, d / f"subset{pid}.sdf", sub)
                         + ["-q"]) == 0
        alone = _records_by_name(sub.read_text())
        assert list(alone) == [f"lig_{i}" for i in range(pid, NLIGS, 2)]
        for name, text in alone.items():
            assert merged[name] == text, name
