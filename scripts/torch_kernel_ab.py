"""Time the fused docking kernels of several builds of csrc/fused_dock.cu on
one card, in turns (A, B, ..., ..., B, A), at the main path's shapes.

    python scripts/torch_kernel_ab.py OLD.cu NEW.cu [...]

Each source is compiled with the port's nvcc flags into its own library
under gnina_tpu_torch/_build/ab/ and bound in place of the package's; a
source from before the shared-memory plan (no `rec_tile` in its PackArgs)
gets the older argument block.  For each source it prints the K3 window
(L=128, S=128, tick budget 16, the main path's miniters, Philox), K2 (L=128,
from perturbed poses) and K1 (L=128) in ms, median of CUDA-event timings,
on the main path's receptor (a 20 A box, K=2,157 at seed 0); the last
source is also timed on a receptor above the shared-memory budget (a 34 A
box, K=6,154), and the card's name and power limit close the output.
Imports no JAX.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gnina_tpu_torch import _fixtures as fx  # noqa: E402
from gnina_tpu_torch.chem.ingest import box_from_center_size  # noqa: E402
from gnina_tpu_torch.ops import _cuda  # noqa: E402
from gnina_tpu_torch.ops import fused_dock as fd  # noqa: E402
from gnina_tpu_torch.scoring.builtin import get_scoring_function  # noqa: E402

NEW_ARGS = fd._pack_args


class _OldPackArgs(ctypes.Structure):
    _fields_ = fd._PackArgs._fields_[:-1]


def _old_pack_args(pack, device):
    a, b = _OldPackArgs(), NEW_ARGS(pack, device)
    for f, _ in _OldPackArgs._fields_:
        setattr(a, f, getattr(b, f))
    return a


def build(sources):
    """{source: (library, older argument block)}, all nvcc started
    together."""
    out_dir = os.path.join(_cuda.BUILD_DIR, "ab")
    os.makedirs(out_dir, exist_ok=True)
    jobs = {}
    for i, src in enumerate(sources):
        so = os.path.join(out_dir, f"ab{i}.so")
        jobs[src] = (so, subprocess.Popen(
            [_cuda._nvcc()] + _cuda.NVCC_FLAGS + ["-o", so, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for src, (so, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{err}")
        lib = ctypes.CDLL(os.path.abspath(so))
        _cuda._bind_fused(lib)
        with open(src) as f:
            libs[src] = (lib, "rec_tile" not in f.read())
    return libs


def use(lib, old_abi):
    _cuda._LIBS["fused_dock"] = lib
    fd._pack_args = _old_pack_args if old_abi else NEW_ARGS


def system(box, cube, dev):
    rec, lig, center, size = fx.system(seed=0, box=box, cube=cube)
    sf = get_scoring_function("vina")
    pruned = rec.pruned(np.asarray(center), np.asarray(size) / 2,
                        margin=sf.cutoff)
    lo, hi = box_from_center_size(center, size)
    pack = fd.build_pack([lig] * 16, pruned.coords, pruned.types,
                         np.ones(len(pruned.types), np.float32), 8, sf.table,
                         m_pad=4, device=dev)
    return lig, pack, lo, hi, fd.extract_vina_terms(sf)


def timed(fn, n):
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return float(np.median(ts))


def main(sources):
    dev = torch.device("cuda")
    libs = build(sources)
    for box, cube in ((20.0, 40.0), (34.0, 60.0)):
        lig, pack, lo, hi, terms = system(box, cube, dev)
        scal_h = fd.scal_vector(10.0, 10.0, 1e3, 1000.0, lo, hi, 2.0, 1.2,
                                device=dev)
        scal_r = fd.scal_vector(1000.0, 1000.0, 1e3, 1000.0, lo, hi,
                                device=dev)
        miniters = max(int((25 + lig.num_atoms) / 3), 1)
        rng = np.random.default_rng(0)
        r, t = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev, "random")
        rp, tp = fx.packed_poses(rng, pack.lanes, lo, hi, lig, 4, dev,
                                 "perturbed")
        ecur = torch.full((pack.lanes,), 3.0e38, device=dev)
        order = (sources + sources[::-1] if box == 20.0 else sources[-1:])
        for src in order:
            use(*libs[src])
            window = lambda: fd.async_mc_window(
                terms, r, t, scal_h, pack, ecur, 128, 16, miniters, seed=2)
            k3 = timed(window, 3)
            out = window()
            k2 = timed(lambda: fd.bfgs_minimize(terms, rp, tp, scal_r, pack,
                                                miniters), 5)
            k1 = timed(lambda: fd.eval_fg(terms, rp, tp, scal_r, pack), 5)
            print(f"K={pack.rec.shape[0]} {src}: K3 {k3:.3f} ms (evaluations "
                  f"{int(out[2][:, 2].sum())}, steps {int(out[2][:, 4].sum())}"
                  f"), K2 {k2:.3f} ms, K1 {k1:.4f} ms", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        sys.exit(__doc__)
    main(sys.argv[1:])
