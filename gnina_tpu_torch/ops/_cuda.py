"""Build and load csrc/fused_dock.cu on first CUDA use.

The source is compiled with nvcc for sm_90a into a shared library with a
plain C interface (gnina_tpu_torch/_build/, ignored by git), named by the
source's hash so an edited source rebuilds, and loaded with ctypes.
Nothing here runs at import time: a machine without nvcc or a card can
import the package and run the plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "fused_dock.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def library_path() -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libfused_dock_{digest}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this source's library is missing); returns
    the library path.  verbose prints ptxas' register/smem report."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    if verbose and res.stderr:
        print(res.stderr, flush=True)
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        so = ctypes.CDLL(build())
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        so.gt_eval_fg.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        so.gt_bfgs_minimize.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf,
                                        ci, vp, vp, vp, vp, vp]
        so.gt_async_mc_window.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                          ctypes.c_uint32, ci, ci, ci, ci,
                                          cf, ci, vp, vp, vp, vp, vp, vp, vp,
                                          vp]
        so.gt_lockstep_mc_window.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                             ctypes.c_uint32, ci, ci, ci, cf,
                                             ci, vp, vp, vp, vp, vp, vp, vp,
                                             vp]
        for fn in (so.gt_eval_fg, so.gt_bfgs_minimize,
                   so.gt_async_mc_window, so.gt_lockstep_mc_window):
            fn.restype = ci
        so.gt_error_string.argtypes = [ci]
        so.gt_error_string.restype = ctypes.c_char_p
        _LIB = so
        return _LIB


def error_string(code: int) -> str:
    return lib().gt_error_string(int(code)).decode()
