"""Build and load the CUDA sources under csrc/ on first CUDA use.

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface (gnina_tpu_torch/_build/, ignored by git), named by the
source's hash so an edited source rebuilds, and loaded with ctypes.
Nothing here runs at import time: a machine without nvcc or a card can
import the package and run the plain versions.

  fused_dock.cu  K1-K8, the docking kernels   -> lib()
  probes.cu      K9-K11, the rate probes      -> probes_lib()

build_all() starts one nvcc per source at once; lib() and probes_lib()
build only their own source when it is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {"fused_dock": os.path.join(_PKG, "csrc", "fused_dock.cu"),
           "probes": os.path.join(_PKG, "csrc", "probes.cu")}
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str = "fused_dock") -> str:
    with open(SOURCES[name], "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start(name: str, verbose: bool):
    """Start nvcc on one source: (process, temporary path, final path)."""
    out = library_path(name)
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc()] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else []) \
        + ["-o", tmp, SOURCES[name]]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp: str, out: str, verbose: bool) -> str:
    _, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name} ({proc.returncode}):\n"
                           f"{err}")
    if verbose and err:
        print(err, flush=True)
    os.replace(tmp, out)
    return out


def build(verbose: bool = False, name: str = "fused_dock") -> str:
    """Compile one source (if its library is missing); returns the library
    path.  verbose prints ptxas' register/smem report."""
    out = library_path(name)
    if os.path.exists(out):
        return out
    return _finish(name, *_start(name, verbose), verbose)


def build_all(verbose: bool = False) -> Dict[str, str]:
    """Compile every source whose library is missing, one nvcc each, all
    started together; returns {name: library path}."""
    started = {name: _start(name, verbose) for name in SOURCES
               if not os.path.exists(library_path(name))}
    paths = {name: library_path(name) for name in SOURCES}
    failure: Optional[Exception] = None
    for name, job in started.items():
        try:
            _finish(name, *job, verbose)
        except RuntimeError as e:   # let the other builds end first
            failure = failure or e
    if failure is not None:
        raise failure
    return paths


def _load(name: str) -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(build(name=name))
            _BIND[name](_LIBS[name])
        return _LIBS[name]


def _bind_fused(so) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # the last argument of each: a host int the call sets to the number of
    # kernel launches it made
    so.gt_eval_fg.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
    so.gt_bfgs_minimize.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, cf,
                                    ci, vp, vp, vp, vp, vp, ci, ci, vp, vp]
    # the MC windows: seed, then lane_offset (the global index of lane 0)
    so.gt_async_mc_window.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                      ctypes.c_uint32, ci, ci, ci, ci, ci,
                                      cf, ci, vp, vp, vp, vp, vp, vp, vp,
                                      vp, vp]
    so.gt_lockstep_mc_window.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                         ctypes.c_uint32, ci, ci, ci, ci,
                                         cf, ci, vp, vp, vp, vp, vp, vp,
                                         vp, vp, ci, ci, vp, vp]
    for fn in (so.gt_eval_fg, so.gt_bfgs_minimize,
               so.gt_async_mc_window, so.gt_lockstep_mc_window):
        fn.restype = ci
    so.gt_error_string.argtypes = [ci]
    so.gt_error_string.restype = ctypes.c_char_p


def _bind_probes(so) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    cu = ctypes.c_uint32
    so.gt_probe_pairs.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
                                  ci, ci, vp, cu, vp, vp]
    so.gt_probe_gather.argtypes = [vp, vp, vp, ci, ci, ci, vp, cu, vp, vp]
    so.gt_probe_mxu.argtypes = [vp, vp, ci, ci, ci, vp, cu, vp, vp]
    so.gt_probe_empty.argtypes = [ci, ci, vp]
    for fn in (so.gt_probe_pairs, so.gt_probe_gather, so.gt_probe_mxu,
               so.gt_probe_empty):
        fn.restype = ci
    so.gt_probe_error_string.argtypes = [ci]
    so.gt_probe_error_string.restype = ctypes.c_char_p


_BIND = {"fused_dock": _bind_fused, "probes": _bind_probes}


def lib() -> ctypes.CDLL:
    """The loaded docking-kernel library, built on first use."""
    return _load("fused_dock")


def probes_lib() -> ctypes.CDLL:
    """The loaded probe library, built on first use."""
    return _load("probes")


def error_string(code: int) -> str:
    return lib().gt_error_string(int(code)).decode()
