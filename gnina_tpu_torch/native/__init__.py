"""Host bond perception in C++, loaded with ctypes.

Counterpart of the JAX package's gnina_tpu/native: perceive.cpp (a copy of
that source) finds the bonded atom pairs of a molecule by covalent radii
on a cell list, the host-side step that chem/mol.Molecule.perceive_bonds
runs for every PDB/XYZ input (a 3,304-atom receptor: about a millisecond,
against seconds in the pure-Python loop).  It is built with g++ at first
use into gnina_tpu_torch/_build/ (ignored by git), under a name keyed by
the source, the flags and the host CPU, so a library built on one machine
is never loaded on another; nothing builds at import time.  Without g++
perceive_bonds_native returns None, and the caller keeps its pure-Python
loop after one line on stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "perceive.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
# the JAX package's flags (gnina_tpu/native/__init__.py), so that both
# round the distance test alike
FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_WARNED = False


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags")):
                    return line
    except OSError:
        pass
    return ""


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    h.update(_cpu_model().encode())
    return os.path.join(BUILD_DIR, f"libperceive_{h.hexdigest()[:16]}.so")


def _build(out: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run(["g++"] + FLAGS + [SOURCE, "-o", tmp], check=True,
                       capture_output=True, timeout=120)
    except (subprocess.SubprocessError, OSError):
        return False
    os.replace(tmp, out)
    return True


def get_lib() -> Optional[ctypes.CDLL]:
    """The perception library, built on first use; None without g++."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        out = library_path()
        if not os.path.exists(out) and not _build(out):
            return None
        try:
            lib = ctypes.CDLL(out)
        except OSError:
            return None
        lib.perceive_bonds.restype = ctypes.c_int
        lib.perceive_bonds.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int,
        ]
        _LIB = lib
        return _LIB


def loaded() -> bool:
    """Whether the native library is loaded (building it if need be)."""
    return get_lib() is not None


def warn_fallback() -> None:
    """One line on stderr, once a process, when the Python loop runs."""
    global _WARNED
    if not _WARNED:
        _WARNED = True
        sys.stderr.write("gnina_tpu_torch: native bond perception not "
                         "loaded; using the Python loop\n")


def perceive_bonds_native(coords: np.ndarray, radii: np.ndarray,
                          anums: np.ndarray, tolerance: float = 0.45
                          ) -> Optional[np.ndarray]:
    """(P, 2) bonded index pairs, or None if the library is missing."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(anums)
    coords = np.ascontiguousarray(coords, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    anums = np.ascontiguousarray(anums, np.int32)

    def call(max_pairs):
        out = np.empty((max_pairs, 2), np.int32)
        cnt = lib.perceive_bonds(
            coords.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            radii.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            anums.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            n, ctypes.c_float(tolerance),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), max_pairs)
        return cnt, out

    max_pairs = max(8 * n, 1024)
    cnt, out = call(max_pairs)
    if cnt < 0:
        return None
    if cnt > max_pairs:  # an extremely dense system: again, with room
        cnt, out = call(cnt)
    return out[:cnt].copy()
