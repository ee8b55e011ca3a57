"""Build and load the CUDA sources under csrc/ on first CUDA use.

Each source is compiled with nvcc for sm_90a into a shared library with a
plain C interface (gnina_tpu_torch/_build/, ignored by git), named by the
source's hash so an edited source rebuilds, and loaded with ctypes.
Nothing here runs at import time: a machine without nvcc or a card can
import the package and run the plain versions.

  fused_dock.cu  K1-K8, the docking kernels   -> lib()
  probes.cu      K9-K11, the rate probes      -> probes_lib()
  voxelize.cu    the CNN rescore's voxeliser  -> voxelize_lib()

build_all() starts one nvcc per source at once; lib(), probes_lib() and
voxelize_lib() build only their own source when it is missing.
occupancy() reads a kernel's resident blocks an SM from the CUDA driver,
on a module loaded from the library's own device code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = {"fused_dock": os.path.join(_PKG, "csrc", "fused_dock.cu"),
           "probes": os.path.join(_PKG, "csrc", "probes.cu"),
           "voxelize": os.path.join(_PKG, "csrc", "voxelize.cu")}
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


def _bind_voxelize(so) -> None:
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so.gt_voxelize.argtypes = [vp, vp, vp, vp, vp, ci, vp, vp, vp, vp, ci,
                               vp, ci, ci, ci, cf, cf, cf, vp, vp]
    so.gt_voxelize.restype = ci
    so.gt_voxelize_error_string.argtypes = [ci]
    so.gt_voxelize_error_string.restype = ctypes.c_char_p


_BIND = {"fused_dock": _bind_fused, "probes": _bind_probes,
         "voxelize": _bind_voxelize}


def lib() -> ctypes.CDLL:
    """The loaded docking-kernel library, built on first use."""
    return _load("fused_dock")


def probes_lib() -> ctypes.CDLL:
    """The loaded probe library, built on first use."""
    return _load("probes")


def voxelize_lib() -> ctypes.CDLL:
    """The loaded voxeliser library, built on first use."""
    return _load("voxelize")


def error_string(code: int) -> str:
    return lib().gt_error_string(int(code)).decode()


def fatbinary(name: str = "fused_dock") -> bytes:
    """The `.nv_fatbin` section of a source's library (built if missing):
    the device code its runtime registers, one or more fatbinaries."""
    with open(build(name=name), "rb") as f:
        elf = f.read()
    shoff, = struct.unpack_from("<Q", elf, 0x28)
    shentsize, shnum, shstrndx = struct.unpack_from("<HHH", elf, 0x3A)

    def section(i):     # (name offset, file offset, size) of an ELF64 header
        h = struct.unpack_from("<IIQQQQ", elf, shoff + i * shentsize)
        return h[0], h[4], h[5]

    strtab = section(shstrndx)[1]
    for i in range(shnum):
        at, off, size = section(i)
        start = strtab + at
        if elf[start:elf.index(b"\0", start)] == b".nv_fatbin":
            return elf[off:off + size]
    raise RuntimeError(f"lib{name}: no .nv_fatbin section")


FATBIN_MAGIC = 0xBA55ED50


def fatbin_images(section: bytes) -> List[bytes]:
    """The fatbinaries of a `.nv_fatbin` section, each as the driver's
    module loader takes it: a header (magic, version, header size, payload
    size) and its payload, the next at the following 8-byte boundary."""
    images, at = [], 0
    while at + 16 <= len(section):
        magic, _version, head, size = struct.unpack_from("<IHHQ", section,
                                                         at)
        if magic != FATBIN_MAGIC:
            raise RuntimeError(f"no fatbinary header at byte {at}")
        images.append(section[at:at + head + size])
        at += -(-(head + size) // 8) * 8
    return images


_MODULES: Dict[tuple, tuple] = {}
_VP, _CI = ctypes.c_void_p, ctypes.c_int
_PVP, _PCI = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
# the driver functions the occupancy query calls (each returns a CUresult)
_DRIVER = {"cuInit": [ctypes.c_uint], "cuDeviceGet": [_PCI, _CI],
           "cuDevicePrimaryCtxRetain": [_PVP, _CI],
           "cuCtxPushCurrent_v2": [_VP], "cuCtxPopCurrent_v2": [_PVP],
           "cuModuleLoadData": [_PVP, _VP],
           "cuModuleGetFunction": [_PVP, _VP, ctypes.c_char_p],
           "cuFuncGetAttribute": [_PCI, _CI, _VP],
           "cuFuncSetAttribute": [_VP, _CI, _CI],
           "cuOccupancyMaxActiveBlocksPerMultiprocessor":
               [_PCI, _VP, _CI, ctypes.c_size_t]}


def _driver_check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA driver error {rc}")


def _modules(name: str, device: int):
    """(driver library, primary context, a module for each fatbinary of the
    library's device code) for one card, loaded once a process."""
    with _LOCK:
        if (name, device) not in _MODULES:
            cu = ctypes.CDLL("libcuda.so.1")
            for fn, argtypes in _DRIVER.items():
                getattr(cu, fn).argtypes = argtypes
                getattr(cu, fn).restype = _CI
            dev, ctx, mods = _CI(0), _VP(), []
            _driver_check(cu.cuInit(0), "cuInit")
            _driver_check(cu.cuDeviceGet(ctypes.byref(dev), device),
                          "cuDeviceGet")
            _driver_check(cu.cuDevicePrimaryCtxRetain(ctypes.byref(ctx), dev),
                          "cuDevicePrimaryCtxRetain")
            _driver_check(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
            try:
                for image in fatbin_images(fatbinary(name)):
                    mods.append(_VP())
                    _driver_check(cu.cuModuleLoadData(
                        ctypes.byref(mods[-1]),
                        ctypes.create_string_buffer(image)),
                        "cuModuleLoadData")
            finally:
                cu.cuCtxPopCurrent_v2(ctypes.byref(_VP()))
            _MODULES[(name, device)] = (cu, ctx, mods)
        return _MODULES[(name, device)]


def occupancy(symbol: str, threads: int, smem: int, device: int,
              name: str = "fused_dock"):
    """(resident blocks an SM, registers a thread) of one kernel of a
    source's library, by its C++ name, for blocks of `threads` threads and
    `smem` bytes of dynamic shared memory on a card, from the CUDA driver's
    occupancy calculator on a module of the library's own device code
    (the library links the runtime statically and exports none of its
    functions)."""
    cu, ctx, mods = _modules(name, device)
    fn, regs, blocks = _VP(), _CI(0), _CI(0)
    _driver_check(cu.cuCtxPushCurrent_v2(ctx), "cuCtxPushCurrent")
    try:
        for mod in mods:     # the section holds an empty fatbinary too
            if cu.cuModuleGetFunction(ctypes.byref(fn), mod,
                                      symbol.encode()) == 0:
                break
        else:
            raise RuntimeError(f"lib{name}: no kernel {symbol}")
        _driver_check(cu.cuFuncGetAttribute(ctypes.byref(regs), 4, fn),
                      "cuFuncGetAttribute")           # NUM_REGS
        if smem > 48 * 1024:          # as the launch sets it (launch_setup)
            _driver_check(cu.cuFuncSetAttribute(fn, 8, smem),
                          "cuFuncSetAttribute")       # MAX_DYNAMIC_SHARED
        _driver_check(cu.cuOccupancyMaxActiveBlocksPerMultiprocessor(
            ctypes.byref(blocks), fn, threads, smem),
            "cuOccupancyMaxActiveBlocksPerMultiprocessor")
    finally:
        cu.cuCtxPopCurrent_v2(ctypes.byref(_VP()))
    return blocks.value, regs.value
