"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

Each ``.cu`` file of ``csrc/`` becomes one shared library in
``kernels/_build/``, under a name keyed by a hash of every file in
``csrc/`` (the headers included) and of the flags, so a changed source
rebuilds and an unchanged one is reused.  :func:`build` starts one nvcc per
missing library, all at once, and waits for them.  nvcc's report
(``-Xptxas -v``: registers, spills) and its wall-clock seconds are kept
beside each library.  Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=true", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
SOURCES = ("fused_step.cu", "fused_grad.cu", "fused_step_ecmwf.cu",
           "fused_grad_ecmwf.cu", "bulk_step.cu", "ice_step.cu",
           "mixed_step.cu", "primitive_chain.cu")

_I, _D, _P = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
# abt_fused_{step,grad}[_ecmwf]_{f32,f64}(ptrs, n, niter, charn_law,
#   visc_at_tzu, humidity, z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, rdt,
#   gdept, isecday_utc, stream) -> cudaError_t; ptrs holds 23 (step) or 36
#   (grad) device pointers
_STEP_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I, _I,
                  _D, _D, _D, _D, _D, _D, _D, _D, _D, _P]
# abt_bulk_step_{f32,f64}(ptrs, n, algo, niter, charn_law, visc_at_tzu,
#   humidity, z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, stream)
#   -> cudaError_t; ptrs holds 12 device pointers
_BULK_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I, _I, _I,
                  _D, _D, _D, _D, _D, _D, _P]
# abt_ice_step_{f32,f64}(ptrs, n, algo, niter, humidity, zt, zu, CdN, ChN,
#   CeN, sqrt_CdN, log_ztzu, log_zu10, stream) -> cudaError_t; ptrs holds 13
#   device pointers (frice may be null)
_ICE_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I,
                 _D, _D, _D, _D, _D, _D, _D, _D, _P]
# abt_mixed_step_{f32,f64}(ptrs, n, ice_algo, ocean_algo, simultaneous,
#   niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef, z0t_pow,
#   beta0, zt, zu, CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10, stream)
#   -> cudaError_t; ptrs holds 13 device pointers
_MIXED_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I, _I, _I,
                   _I, _I, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _P]
# abt_primitive_chain_{f32,f64}(x, out, n, op, P, K, stream) -> cudaError_t
_CHAIN_ARGTYPES = [_P, _P, ctypes.c_int64, _I, _I, _I, _P]
# source -> (entry points, their argtypes)
_ENTRIES = {"fused_step.cu": (("abt_fused_step_f32", "abt_fused_step_f64"),
                              _STEP_ARGTYPES),
            "fused_grad.cu": (("abt_fused_grad_f32", "abt_fused_grad_f64"),
                              _STEP_ARGTYPES),
            "fused_step_ecmwf.cu": (("abt_fused_step_ecmwf_f32",
                                     "abt_fused_step_ecmwf_f64"),
                                    _STEP_ARGTYPES),
            "fused_grad_ecmwf.cu": (("abt_fused_grad_ecmwf_f32",
                                     "abt_fused_grad_ecmwf_f64"),
                                    _STEP_ARGTYPES),
            "bulk_step.cu": (("abt_bulk_step_f32", "abt_bulk_step_f64"),
                             _BULK_ARGTYPES),
            "ice_step.cu": (("abt_ice_step_f32", "abt_ice_step_f64"),
                            _ICE_ARGTYPES),
            "mixed_step.cu": (("abt_mixed_step_f32", "abt_mixed_step_f64"),
                              _MIXED_ARGTYPES),
            "primitive_chain.cu": (("abt_primitive_chain_f32",
                                    "abt_primitive_chain_f64"),
                                   _CHAIN_ARGTYPES)}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, else under the CUDA toolkit PyTorch found."""
    from torch.utils.cpp_extension import CUDA_HOME
    nvcc = shutil.which("nvcc")
    if nvcc is None and CUDA_HOME:
        nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of aerobulk_tpu_torch are "
            "built from source at first use and need the CUDA toolkit "
            "(put nvcc on PATH or set CUDA_HOME)")
    return nvcc


def library_path(source: str = "fused_step.cu") -> Path:
    """Where the library of ``source`` for the current sources and flags
    lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.is_file():
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_DIR / f"libabt_{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build(sources=SOURCES):
    """Build the libraries of ``sources`` that do not exist yet: one nvcc
    each, all started together."""
    jobs = []
    t0 = time.perf_counter()
    for source in sources:
        lib_path = library_path(source)
        if lib_path.exists():
            continue
        if not jobs:
            nvcc = find_nvcc()
            BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        log = lib_path.with_suffix(".log")
        with open(log, "w") as out:
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                stdout=out, stderr=subprocess.STDOUT)
        jobs.append((proc, tmp, lib_path, log))
    done = {}
    while len(done) < len(jobs):
        for proc, _, lib_path, _ in jobs:
            if lib_path not in done and proc.poll() is not None:
                done[lib_path] = time.perf_counter() - t0
        time.sleep(0.05)
    failed = []
    for proc, tmp, lib_path, log in jobs:
        with open(log, "a") as out:
            out.write(f"nvcc wall seconds: {done[lib_path]:.1f}\n")
        if proc.returncode != 0:
            failed.append(f"nvcc failed with code {proc.returncode} for "
                          f"{lib_path.name}:\n{log.read_text()}")
        else:
            os.replace(tmp, lib_path)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(source: str = "fused_step.cu") -> ctypes.CDLL:
    """Build (if needed) and load the library of one source."""
    lib_path = library_path(source)
    if not lib_path.exists():
        build([source])
    lib = ctypes.CDLL(str(lib_path))
    names, argtypes = _ENTRIES[source]
    for name in names:
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
