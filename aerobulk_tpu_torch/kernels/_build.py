"""Build the package's CUDA sources with nvcc at first use and load them
with ctypes.

The shared library goes to ``kernels/_build/`` under a name keyed by a hash
of the sources and flags, so a changed ``.cu`` rebuilds and an unchanged
one is reused.  nvcc's report (``-Xptxas -v``: registers, spills) is kept
beside it.  Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=true", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_I, _D, _P = ctypes.c_int, ctypes.c_double, ctypes.c_void_p
# abt_fused_step_{f32,f64}(ptrs[23], n, niter, charn_law, visc_at_tzu,
#   humidity, z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, rdt, gdept,
#   isecday_utc, stream) -> cudaError_t
_FUSED_STEP_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I, _I,
                        _D, _D, _D, _D, _D, _D, _D, _D, _D, _P]


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


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libaerobulk_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' shared library."""
    lib_path = library_path()
    if not lib_path.exists():
        nvcc = find_nvcc()
        cu, _ = _sources()
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                               *map(str, cu)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        lib_path.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("abt_fused_step_f32", "abt_fused_step_f64"):
        fn = getattr(lib, name)
        fn.argtypes = _FUSED_STEP_ARGTYPES
        fn.restype = ctypes.c_int
    return lib
