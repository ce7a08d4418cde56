"""Build the package's CUDA sources with nvcc at first use, load them with
ctypes, and call their entries.

Each ``.cu`` file of ``csrc/`` becomes one shared library in
``kernels/_build/``, under a name keyed by a hash of every file in
``csrc/`` (the headers included) and of that source's flags, so a changed
source or flag rebuilds and an unchanged one is reused.  :func:`build`
starts one nvcc per missing library, all at once, and waits for them.
nvcc's report
(``-Xptxas -v``: registers, spills) and its wall-clock seconds are kept
beside each library.  Nothing here runs when the package is imported.

An entry of a library is named ``abt_<source stem>_<f32|f64|shape>``
(:func:`entry_name`); :func:`entry` returns it with its argument types,
:func:`call` runs it on a device's current stream and :func:`launch` over
the pointers of kernels 1-5's tensors.  No other module names an entry,
types it or opens a kernel library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=true", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
#: the sources of the mixed kernel, one library per ocean algorithm and one
#: for the simultaneous LG15_IO solve (csrc/mixed_step.cuh)
MIXED_SOURCES = tuple(f"mixed_step_{name}.cu" for name in (
    "coare3p0", "coare3p6", "ecmwf", "ncar", "andreas", "lg15_io"))
SOURCES = ("fused_step.cu", "fused_grad.cu", "fused_step_ecmwf.cu",
           "fused_grad_ecmwf.cu", "bulk_step.cu", "ice_step.cu",
           *MIXED_SOURCES, "primitive_chain.cu",
           "primitive_chain_forward.cu")
#: the forward kernels 1, 3, 4 and 5 take nvcc's approximate fp32 division
#: (div.full.f32: within 2 ulp over the full range) and square root
#: (sqrt.approx.f32) and keep denormals and libdevice's transcendentals:
#: not --use_fast_math (csrc/fused_step.cu's header); fp64 division and
#: square root stay exact
FORWARD_FLAGS = ("-prec-div=false", "-prec-sqrt=false", "-ftz=false")
#: each source's flags beyond NVCC_FLAGS (none for primitive_chain.cu,
#: which measures the IEEE forms).  The gradient kernels 2 and 2e
#: (fused_grad.cu, fused_grad_ecmwf.cu) recompute kernel 1's forward from
#: the same primal source in their reverse sweep, so they take its flags:
#: the gradient is taken through the arithmetic that produced the values.
#: primitive_chain_forward.cu measures the forms these kernels run, so it
#: takes their flags too
SOURCE_FLAGS = {source: FORWARD_FLAGS for source in (
    "fused_step.cu", "fused_grad.cu", "fused_step_ecmwf.cu",
    "fused_grad_ecmwf.cu", "bulk_step.cu", "ice_step.cu", *MIXED_SOURCES,
    "primitive_chain_forward.cu")}

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
# abt_mixed_step_<ocean>_{f32,f64}(ptrs, n, ice_algo, ocean_algo,
#   simultaneous, niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
#   z0t_pow, beta0, zt, zu, CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10,
#   stream) -> cudaError_t; ptrs holds 13 device pointers
_MIXED_ARGTYPES = [ctypes.POINTER(_P), ctypes.c_int64, _I, _I, _I, _I, _I,
                   _I, _I, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _D, _P]
# abt_ice_step_shape / abt_mixed_step_<ocean>_shape(ice algorithm, f64,
#   int shape[2]) -> cudaError_t: the launch shape (minimum resident blocks
#   per SM, points per thread) of one instantiation
_SHAPE_ARGTYPES = [_I, _I, ctypes.POINTER(ctypes.c_int)]
# abt_primitive_chain[_forward]_{f32,f64}(x, out, n, op, P, K, stream)
#   -> cudaError_t
_CHAIN_ARGTYPES = [_P, _P, ctypes.c_int64, _I, _I, _I, _P]
#: each source's entries abt_<stem>_f32 and abt_<stem>_f64 (entry_name):
#: their argument types
_ENTRIES = {"fused_step.cu": _STEP_ARGTYPES, "fused_grad.cu": _STEP_ARGTYPES,
            "fused_step_ecmwf.cu": _STEP_ARGTYPES,
            "fused_grad_ecmwf.cu": _STEP_ARGTYPES,
            "bulk_step.cu": _BULK_ARGTYPES, "ice_step.cu": _ICE_ARGTYPES,
            **{source: _MIXED_ARGTYPES for source in MIXED_SOURCES},
            "primitive_chain.cu": _CHAIN_ARGTYPES,
            "primitive_chain_forward.cu": _CHAIN_ARGTYPES}
_SUFFIX = {torch.float32: "f32", torch.float64: "f64", "shape": "shape"}


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


def flags(source: str) -> tuple:
    """nvcc's flags for ``source``: NVCC_FLAGS and its SOURCE_FLAGS."""
    return (*NVCC_FLAGS, *SOURCE_FLAGS.get(source, ()))


def library_path(source: str = "fused_step.cu") -> Path:
    """Where the library of ``source`` for the current sources and its
    flags lives."""
    h = hashlib.sha256(" ".join(flags(source)).encode())
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
                [nvcc, *flags(source), "-o", str(tmp), str(CSRC / source)],
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
def load_library(source: str = "fused_step.cu", path=None) -> ctypes.CDLL:
    """Build (if needed) and load the library of one source; or, with
    ``path``, load the library there: a variant of the source built
    elsewhere (``launch_sweep``, ``grad_stage_cost.py``)."""
    if path is None:
        path = library_path(source)
        if not path.exists():
            build([source])
    return ctypes.CDLL(str(path))


def entry_name(source: str, kind) -> str:
    """The one rule for an entry's name: ``abt_<stem of source>_<suffix>``,
    the suffix ``f32`` or ``f64`` for a torch dtype, ``shape`` for
    ``kind="shape"`` (ice_step.cu and the mixed sources)."""
    return f"abt_{Path(source).stem}_{_SUFFIX[kind]}"


@functools.cache
def entry(source: str, kind, path=None):
    """The entry of ``source`` for ``kind`` (torch.float32, torch.float64 or
    ``"shape"``; :func:`entry_name`) with its argument types, in the
    package's build of the source or in the library at ``path``
    (:func:`load_library`)."""
    fn = getattr(load_library(source, path), entry_name(source, kind))
    fn.argtypes = _SHAPE_ARGTYPES if kind == "shape" else _ENTRIES[source]
    fn.restype = ctypes.c_int
    return fn


def call(fn, device, *args):
    """Run the entry ``fn`` with ``args`` and, last, the current stream of
    ``device`` (a tensor's: its index is set); raise RuntimeError naming
    the entry if it returns a CUDA error."""
    with torch.cuda.device(device):
        # the stream's raw handle: current_stream() builds a Stream object
        # on the host path before every launch
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: kernel launch failed with CUDA "
                           f"error {err}")


def launch(fn, tensors, *args):
    """Run ``fn``, an entry of kernels 1-5, over the device pointers of
    ``tensors`` (an empty tensor's is null: a field the kernel does not
    read), the points of the first and ``args`` (:func:`call`).  Bound with
    ``functools.partial``, it keeps the tensors alive."""
    ref = tensors[0]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *map(torch.Tensor.data_ptr, tensors))
    call(fn, ref.device, ptrs, ref.numel(), *args)


#: g++'s flags for a host build of the per-point bodies (build_host)
HOST_FLAGS = ("-std=c++17", "-O1", "-shared", "-fPIC")


def build_host(cxx: str, harness: str, tag: str) -> Path:
    """Build ``harness``, C++ that includes headers of ``csrc/`` (they
    compile with a host compiler: ``common.cuh`` makes ``ABT_DI`` plain
    ``inline``), with the host compiler ``cxx`` into
    ``_build/libabt_<tag>_host_<hash>.so``, keyed by the harness, the flags
    and every file in ``csrc/``; return its path.  For the CPU tests of
    the per-point bodies: an existing library is reused."""
    h = hashlib.sha256(harness.encode() + " ".join(HOST_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode() + p.read_bytes())
    out = BUILD_DIR / f"libabt_{tag}_host_{h.hexdigest()[:16]}.so"
    if not out.exists():
        BUILD_DIR.mkdir(exist_ok=True)
        # this process's own source and output: two processes building one
        # harness never read each other's half-written files
        src = out.with_name(f"{out.stem}.{os.getpid()}.cpp")
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        src.write_text(harness)
        try:
            r = subprocess.run([cxx, *HOST_FLAGS, f"-I{CSRC}", "-o",
                                str(tmp), str(src)], capture_output=True,
                               text=True, timeout=300)
        finally:
            src.unlink()
        if r.returncode != 0:
            raise RuntimeError(f"{cxx} failed for {out.name}:\n{r.stderr}")
        os.replace(tmp, out)
    return out


_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_PROPS = re.compile(r"Function properties for (\w+)")
_SPILLS = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes of each kernel in nvcc's ``-Xptxas -v``
    report: {mangled entry name: [registers, spill stores, spill loads]}."""
    found, entry, props, spills = {}, None, None, (0, 0)
    for ln in log.splitlines():
        if m := _ENTRY.search(ln):
            entry, spills = m.group(1), (0, 0)
        elif m := _PROPS.search(ln):
            props = m.group(1)
        elif entry and props == entry and (m := _SPILLS.search(ln)):
            spills = (int(m.group(1)), int(m.group(2)))
        elif entry and (m := _REGS.search(ln)):
            found[entry] = [int(m.group(1)), *spills]
            entry = None
    return found
