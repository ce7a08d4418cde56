"""The kernel layer of aerobulk_tpu_torch as far as a machine without a GPU
can check it: imports, dispatch to the plain version on CPU tensors, the
configs the kernels refuse, the build's error without nvcc and its keys,
and that chip_smoke.py refuses to run without a GPU.  The kernels
themselves (the fused step, its gradient and the stateless step) are
checked on the card by chip_smoke.py and by the tests marked ``cuda``.
"""

import contextlib
import itertools
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import roofline as troofline
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as tfused
from aerobulk_tpu_torch.kernels import roofline as tchain

REPO = Path(__file__).resolve().parent.parent


def _run(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_package_imports_without_jax_or_nvcc():
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="", CUDA_PATH="")
    r = _run("import sys, aerobulk_tpu_torch, aerobulk_tpu_torch.kernels, "
             "aerobulk_tpu_torch.convert, aerobulk_tpu_torch.launch_sweep, "
             "aerobulk_tpu_torch.pipeline, aerobulk_tpu_torch.io, "
             "aerobulk_tpu_torch.run_global_grid, "
             "aerobulk_tpu_torch.implicit_coupling, "
             "aerobulk_tpu_torch.sensitivity_map, "
             "aerobulk_tpu_torch.calibrate_charnock, "
             "aerobulk_tpu_torch.plotting, aerobulk_tpu_torch.prepare_forcing, "
             "aerobulk_tpu_torch.example_call_aerobulk, chip_smoke\n"
             "assert 'jax' not in sys.modules, 'jax imported'\n"
             "assert 'aerobulk_tpu' not in sys.modules\n"
             "print('ok')", env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_package_sources_do_not_reach_the_jax_package():
    """No source of the port (nor chip_smoke.py) imports jax or
    aerobulk_tpu, or reads the JAX package's examples/ or tests/oracle:
    the port keeps its own copies.  chip_smoke.py names the JAX package's
    files only in its ``"replaces"`` strings and comments."""
    import re
    pkg = REPO / "aerobulk_tpu_torch"
    sources = sorted(pkg.rglob("*.py")) + [REPO / "chip_smoke.py"]
    imports = re.compile(r"^\s*(import|from)\s+(jax|aerobulk_tpu|examples|"
                         r"oracle|tests)\b", re.M)
    paths = re.compile(r"[\"'](examples|tests/oracle|tests)/")
    for path in sources:
        text = path.read_text()
        assert not imports.search(text), path
        assert not paths.search(text), path
        assert "sys.path" not in text, path


def _step_inputs(dtype=torch.float64, device="cpu", shape=(4, 32)):
    rng = np.random.default_rng(2)
    sst = 285.0 + 15.0 * rng.random(shape)
    arrays = (sst, sst + rng.normal(0, 2, shape),
              0.004 + 0.012 * rng.random(shape), rng.normal(0, 6, shape),
              rng.normal(0, 6, shape), 98000 + 4000 * rng.random(shape),
              500 * rng.random(shape), 250 + 150 * rng.random(shape),
              360 * rng.random(shape))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in arrays)


def test_fused_step_on_cpu_is_the_plain_version():
    cfg = tapi.AeroBulkConfig(use_skin=True, niter=3)
    *args, lon = _step_inputs()
    launches = tfused.LAUNCHES
    outs, state = tfused.fused_flux_step(cfg, *args, lon=lon,
                                         isecday_utc=30000)
    assert tfused.LAUNCHES == launches
    ref, ref_state = tapi.flux_step(cfg, *args[:6], rad_sw=args[6],
                                    rad_lw=args[7], isecday_utc=30000,
                                    lon=lon)
    for g, r in zip(outs + state, (ref.QL, ref.QH, ref.Tau_x, ref.Tau_y,
                                   ref.Evap, ref.T_s) + ref_state):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("kw,err", [
    (dict(use_skin=False), NotImplementedError),
    (dict(use_skin=True, humidity="auto"), ValueError),
])
def test_fused_step_refuses_configs_it_does_not_take(kw, err):
    *args, lon = _step_inputs()
    with pytest.raises(err):
        tfused.fused_flux_step(tapi.AeroBulkConfig(**kw), *args, lon=lon)


def test_fused_step_takes_ecmwf_skin():
    """BASELINE config 4 (ECMWF + skin) runs through fused_flux_step: on CPU
    tensors it is the eager step, with the ECMWF state (Hz_wl = 3 m)."""
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True, niter=3)
    *args, lon = _step_inputs()
    launches = tfused.LAUNCHES
    outs, state = tfused.fused_flux_step(cfg, *args, lon=lon)
    assert tfused.LAUNCHES == launches
    ref, ref_state = tapi.flux_step(cfg, *args[:6], rad_sw=args[6],
                                    rad_lw=args[7], lon=lon)
    for g, r in zip(outs + state, (ref.QL, ref.QH, ref.Tau_x, ref.Tau_y,
                                   ref.Evap, ref.T_s) + ref_state):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert bool((state.Hz_wl == 3.0).all()) and bool((state.dT_wl > 0).any())


def test_build_without_nvcc_says_so(monkeypatch):
    import torch.utils.cpp_extension as cpp
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_name_follows_the_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path == _build.library_path()
    assert (_build.CSRC / "fused_step.cu").exists()


FORWARD_SOURCES = ("fused_step.cu", "fused_step_ecmwf.cu", "bulk_step.cu",
                   "ice_step.cu", *_build.MIXED_SOURCES)


def test_each_source_has_its_own_library():
    paths = {_build.library_path(s) for s in _build.SOURCES}
    assert len(paths) == len(_build.SOURCES) == 14
    # the mixed kernel: one source per ocean algorithm and LG15_IO, each
    # one line on mixed_step.cuh
    assert _build.MIXED_SOURCES == tuple(
        f"mixed_step_{o}.cu" for o in (*tfused._BULK_ALGOS, "lg15_io"))
    for source in _build.MIXED_SOURCES:
        text = (_build.CSRC / source).read_text()
        assert '#include "mixed_step.cuh"' in text
        assert f"ABT_MIXED_ENTRIES(abt_{source[:-3]}, " in text
    for source in _build.SOURCES:
        assert (_build.CSRC / source).exists()
        assert source in _build._ENTRIES
    # the forward kernels 1, 3, 4 and 5, the gradient kernels 2 and 2e
    # (whose reverse sweep recomputes kernel 1's forward), and kernel 6's
    # chain of the forms they run, take approximate fp32 division and
    # square root and keep denormals; primitive_chain.cu, which measures
    # the IEEE forms, builds with NVCC_FLAGS alone; no source takes fast
    # math, a flush to zero or a define
    flagged = (*FORWARD_SOURCES, "fused_grad.cu", "fused_grad_ecmwf.cu",
               "primitive_chain_forward.cu")
    assert set(_build.SOURCE_FLAGS) == set(flagged)
    for source in _build.SOURCES:
        flags = _build.flags(source)
        assert flags[:len(_build.NVCC_FLAGS)] == _build.NVCC_FLAGS
        assert ("-prec-div=false" in flags) == (source in flagged)
        assert ("-prec-sqrt=false" in flags) == (source in flagged)
        assert "--use_fast_math" not in flags and "-use_fast_math" not in flags
        assert "-ftz=true" not in flags
        assert not any(f.startswith("-D") for f in flags)
    for source in flagged:
        assert "-ftz=false" in _build.flags(source)
    for source in ("fused_grad.cu", "fused_grad_ecmwf.cu"):
        assert "ABT_GRAD_K" not in (_build.CSRC / source).read_text()


def test_gradient_kernels_take_the_flags_of_the_forward_they_recompute():
    """Kernel 2 (2e) recomputes kernel 1's (1e's) forward in its reverse
    sweep and differentiates the values kernel 1 gave: both build with one
    set of flags, so a change of one side's numerics moves the other."""
    for grad, step in (("fused_grad.cu", "fused_step.cu"),
                       ("fused_grad_ecmwf.cu", "fused_step_ecmwf.cu")):
        assert _build.flags(grad) == _build.flags(step)


def test_library_key_follows_each_sources_flags(monkeypatch):
    """A change of one source's flags rebuilds that source's library and
    no other."""
    before = {s: _build.library_path(s) for s in _build.SOURCES}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "bulk_step.cu",
                        ("-prec-div=false", "-ftz=false"))
    after = {s: _build.library_path(s) for s in _build.SOURCES}
    assert after["bulk_step.cu"] != before["bulk_step.cu"]
    assert all(after[s] == before[s] for s in _build.SOURCES
               if s != "bulk_step.cu")


def test_ecmwf_sources_build_the_shared_bodies():
    """The ECMWF variants of kernels 1 and 2 are the COARE sources compiled
    again with the ECMWF skin solve and their own entry names, not copies
    of them."""
    for kind in ("step", "grad"):
        text = (_build.CSRC / f"fused_{kind}_ecmwf.cu").read_text()
        assert f'#include "fused_{kind}.cu"' in text
        assert "abt::EcmwfSkin" in text
        assert (f"#define ABT_{kind.upper()}_ENTRY(dtype) "
                f"abt_fused_{kind}_ecmwf_##dtype") in text


def test_library_key_covers_every_file_in_csrc(tmp_path, monkeypatch):
    """A header that only the gradient kernel includes still rebuilds
    both libraries when it changes."""
    for p in _build.CSRC.iterdir():
        shutil.copy(p, tmp_path / p.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = [_build.library_path(s) for s in _build.SOURCES]
    (tmp_path / "dual.cuh").write_text(
        (tmp_path / "dual.cuh").read_text() + "\n// changed\n")
    after = [_build.library_path(s) for s in _build.SOURCES]
    assert all(a != b for a, b in zip(before, after))


def test_build_runs_one_compiler_per_source_and_logs_its_time(tmp_path,
                                                             monkeypatch):
    """build() starts one compiler per missing library, all together, and
    keeps each one's report and wall-clock seconds beside the library; a
    failing compiler raises with its report.  A stand-in script plays
    nvcc."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\necho "ptxas info : Used 1 registers"\n'
                    'for a; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; '
                    'done\ncase "$*" in *mixed_step_ncar*) exit 3;; esac\n'
                    'touch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    _build.build(["ice_step.cu", "bulk_step.cu"])
    for source in ("ice_step.cu", "bulk_step.cu"):
        lib = _build.library_path(source)
        assert lib.exists()
        log = lib.with_suffix(".log").read_text()
        assert "Used 1 registers" in log and "nvcc wall seconds:" in log
    with pytest.raises(RuntimeError,
                       match="code 3 for libabt_mixed_step_ncar"):
        _build.build(["mixed_step_ncar.cu"])
    assert not _build.library_path("mixed_step_ncar.cu").exists()


PTXAS_LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z8kernel_aPf' for 'sm_90a'
ptxas info    : Function properties for __internal_trig_reduction_slowpathd
    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Function properties for _Z8kernel_aPf
    8 bytes stack frame, 412 bytes spill stores, 408 bytes spill loads
ptxas info    : Used 128 registers, used 0 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_Z8kernel_bPd' for 'sm_90a'
ptxas info    : Function properties for _Z8kernel_bPd
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 0 barriers, 380 bytes cmem[0]
"""


def test_ptxas_report_reads_each_entrys_registers_and_spills():
    """The spills of a callee's properties are not the entry's."""
    assert _build.ptxas_report(PTXAS_LOG) == {"_Z8kernel_aPf": [128, 412, 408],
                                              "_Z8kernel_bPd": [64, 0, 0]}


def _with_includes(path, seen):
    """The text of a file of csrc/ with each local include in its place,
    once."""
    def inline(m):
        name = m.group(1)
        if name in seen:
            return ""
        seen.add(name)
        return _with_includes(_build.CSRC / name, seen)
    return re.sub(r'#include "([^"]+)"', inline, path.read_text())


def _defined_entries(source):
    """The entry names ``source`` defines, read as the preprocessor would:
    its ``extern "C"`` functions and the names its entry macros make (the
    first definition of ABT_STEP_ENTRY / ABT_GRAD_ENTRY wins, as their
    ``#ifndef`` guards make it)."""
    text = _with_includes(_build.CSRC / source, {source})
    names = set(re.findall(r'extern "C" int (abt_\w+)\(', text))
    names |= set(re.findall(r"\bABT_ENTRY\((abt_\w+),", text))
    for macro in ("ABT_STEP_ENTRY", "ABT_GRAD_ENTRY"):
        prefix = re.search(rf"#define {macro}\(dtype\) (abt_\w+)##dtype",
                           text)
        if prefix:
            names |= {prefix.group(1) + bits for bits in re.findall(
                rf"\bABT_ENTRY\({macro}\((f32|f64)\)", text)}
    for name in re.findall(r"\bABT_MIXED_ENTRIES\((abt_\w+),", text):
        names |= {f"{name}_f32", f"{name}_f64", f"{name}_shape"}
    return names


@pytest.mark.parametrize("source", _build.SOURCES)
def test_entry_names_are_the_names_the_sources_define(source):
    """The one rule (``_build.entry_name``) names exactly the entries each
    source defines: fp32 and fp64, and the launch shape of the ice and
    mixed kernels."""
    kinds = [torch.float32, torch.float64]
    if source in ("ice_step.cu", *_build.MIXED_SOURCES):
        kinds.append("shape")
    assert {_build.entry_name(source, k) for k in kinds} == \
        _defined_entries(source)
    assert source in _build._ENTRIES


class _Entry:
    """A stand-in for a library's entry: keeps its arguments, returns
    ``err``."""
    __name__ = "abt_fake_f32"

    def __init__(self, err=0):
        self.err, self.calls = err, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.err


class _Stream:
    cuda_stream = 0x5EED


@pytest.fixture
def fake_card(monkeypatch):
    """torch.cuda.device and the current stream's raw handle as seen by
    _build.call: the device and the device index each was asked for, and
    the handle ``_Stream.cuda_stream``."""
    asked = []

    def device(d):
        asked.append(("device", d))
        return contextlib.nullcontext()

    def raw_stream(index):
        asked.append(("stream", index))
        return _Stream.cuda_stream
    monkeypatch.setattr(torch.cuda, "device", device)
    # a CPU build of torch has no such function: raising=False
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", raw_stream,
                        raising=False)
    return asked


def test_call_passes_its_arguments_and_the_stream_last(fake_card):
    """_build.call runs an entry with its arguments in order and the
    current stream of the device it is given last, inside that device;
    a nonzero code raises RuntimeError naming the entry."""
    dev = torch.device("cuda", 1)
    fn = _Entry()
    _build.call(fn, dev, 7, 2.5, None)
    assert fn.calls == [(7, 2.5, None, _Stream.cuda_stream)]
    assert fake_card == [("device", dev), ("stream", 1)]
    fn = _Entry(err=700)
    with pytest.raises(RuntimeError,
                       match="abt_fake_f32: kernel launch failed with CUDA "
                             "error 700"):
        _build.call(fn, dev, 7)
    assert fn.calls == [(7, _Stream.cuda_stream)]


class _OnCard(torch.Tensor):
    """A host tensor that says it is on the card, so that a wrapper takes
    its CUDA path up to the entry (a stand-in) with pointers to host
    memory; what it makes says so too."""

    @property
    def device(self):
        return torch.device("cuda", 0)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("device", None)         # its memory stays on the host
        return super().__torch_function__(func, types, args, kwargs)


def _on_card(names, shape=(3, 4)):
    return {n: torch.rand(shape, dtype=torch.float64).as_subclass(_OnCard)
            for n in names}


def _skin_call(x):
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True)
    outs, state = tfused.fused_flux_step(
        cfg, **{n: x[n] for n in tfused._INPUTS[:9]}, isecday_utc=3600,
        skin_state=tapi.SkinState(*(x[n] for n in tfused._INPUTS[9:])))
    return ([x[n] for n in tfused._INPUTS] + [*outs, *state],
            ("fused_step_ecmwf.cu", tfused._skin_args(cfg, 3600.0)))


def _grad_call(x):
    cfg = tapi.AeroBulkConfig(algo="coare3p0", use_skin=True)
    ins = [x[n] for n in tfused._INPUTS]
    cts = [x[f"ct_{n}"] for n in tfused._OUTPUTS]
    grads = tfused.fused_flux_step_grad(cfg, ins, cts, 7200)
    return ([*ins, *cts, *grads],
            ("fused_grad.cu", tfused._skin_args(cfg, 7200.0)))


def _bulk_call(x):
    cfg = tapi.AeroBulkConfig(algo="ncar", use_skin=False)
    outs = tfused.fused_bulk_step(cfg, **x)
    return ([x[n] for n in tfused._BULK_INPUTS] + list(outs),
            ("bulk_step.cu", tfused._bulk_args(cfg)))


def _ice_call(x):
    outs = tfused.fused_ice_step("ice_lg15", 2.0, 10.0, **x)
    return ([x[n] for n in tfused._ICE_INPUTS] + list(outs),
            ("ice_step.cu", tfused._ice_args("ice_lg15", 2.0, 10.0,
                                             x["frice"], 5, "sh", {})))


def _ice_call_without_frice(x):
    outs = tfused.fused_ice_step("ice_easy", 2.0, 10.0, **x, CdN=1.2e-3)
    return ([x[n] for n in tfused._ICE_INPUTS[:6]] + [None] + list(outs),
            ("ice_step.cu", tfused._ice_args("ice_easy", 2.0, 10.0, None,
                                             5, "sh", {"CdN": 1.2e-3})))


def _mixed_call(x):
    outs = tfused.fused_mixed_step(2.0, 10.0, **x, ocean_algo="coare3p6")
    return ([x[n] for n in tfused._MIXED_INPUTS] + list(outs),
            ("mixed_step_coare3p6.cu", tfused._mixed_args(
                2.0, 10.0, "ice_lg15", "coare3p6", 5, "sh", False)))


@pytest.mark.parametrize("kernel,names,call", [
    (1, tfused._INPUTS, _skin_call),
    (2, (*tfused._INPUTS, *(f"ct_{n}" for n in tfused._OUTPUTS)),
     _grad_call),
    (3, tfused._BULK_INPUTS, _bulk_call),
    (4, tfused._ICE_INPUTS, _ice_call),
    (4, tfused._ICE_INPUTS[:6], _ice_call_without_frice),
    (5, tfused._MIXED_INPUTS, _mixed_call),
], ids=["kernel1", "kernel2", "kernel3", "kernel4", "kernel4_without_frice",
        "kernel5"])
def test_kernels_pass_their_pointers_in_field_order(kernel, names, call,
                                                    fake_card, monkeypatch):
    """Each wrapper of kernels 1-5 hands its entry (from ``_build.entry``,
    here a stand-in) the pointers of its fields in the order of its names
    (``_INPUTS`` and ``_OUTPUTS``, ``_BULK_INPUTS``, ``_ICE_INPUTS``,
    ``_MIXED_INPUTS``; each field passed by that name, and null for the
    ice kernel's ``frice`` where its algorithm does not read it), then of
    its outputs, then n, its argument builder's scalars and the stream."""
    fn, asked = _Entry(), []

    def entry(source, kind, path=None):
        asked.append((source, kind, path))
        return fn
    monkeypatch.setattr(_build, "entry", entry)
    for counter in ("LAUNCHES", "GRAD_LAUNCHES", "BULK_LAUNCHES",
                    "ICE_LAUNCHES", "MIXED_LAUNCHES"):
        monkeypatch.setattr(tfused, counter, getattr(tfused, counter))
    if kernel == 3:
        # the broadcast makes new tensors (on the card, were it there)
        monkeypatch.setattr(tfused, "_bulk_fields", tuple)
    tensors, (source, args) = call(_on_card(names))
    (got,) = fn.calls
    assert asked == [(source, torch.float64, None)]
    assert list(got[0]) == [t if t is None else t.data_ptr()
                            for t in tensors]
    assert len(set(got[0])) == len(got[0])
    assert got[1:] == (12, *args, _Stream.cuda_stream)


RACE_CHILD = """
import ctypes, sys, time
from pathlib import Path
from aerobulk_tpu_torch.kernels import _build
_build.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[3]).touch()
while not Path(sys.argv[2]).exists():
    time.sleep(0.001)
harness = ('#include "common.cuh"\\n// ' + 'x' * (1 << 22)
           + '\\nextern "C" int abt_race_host() { return 42; }\\n')
lib = ctypes.CDLL(str(_build.build_host(sys.argv[4], harness, "race")))
print(lib.abt_race_host())
"""


def test_build_host_builds_one_harness_in_two_processes_at_once(tmp_path):
    """Two processes that build one harness into an empty build directory
    at the same moment both load a whole library, and leave nothing else
    behind: each compiles its own copy of the source into its own
    output."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++)")
    go = tmp_path / "go"
    ready = [tmp_path / f"ready{i}" for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RACE_CHILD, str(tmp_path / "_build"), str(go),
         str(r), cxx], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in ready]
    try:
        deadline = time.monotonic() + 120
        while not all(r.exists() for r in ready):
            assert time.monotonic() < deadline
            assert all(p.poll() is None for p in procs)
            time.sleep(0.01)
        go.touch()
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err
            assert out.strip() == "42"
    finally:
        for p in procs:
            p.kill()
    (lib,) = (tmp_path / "_build").iterdir()
    assert re.fullmatch(r"libabt_race_host_[0-9a-f]{16}\.so", lib.name)


def test_launch_sweep_builds_every_variant_with_its_flags(tmp_path,
                                                          monkeypatch):
    """Each variant of the sweep builds the forward sources with its
    flags and defines; another checkout's sources with the flags of that
    checkout's _build.py (none: a directory without the sources builds
    nothing); a stand-in script plays nvcc."""
    from aerobulk_tpu_torch import launch_sweep
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho \"$*\"\n"
                    'for a; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; '
                    'done\ntouch "$out"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(fake))
    ref = tmp_path / "ref" / "csrc"
    shutil.copytree(_build.CSRC, ref)
    (ref.parent / "_build.py").write_text(
        'NVCC_FLAGS = ("-O3",)\n'
        'def flags(source):\n'
        '    return NVCC_FLAGS + (("-prec-div=false",)\n'
        '                         if source == "bulk_step.cu" else ())\n')
    (tmp_path / "empty").mkdir()
    vs = launch_sweep.variants([str(ref), f"other={tmp_path / 'empty'}"])
    assert list(vs)[:5] == ["ref", "other", "exact_div", "approx_div",
                            "approx_div_sqrt"]
    assert {f"b{b}_p{p}" for b in (1, 2, 3, 4) for p in (1, 2)} < set(vs)
    assert launch_sweep.SOURCES == FORWARD_SOURCES
    built = launch_sweep.build(vs, tmp_path / "out", jobs=4)
    assert len(built) == len(FORWARD_SOURCES) * (len(vs) - 1)
    assert not any(label == "other" for label, _ in built)
    for (label, src), (lib, flags, _) in built.items():
        cmd = lib.with_suffix(".log").read_text()
        assert str((ref if label == "ref" else _build.CSRC) / src) in cmd
        if label == "ref":
            assert flags == ("-O3",) + (("-prec-div=false",)
                                        if src == "bulk_step.cu" else ())
            continue
        assert ("-prec-div=false" in flags) == (label != "exact_div")
        assert ("-prec-sqrt=false" in flags) == (
            label not in ("exact_div", "approx_div"))
        assert ("-DABT_SWEEP_POINTS=2" in flags) == label.endswith("_p2")
        assert any("-DABT_SWEEP" in f for f in flags) == (label != "kept")
    for src in FORWARD_SOURCES:
        assert built[("kept", src)][1] == _build.flags(src)


def test_launch_sweep_refuses_to_run_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the sweep would run")
    r = subprocess.run([sys.executable, "-m",
                        "aerobulk_tpu_torch.launch_sweep"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_chip_smoke_refuses_to_run_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py would run")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in a directory, without the package, it cannot run either
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _humidity_inputs(args, humidity):
    """Turn the specific humidity of ``args`` into the given kind."""
    sst, t = args[0], args[1]
    hum = {"sh": args[2], "rh": 40.0 + 60.0 * (args[2] - 0.004) / 0.012,
           "dp": t - 1.0 - 8.0 * (args[2] - 0.004) / 0.012}[humidity]
    return (sst, t, hum, *args[3:])


_CONFIGS = [dict(algo=a, humidity=h, zt=zt, niter=n)
            for a in ("coare3p0", "coare3p6") for h in ("sh", "rh", "dp")
            for zt, n in ((2.0, 5), (10.0, 1), (2.0, 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", _CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_kernel_matches_plain_fp64_on_gpu(kw):
    """Every branch the kernel takes from its arguments, in fp64, where
    kernel and plain version differ only by FMA contraction."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(use_skin=True, **kw)
    *args, lon = _step_inputs(torch.float64, "cuda", shape=(37, 129))
    args = _humidity_inputs(args, kw["humidity"])
    state = tapi.init_skin_state(cfg, args[0].shape, torch.float64, "cuda")
    state = state._replace(dT_wl=state.dT_wl + 0.3 * (lon > 180),
                           Qnt_ac=state.Qnt_ac + 2e5 * (lon < 90))
    launches = tfused.LAUNCHES
    outs, new = tfused.fused_flux_step(cfg, *args, lon=lon,
                                       isecday_utc=20000, skin_state=state)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES == launches + 1
    pouts, pnew = tfused.fused_flux_step_plain(cfg, *args, lon=lon,
                                               isecday_utc=20000,
                                               skin_state=state)
    for g, r in zip(outs + new, pouts + pnew):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale)


@pytest.mark.cuda
def test_kernel_matches_plain_fp32_on_gpu():
    """fp32: both paths round differently, and a point whose warm-layer
    test lands on the other side of a threshold may flip regime, so the
    gate counts points off by more than 10% of the field's median
    magnitude (docs/PARITY.md "The fp32 tail")."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(use_skin=True)
    *args, lon = _step_inputs(torch.float32, "cuda", shape=(64, 512))
    outs, new = tfused.fused_flux_step(cfg, *args, lon=lon)
    pouts, pnew = tfused.fused_flux_step_plain(cfg, *args, lon=lon)
    for g, r in zip(outs + new, pouts + pnew):
        d = (g - r).abs()
        nonzero = r[r != 0].abs()
        med = float(nonzero.median()) if nonzero.numel() else 1e-6
        assert bool(torch.isfinite(g).all())
        assert float((d > 0.1 * med).float().mean()) <= 1e-3


@pytest.mark.cuda
def test_kernel_wrapper_checks_its_inputs_on_gpu():
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(use_skin=True)
    *args, lon = _step_inputs(torch.float32, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        tfused.fused_flux_step(cfg, args[0].t().contiguous().t(), *args[1:],
                               lon=lon)
    with pytest.raises(ValueError, match="float64"):
        tfused.fused_flux_step(cfg, *args[:7], args[7].double(), lon=lon)
    with pytest.raises(TypeError, match="float32 or float64"):
        tfused.fused_flux_step(cfg, *(a.half() for a in args), lon=lon.half())


# ---------------------------------------------------------------------------
# the gradient kernel (fused_grad.cu)
# ---------------------------------------------------------------------------

def _cotangents(like, seed=4):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(tuple(like.shape)),
                            dtype=like.dtype, device=like.device)
            for _ in range(10)]


def test_grad_kernel_wrapper_refuses_cpu_tensors():
    cfg = tapi.AeroBulkConfig(use_skin=True)
    *args, lon = _step_inputs()
    state = tapi.init_skin_state(cfg, args[0].shape, torch.float64, "cpu")
    launches = tfused.GRAD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfused.fused_flux_step_grad(cfg, (*args, lon, *state),
                                    _cotangents(args[0]))
    assert tfused.GRAD_LAUNCHES == launches


def test_grad_kernel_refuses_more_iterations_than_it_checkpoints():
    """The reverse sweep keeps one checkpoint per outer iteration, at most
    kMaxIter of them (csrc/adjoint.cuh); the wrapper refuses more before
    launching and names the eager backward pass."""
    text = (_build.CSRC / "adjoint.cuh").read_text()
    assert f"kMaxIter = {tfused.GRAD_MAX_NITER};" in text
    cfg = tapi.AeroBulkConfig(use_skin=True, niter=tfused.GRAD_MAX_NITER + 1)
    *args, lon = _step_inputs()
    state = tapi.init_skin_state(cfg, args[0].shape, torch.float64, "cpu")
    launches = tfused.GRAD_LAUNCHES
    with pytest.raises(ValueError, match="grad_backend='eager'"):
        tfused.fused_flux_step_grad(cfg, (*args, lon, *state),
                                    _cotangents(args[0]))
    assert tfused.GRAD_LAUNCHES == launches


def test_grad_stage_cost_variants_skip_existing_stages(tmp_path):
    """grad_stage_cost.py's copies of csrc/ name stages that adjoint.cuh
    has, and each copy gets its skip switch; without a GPU the script
    exits non-zero before building anything."""
    import grad_stage_cost as gsc
    text = (_build.CSRC / "adjoint.cuh").read_text()
    for group, skips in gsc.GROUPS.items():
        for name in skips or ():
            stem = name.split("<")[0]
            assert (f"ABT_STAGE({stem}," in text or f"struct {stem} {{" in text
                    or f"using {stem} = " in text)
        gsc.variant_sources(tmp_path / group, skips)
        variant = (tmp_path / group / "adjoint.cuh").read_text()
        assert "if constexpr (Skip<F>::value) return;" in variant
        assert variant.count("struct Skip<") == len(skips or ())
    if not torch.cuda.is_available():
        r = subprocess.run([sys.executable, "grad_stage_cost.py"], cwd=REPO,
                           capture_output=True, text=True, timeout=120)
        assert r.returncode != 0 and "no CUDA device" in r.stderr


def test_grad_stage_cost_lists_only_one_input_stages_on_duals(tmp_path):
    """Every stage of two or more inputs walks back through its written-out
    adjoint in both builds (vjp()'s static_assert): a host build of one
    point of each sweep finds only the one-input stages on duals."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    import grad_stage_cost as gsc
    one_input = set(gsc.DUALS_PSI + gsc.DUALS_ALPHA_VISC)
    found = gsc.stages_on_duals(tmp_path / "on_duals")
    assert found == {"coare": ["AlphaStage", "CoarePsiStage"],
                     "ecmwf": ["AlphaStage", "EcmwfPsiStage", "ViscStage"]}
    assert set(found["coare"] + found["ecmwf"]) == one_input


def _grad_case(cfg, case, dtype=torch.float64, shape=(37, 129)):
    """Inputs and state of one step on the card: a warm layer built on a
    part of the grid, the tie state (Hz_wl == HWL_MAX everywhere, as in a
    fresh state) or one of the exact zeros of the path."""
    *args, lon = _step_inputs(dtype, "cuda", shape=shape)
    args = list(_humidity_inputs(args, cfg.humidity))
    state = tapi.init_skin_state(cfg, shape, dtype, "cuda")
    if case == "built" and cfg.algo == "ecmwf":
        # the ECMWF scheme keeps Hz_wl = 3 m and no accumulators
        state = state._replace(dT_wl=state.dT_wl + 0.3 * (lon > 180))
    elif case == "built":
        state = state._replace(dT_wl=state.dT_wl + 0.3 * (lon > 180),
                               Hz_wl=state.Hz_wl - 15.0 * (lon > 90),
                               Qnt_ac=state.Qnt_ac + 2e5 * (lon < 90),
                               Tau_ac=state.Tau_ac + 50.0 * (lon < 270))
    elif case == "calm_v":
        args[4] = torch.zeros_like(args[4])
    elif case == "t_eq_sst":
        args[1] = args[0].clone()
    elif case == "night":
        args[6] = torch.zeros_like(args[6])
    elif case == "dawn":
        lon = -115.0 + 30.0 * (lon / 360.0)
    return (*args, lon, *state)


def _grad_kernel_vs_plain(cfg, ins, isd=20000):
    cts = _cotangents(ins[0])
    launches = tfused.GRAD_LAUNCHES
    got = tfused.fused_flux_step_grad(cfg, ins, cts, isd)
    torch.cuda.synchronize()
    assert tfused.GRAD_LAUNCHES == launches + 1
    ref = tfused.fused_flux_step_vjp_plain(cfg, ins[:9],
                                           tapi.SkinState(*ins[9:]), cts, isd)
    for name, g, r in zip(tfused._INPUTS, got, ref):
        assert bool(torch.isfinite(g).all()), name
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale,
                                   msg=name)


_GRAD_CONFIGS = [dict(algo=a, humidity=h, niter=n)
                 for a in ("coare3p0", "coare3p6") for h in ("sh", "rh", "dp")
                 for n in (1, 2, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", _GRAD_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_grad_kernel_matches_plain_fp64_on_gpu(kw):
    """Kernel 2 against autograd of the eager step, fp64, rtol 1e-9 and
    atol 1e-9 * max|ref|: forward tangents and reverse mode sum the same
    terms in another order, and FMA contraction moves the last bits."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(use_skin=True, **kw)
    _grad_kernel_vs_plain(cfg, _grad_case(cfg, "built"))


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["coare3p6", "ecmwf"])
@pytest.mark.parametrize("case", ["tie", "calm_v", "t_eq_sst", "night",
                                  "dawn"])
def test_grad_kernel_at_ties_and_zeros_fp64_on_gpu(case, algo):
    """The ties of a fresh state (COARE: Hz_wl == HWL_MAX at wl_coare's
    clamp; ECMWF: dT_wl == 0 at wl_ecmwf's MAX(., 0)) and the exact zeros,
    where the kernel's tangents must follow the reverse-mode conventions."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=True)
    _grad_kernel_vs_plain(cfg, _grad_case(cfg, case), isd=43200)


@pytest.mark.cuda
def test_grad_kernel_wrapper_checks_cotangents_on_gpu():
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(use_skin=True)
    ins = _grad_case(cfg, "tie", torch.float32, shape=(4, 32))
    cts = _cotangents(ins[0])
    with pytest.raises(ValueError, match="13 and 10"):
        tfused.fused_flux_step_grad(cfg, ins, cts[:9])
    with pytest.raises(ValueError, match="cotangent of QH.*contiguous"):
        tfused.fused_flux_step_grad(
            cfg, ins, [cts[0], cts[1].t().contiguous().t(), *cts[2:]])
    with pytest.raises(ValueError, match="cotangent of T_s.*float64"):
        tfused.fused_flux_step_grad(cfg, ins, [*cts[:5], cts[5].double(),
                                               *cts[6:]])
    with pytest.raises(ValueError, match="cotangent of Tau_ac"):
        tfused.fused_flux_step_grad(cfg, ins, [*cts[:9], cts[9][:2]])


@pytest.mark.cuda
@pytest.mark.parametrize("grad_backend", ["kernel", "eager"])
def test_fused_step_autograd_on_gpu(grad_backend):
    """Autograd through fused_flux_step on the card: both backward passes
    give the eager gradient (fp64, rtol 1e-9), and only "kernel"
    launches the gradient kernel."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    ins = _grad_case(cfg, "built")
    leaves = [x.clone().requires_grad_() for x in ins]
    launches = tfused.GRAD_LAUNCHES
    outs, state = tfused.fused_flux_step(
        cfg, *leaves[:8], lon=leaves[8], isecday_utc=43200,
        skin_state=tapi.SkinState(*leaves[9:]), grad_backend=grad_backend)
    # QH and T_s only: the other cotangents are materialized as zeros
    loss = (outs[1] * outs[1]).sum() + outs[5].sum() + state.Hz_wl.sum()
    got = torch.autograd.grad(loss, leaves, materialize_grads=True)
    assert tfused.GRAD_LAUNCHES == launches + (grad_backend == "kernel")
    ref_leaves = [x.clone().requires_grad_() for x in ins]
    routs, rstate = tfused.fused_flux_step_plain(
        cfg, *ref_leaves[:8], lon=ref_leaves[8], isecday_utc=43200,
        skin_state=tapi.SkinState(*ref_leaves[9:]))
    ref = torch.autograd.grad((routs[1] * routs[1]).sum() + routs[5].sum()
                              + rstate.Hz_wl.sum(), ref_leaves,
                              materialize_grads=True)
    for name, g, r in zip(tfused._INPUTS, got, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale,
                                   msg=name)


# ---------------------------------------------------------------------------
# kernels 1 and 2 for ECMWF + skin (fused_step_ecmwf.cu, fused_grad_ecmwf.cu)
# ---------------------------------------------------------------------------

_ECMWF_CONFIGS = [dict(humidity=h, zt=zt, niter=n) for h in ("sh", "rh", "dp")
                  for zt, n in ((2.0, 5), (10.0, 1), (2.0, 4))]


@pytest.mark.cuda
@pytest.mark.parametrize("kw", _ECMWF_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_ecmwf_kernel_matches_plain_fp64_on_gpu(kw):
    """The ECMWF + skin step (BASELINE config 4) for every branch it takes
    from its arguments, fp64, rtol 1e-9 and atol 1e-9 * max|ref| (FMA
    contraction only); Hz_wl, Qnt_ac and Tau_ac pass through unchanged."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True, **kw)
    ins = _grad_case(cfg, "built")
    launches = tfused.LAUNCHES
    outs, new = tfused.fused_flux_step(cfg, *ins[:8], lon=ins[8],
                                       isecday_utc=20000,
                                       skin_state=tapi.SkinState(*ins[9:]))
    torch.cuda.synchronize()
    assert tfused.LAUNCHES == launches + 1
    pouts, pnew = tfused.fused_flux_step_plain(
        cfg, *ins[:8], lon=ins[8], isecday_utc=20000,
        skin_state=tapi.SkinState(*ins[9:]))
    for name, g, r in zip(tfused._OUTPUTS, outs + new, pouts + pnew):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale,
                                   msg=name)
    for a, b in zip(new[1:], ins[10:]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_ecmwf_kernel_matches_plain_fp32_on_gpu():
    """fp32, the gate of test_kernel_matches_plain_fp32_on_gpu."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True)
    *args, lon = _step_inputs(torch.float32, "cuda", shape=(64, 512))
    outs, new = tfused.fused_flux_step(cfg, *args, lon=lon)
    pouts, pnew = tfused.fused_flux_step_plain(cfg, *args, lon=lon)
    for g, r in zip(outs + new, pouts + pnew):
        d = (g - r).abs()
        nonzero = r[r != 0].abs()
        med = float(nonzero.median()) if nonzero.numel() else 1e-6
        assert bool(torch.isfinite(g).all())
        assert float((d > 0.1 * med).float().mean()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(humidity=h, niter=n)
                                for h in ("sh", "rh", "dp")
                                for n in (1, 2, 5)],
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_ecmwf_grad_kernel_matches_plain_fp64_on_gpu(kw):
    """Kernel 2's ECMWF variant against autograd of the eager step, fp64,
    rtol 1e-9 and atol 1e-9 * max|ref|, from a state with a warm layer on
    part of the grid."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True, **kw)
    _grad_kernel_vs_plain(cfg, _grad_case(cfg, "built"))


@pytest.mark.cuda
def test_ecmwf_fused_series_and_gradient_on_gpu():
    """Four records of run_series(backend="fused") for ECMWF + skin, fp64:
    one step launch per record, the eager series' values (rtol 1e-9), and
    through fused_grad_backend="kernel" one gradient launch per record and
    the eager series' gradient (rtol 1e-8: four records of FMA-level
    differences)."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="ecmwf", use_skin=True)
    nt = 4
    *args, lon = _step_inputs(torch.float64, "cuda", shape=(16, 64))
    names = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
             "rad_lw")
    forcing = {n: torch.stack([a * (1.0 + 0.05 * k) if n == "rad_sw" else a
                               for k in range(nt)])
               for n, a in zip(names, args)}
    res = {}
    for backend in ("fused", "eager"):
        sst = forcing["sst"].clone().requires_grad_()
        launches = (tfused.LAUNCHES, tfused.GRAD_LAUNCHES)
        out, state = tapi.run_series(cfg, {**forcing, "sst": sst}, lon=lon,
                                     backend=backend)
        (g,) = torch.autograd.grad((out.QL + out.QH).sum(), sst)
        res[backend] = (out, state, g)
        if backend == "fused":
            assert (tfused.LAUNCHES, tfused.GRAD_LAUNCHES) == \
                (launches[0] + nt, launches[1] + nt)
    (fo, fs, fg), (eo, es, eg) = res["fused"], res["eager"]
    assert bool((fs.dT_wl > 0).any())
    for a, b in ((fo.QL, eo.QL), (fo.QH, eo.QH), (fo.T_s, eo.T_s),
                 (fs.dT_wl, es.dT_wl)):
        torch.testing.assert_close(a.detach(), b.detach(), rtol=1e-9,
                                   atol=1e-9 * float(b.abs().max()))
    torch.testing.assert_close(fg, eg, rtol=1e-8,
                               atol=1e-8 * float(eg.abs().max()))


# ---------------------------------------------------------------------------
# kernel 6: the primitive chain (primitive_chain.cu)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("op", tchain.CLASSES + tchain.FORMS)
def test_primitive_chain_on_cpu_is_the_plain_version(op):
    x = torch.as_tensor(np.random.default_rng(1).random((8, 16)))
    launches = tchain.LAUNCHES
    got = tchain.primitive_chain(x, op, K=8, P=3)
    assert tchain.LAUNCHES == launches
    torch.testing.assert_close(got, tchain.primitive_chain_plain(x, op, 8, 3),
                               rtol=0, atol=0)


def test_primitive_chain_instantiations_cover_the_roofline():
    """The kernel is built for every P at K = 64 in every class (the rates
    and the P sweep) and for the FMA-ceiling probes of the cheap class, and
    the fp32 tolerance is 1e-5 wherever K = 64."""
    for op in tchain.CLASSES:
        assert all(tchain.instantiated(op, P, 64) for P in tchain.CHAINS)
        assert tchain.instantiated(op, 2, 256) == (op == "cheap")
        assert tchain.instantiated(op, 4, 128) == (op == "cheap")
    assert not tchain.instantiated("cheap", 3, 64)
    assert not tchain.instantiated("cheap", 2, 32)
    assert {tchain.plain_rtol(torch.float32, 64, P)
            for P in tchain.CHAINS} == {1e-5}
    assert tchain.plain_rtol(torch.float32, 256, 2) == 258 * 2.0 ** -23
    assert tchain.plain_rtol(torch.float64, 256, 8) == 1e-12


def test_primitive_chain_refuses_unknown_classes_and_devices():
    with pytest.raises(ValueError, match="unknown op class"):
        tchain.primitive_chain(torch.zeros(4), "tanh")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tchain.primitive_chain(torch.empty(4, device="meta"), "exp")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("op", tchain.CLASSES + tchain.FORMS)
def test_primitive_chain_matches_plain_on_gpu(op, dtype):
    """Every (P, K) the kernel is built for, on a ragged size, against the
    plain version on the card, within kernels.roofline.plain_rtol: max
    relative difference 1e-12 in fp64; in fp32 1e-5 (libdevice against
    PyTorch's CUDA math along a contracting chain), or one ulp per
    application of the cheap class's non-contracting FMA where that is
    more; a form's FORM_ULPS per application (div.full.f32 and
    sqrt.approx.f32 are fp32 only)."""
    _cuda_or_skip()
    x = torch.as_tensor(np.random.default_rng(2).random(1000), dtype=dtype,
                        device="cuda")
    for P, K in itertools.product(tchain.CHAINS, tchain.DEPTHS):
        if not tchain.instantiated(op, P, K, dtype):
            with pytest.raises(ValueError, match="built for"):
                tchain.primitive_chain(x, op, K=K, P=P)
            continue
        launches = tchain.LAUNCHES
        got = tchain.primitive_chain(x, op, K=K, P=P)
        torch.cuda.synchronize()
        assert tchain.LAUNCHES == launches + 1
        ref = tchain.primitive_chain_plain(x, op, K, P)
        assert float(((got - ref).abs() / ref.abs()).max()) <= \
            tchain.plain_rtol(dtype, K, P, op), (P, K)


@pytest.mark.cuda
def test_primitive_chain_wrapper_checks_on_gpu():
    _cuda_or_skip()
    x = torch.rand(64, 32, device="cuda")
    with pytest.raises(ValueError, match="P in"):
        tchain.primitive_chain(x, "exp", K=64, P=3)
    with pytest.raises(ValueError, match="K in"):
        tchain.primitive_chain(x, "exp", K=32, P=2)
    with pytest.raises(TypeError, match="float32 or float64"):
        tchain.primitive_chain(x.half(), "exp")
    with pytest.raises(ValueError, match="contiguous"):
        tchain.primitive_chain(x.t(), "exp")
    assert tchain.primitive_chain(x[:0], "exp").shape == (0, 32)


@pytest.mark.cuda
def test_measure_primitive_throughput_on_gpu():
    """The rates come from CUDA-graph replays of chained launches: finite,
    positive, and the cheap class under the data sheet's FMA rate."""
    _cuda_or_skip()
    rates = troofline.measure_primitive_throughput(
        shape=(512, 512), ops=("cheap", "exp"), repeats=2)
    assert set(rates) == {"cheap", "exp"}
    assert all(np.isfinite(v) and v > 0 for v in rates.values())
    assert rates["cheap"] < 33.5e12


# ---------------------------------------------------------------------------
# the stateless kernel (bulk_step.cu)
# ---------------------------------------------------------------------------

_ALGOS = ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas")


def _bulk_inputs(dtype=torch.float64, device="cpu", shape=(2, 3, 40),
                 seed=5):
    rng = np.random.default_rng(seed)
    sst = 285.0 + 15.0 * rng.random(shape)
    arrays = (sst, sst + rng.normal(0, 2, shape),
              0.004 + 0.012 * rng.random(shape), rng.normal(0, 6, shape),
              rng.normal(0, 6, shape), 98000 + 4000 * rng.random(shape))
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


@pytest.mark.parametrize("algo", _ALGOS)
def test_fused_bulk_step_on_cpu_is_the_plain_version(algo):
    cfg = tapi.AeroBulkConfig(algo=algo, niter=3)
    args = _bulk_inputs()
    launches = tfused.BULK_LAUNCHES
    got = tfused.fused_bulk_step(cfg, *args)
    assert tfused.BULK_LAUNCHES == launches
    ref, _ = tapi.flux_step(cfg, *args)
    for g, r in zip(got, (ref.QL, ref.QH, ref.Tau_x, ref.Tau_y, ref.Evap,
                          ref.T_s)):
        assert g.shape == args[0].shape
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("kw,err", [
    (dict(use_skin=True), ValueError),
    (dict(algo="ecmwf", use_skin=True), ValueError),
    (dict(humidity="auto"), ValueError),
])
def test_fused_bulk_step_refuses_configs_it_does_not_take(kw, err):
    with pytest.raises(err):
        tfused.fused_bulk_step(tapi.AeroBulkConfig(**kw), *_bulk_inputs())


@pytest.mark.parametrize("algo", ["ncar", "coare3p0"])
def test_fused_bulk_step_matches_jax_pallas_interpret(algo):
    """The port's stateless step on a 3-D shape against aerobulk_tpu's
    fused_bulk_step run as tests/test_pallas_kernel.py runs it on the CPU
    (interpret mode, (8, 128) tiles).  rtol 5e-7 and atol 1e-9, the bar
    that test holds the Pallas body to against the JAX jit path: the body
    is not the jit graph (the TPU workarounds of math_compat)."""
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig as JConfig
    from aerobulk_tpu.kernels import fused_bulk_step as j_bulk
    args = _bulk_inputs()
    kw = dict(algo=algo, niter=4)
    ref = j_bulk(JConfig(**kw), *(jnp.asarray(a.numpy()) for a in args),
                 block=(8, 128), interpret=True)
    got = tfused.fused_bulk_step(tapi.AeroBulkConfig(**kw), *args)
    for name, g, r in zip(tfused._OUTPUTS, got, ref):
        assert g.shape == tuple(r.shape)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-7,
                                   atol=1e-9, err_msg=name)


def test_fused_bulk_step_broadcasts_like_jax():
    """A Python-float slp, a 0-d fp32 humidity and a 0-d V broadcast and
    promote as in aerobulk_tpu (tests/test_pallas_kernel.py::test_fused_
    bulk_step_broadcasts_like_jit), against its Pallas kernel in interpret
    mode at the same rtol 5e-7."""
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig as JConfig
    from aerobulk_tpu.kernels import fused_bulk_step as j_bulk
    rng = np.random.default_rng(3)
    sst = 290.0 + 5.0 * rng.random(17)
    u = rng.normal(4, 2, 17)
    cfg = dict(algo="ncar", niter=4)
    ref = j_bulk(JConfig(**cfg), jnp.asarray(sst), jnp.asarray(sst - 1.0),
                 jnp.asarray(0.01, jnp.float32), jnp.asarray(u),
                 jnp.asarray(0.0), 101000.0, block=(8, 128), interpret=True)
    T = torch.as_tensor
    got = tfused.fused_bulk_step(tapi.AeroBulkConfig(**cfg), T(sst),
                                 T(sst - 1.0),
                                 torch.tensor(0.01, dtype=torch.float32),
                                 T(u), torch.tensor(0.0, dtype=torch.float64),
                                 101000.0)
    for g, r in zip(got, ref):
        assert g.shape == (17,) and g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-7,
                                   atol=1e-9)


def _jax_grad_census(algo):
    """The census of jax.vjp of the stateful step of ``algo`` (niter=5,
    fp32, a (1, 1) field; the inputs of roofline.flux_step_counts) applied
    to its 10 cotangents: the forward and the transpose graph."""
    import jax
    import jax.numpy as jnp
    from aerobulk_tpu.api import AeroBulkConfig, flux_step, init_skin_state
    from aerobulk_tpu.roofline import count_primitives
    from aerobulk_tpu.skin import SkinState
    cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=5, use_skin=True)
    z = jnp.zeros((1, 1), jnp.float32)

    def step(sst, t, q, u, v, slp, rsw, rlw, lon, st):
        out, ns = flux_step(cfg, sst, t, q, u, v, slp, skin_state=st,
                            rad_sw=rsw, rad_lw=rlw, isecday_utc=43200,
                            lon=lon)
        return (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s), ns

    def grad(*args):
        _, vjp = jax.vjp(step, *args[:10])
        return vjp((args[10:16], SkinState(*args[16:])))
    return count_primitives(grad, z + 290.0, z + 289.0, z + 0.01, z + 5.0, z,
                            z + 1.01e5, z + 200.0, z + 350.0, z,
                            init_skin_state(cfg, (1, 1), jnp.float32),
                            *([z] * 10))


def _jax_census(key):
    """The census of one CENSUS entry from the JAX graph (aerobulk_tpu/
    roofline.py, niter=5, fp32, a (1, 1) field)."""
    import jax.numpy as jnp
    from aerobulk_tpu.api import flux_step_ice, flux_step_mixed
    from aerobulk_tpu.roofline import count_primitives, flux_step_counts
    if key.startswith("grad_"):
        return _jax_grad_census(key.removeprefix("grad_skin_"))
    if not key.startswith(("ice_", "mixed_")):
        skin = key.startswith("skin_")
        return flux_step_counts(algo=key.removeprefix("skin_"), niter=5,
                                use_skin=skin)
    z = jnp.zeros((1, 1), jnp.float32)
    air = (z + 258.0, z + 0.002, z + 5.0, z, z + 1.01e5)
    if key.startswith("ice_"):
        def ice(Ts, t, q, u, v, slp, fr):
            out, _ = flux_step_ice(key, 2.0, 10.0, Ts, t, q, u, v, slp,
                                   frice=fr, niter=5)
            return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s
        return count_primitives(ice, z + 260.0, *air, z + 0.5)

    def mixed(Ts, sst, t, q, u, v, slp, fr):
        net, _, _ = flux_step_mixed(2.0, 10.0, Ts, sst, t, q, u, v, slp, fr,
                                    niter=5,
                                    simultaneous=key == "mixed_lg15_io")
        return net.QL, net.QH, net.Tau, net.Evap, net.T_s
    return count_primitives(mixed, z + 260.0, z + 271.0, *air, z + 0.5)


@pytest.mark.parametrize("key", sorted(troofline.CENSUS))
def test_chip_smoke_op_census_matches_jax(key):
    """Every class of every entry of the port's census (roofline.CENSUS)
    is the JAX graph's count (aerobulk_tpu/roofline.py), and chip_smoke.py
    divides the entry's total by the peak rate."""
    import chip_smoke
    ref = _jax_census(key)
    assert dict(troofline.CENSUS[key]) == dict(ref)
    assert chip_smoke.OPS_PER_POINT[key] == sum(ref.values())


def test_census_has_every_step_a_kernel_runs():
    """Kernels 1 (three skin algorithms), 2 (the two chip_smoke.py times),
    3 (five), 4 (seven) and 5 (the two mixed cells chip_smoke.py
    times)."""
    import chip_smoke
    assert set(troofline.CENSUS) == (
        {f"skin_{a}" for a in ("coare3p0", "coare3p6", "ecmwf")}
        | set(_ALGOS) | set(chip_smoke.ICE_REGISTRY)
        | {"mixed_ice_lg15_ecmwf", "mixed_lg15_io"}
        | {"grad_skin_coare3p6", "grad_skin_ecmwf"})
    assert sum(troofline.CENSUS["skin_ecmwf"].values()) == 6547
    # kernel 2's work: jax.vjp of the step is 3.0x (COARE 3.6 + skin) and
    # 2.9x (ECMWF + skin) the forward step
    assert sum(troofline.CENSUS["grad_skin_coare3p6"].values()) == 12557
    assert sum(troofline.CENSUS["grad_skin_ecmwf"].values()) == 18670


_BULK_CONFIGS = ([dict(algo=a, humidity=h, zt=2.0, niter=5)
                  for a in _ALGOS for h in ("sh", "rh", "dp")]
                 + [dict(algo=a, humidity="sh", zt=zt, niter=n)
                    for a in _ALGOS for zt, n in ((10.0, 1), (2.0, 4))])


@pytest.mark.cuda
@pytest.mark.parametrize("kw", _BULK_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_bulk_kernel_matches_plain_fp64_on_gpu(kw):
    """Every algorithm and every branch the stateless kernel takes from its
    arguments, fp64, rtol 1e-9 and atol 1e-9 * max|ref| (FMA contraction
    only)."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(**kw)
    *args, lon = _step_inputs(torch.float64, "cuda", shape=(37, 129))
    args = _humidity_inputs(args, kw["humidity"])[:6]
    launches = tfused.BULK_LAUNCHES
    got = tfused.fused_bulk_step(cfg, *args)
    torch.cuda.synchronize()
    assert tfused.BULK_LAUNCHES == launches + 1
    ref = tfused.fused_bulk_step_plain(cfg, *args)
    for name, g, r in zip(tfused._OUTPUTS, got, ref):
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale,
                                   msg=name)


@pytest.mark.cuda
def test_bulk_kernel_takes_any_shape_on_gpu():
    """A 3-D shape with a ragged last block, broadcast scalars and an empty
    input: the wrapper flattens, launches once and restores the shape."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="ncar")
    args = _bulk_inputs(torch.float32, "cuda", shape=(3, 5, 71))
    args[5] = 101325.0
    args[4] = torch.tensor(1.5, device="cuda")
    launches = tfused.BULK_LAUNCHES
    got = tfused.fused_bulk_step(cfg, *args)
    ref = tfused.fused_bulk_step_plain(cfg, *args)
    assert tfused.BULK_LAUNCHES == launches + 1
    for g, r in zip(got, ref):
        assert g.shape == (3, 5, 71) and g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * float(
            r.abs().max()))
    empty = tfused.fused_bulk_step(cfg, *(a[:0] if isinstance(a, torch.Tensor)
                                          and a.dim() else a for a in args))
    assert all(x.shape == (0, 5, 71) for x in empty)


@pytest.mark.cuda
def test_bulk_kernel_refuses_gradients_on_gpu():
    """The kernel has no backward pass (nor has the Pallas kernel): an
    input that requires a gradient raises and names the eager backend;
    under no_grad the same inputs run."""
    _cuda_or_skip()
    cfg = tapi.AeroBulkConfig(algo="coare3p6")
    args = _bulk_inputs(torch.float64, "cuda")
    args[0].requires_grad_()
    launches = tfused.BULK_LAUNCHES
    with pytest.raises(RuntimeError, match="backend='eager'"):
        tfused.fused_bulk_step(cfg, *args)
    assert tfused.BULK_LAUNCHES == launches
    with torch.no_grad():
        tfused.fused_bulk_step(cfg, *args)
    assert tfused.BULK_LAUNCHES == launches + 1


# ---------------------------------------------------------------------------
# the ice-only and mixed ocean+ice kernels (ice_step.cu, mixed_step.cuh)
# ---------------------------------------------------------------------------

_ICE = tuple(tfused._ICE_ALGOS)
_EASY_KW = dict(CdN=1.6e-3, ChN=1.5e-3, CeN=1.5e-3)


def _ice_inputs(dtype=torch.float64, device="cpu", shape=(37, 129),
                humidity="sh", seed=9):
    """(Ts_i, sst, t_zt, hum_zt, U_zu, V_zu, slp, frice): ice from 230 K to
    the melting point, air within 6 K of it, winds from calm to storm, ice
    fractions over [0, 1) with exact 0 and 1 at two points."""
    rng = np.random.default_rng(seed)
    Ts = 230.0 + 43.15 * rng.random(shape)
    t = Ts + rng.uniform(-6.0, 6.0, shape)
    hum = {"sh": 1e-4 + 4e-3 * rng.random(shape),
           "rh": 40.0 + 60.0 * rng.random(shape),
           "dp": t - 0.5 - 7.5 * rng.random(shape)}[humidity]
    frice = rng.random(shape)
    frice.flat[0], frice.flat[1] = 0.0, 1.0
    arrays = (Ts, 271.2 + 18.0 * rng.random(shape), t, hum,
              rng.normal(0.0, 8.0, shape), rng.normal(0.0, 8.0, shape),
              98000.0 + 5000.0 * rng.random(shape), frice)
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def _ice_args(x):
    """The ice step's fields of an ``_ice_inputs`` tuple (no sst)."""
    return x[0], *x[2:7]


@pytest.mark.parametrize("algo", _ICE)
def test_fused_ice_step_on_cpu_is_the_plain_version(algo):
    x = _ice_inputs(shape=(3, 17))
    kw = _EASY_KW if algo == "ice_easy" else {}
    launches = tfused.ICE_LAUNCHES
    got = tfused.fused_ice_step(algo, 2.0, 10.0, *_ice_args(x), frice=x[7],
                                niter=3, **kw)
    assert tfused.ICE_LAUNCHES == launches
    ref, _ = tapi.flux_step_ice(algo, 2.0, 10.0, *_ice_args(x), frice=x[7],
                                niter=3, **kw)
    for g, r in zip(got, (ref.QL, ref.QH, ref.Tau_x, ref.Tau_y, ref.Evap,
                          ref.T_s)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("simultaneous", [False, True])
def test_fused_mixed_step_on_cpu_is_the_plain_version(simultaneous):
    x = _ice_inputs(shape=(3, 17))
    launches = tfused.MIXED_LAUNCHES
    got = tfused.fused_mixed_step(2.0, 10.0, *x, ocean_algo="ncar", niter=3,
                                  simultaneous=simultaneous)
    assert tfused.MIXED_LAUNCHES == launches
    net, _, _ = tapi.flux_step_mixed(2.0, 10.0, *x, ocean_algo="ncar",
                                     niter=3, simultaneous=simultaneous)
    for g, r in zip(got, (net.QL, net.QH, net.Tau, net.Evap, net.T_s)):
        torch.testing.assert_close(g, r, rtol=0, atol=0)


@pytest.mark.parametrize("call,err,match", [
    (lambda x: tfused.fused_ice_step("ice_lg15", 2.0, 10.0, *_ice_args(x)),
     ValueError, "requires the ice concentration"),
    (lambda x: tfused.fused_ice_step("ice_lu12", 2.0, 10.0, *_ice_args(x)),
     ValueError, "requires the ice concentration"),
    (lambda x: tfused.fused_ice_step("ice_foo", 2.0, 10.0, *_ice_args(x)),
     ValueError, "unknown ice algorithm"),
    (lambda x: tfused.fused_ice_step("ice_nemo", 2.0, 10.0, *_ice_args(x),
                                     humidity="auto"),
     ValueError, "humidity"),
    (lambda x: tfused.fused_ice_step("ice_nemo", 2.0, 10.0, *_ice_args(x),
                                     CdN=1e-3),
     TypeError, "takes no settings"),
    (lambda x: tfused.fused_mixed_step(2.0, 10.0, *x, ocean_algo="foo"),
     ValueError, "unknown ocean algorithm"),
    (lambda x: tfused.fused_mixed_step(2.0, 10.0, *x, ice_algo="foo"),
     ValueError, "unknown ice algorithm"),
])
def test_ice_kernel_wrappers_refuse_what_they_do_not_take(call, err, match):
    with pytest.raises(err, match=match):
        call(_ice_inputs(shape=(2, 5)))


def test_ice_kernel_wrappers_refuse_other_devices():
    """A device that is neither CPU nor CUDA has no kernel and no plain
    fallback."""
    x = [torch.empty(2, 5, device="meta", dtype=torch.float64)
         for _ in range(8)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfused.fused_ice_step("ice_nemo", 2.0, 10.0, *_ice_args(x))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tfused.fused_mixed_step(2.0, 10.0, *x)


_ICE_CONFIGS = [dict(algo=a, humidity=h, zt=zt)
                for a in _ICE for h in ("sh", "rh", "dp")
                for zt in (2.0, 10.0)]


def _ice_kernel_vs_plain(step, plain, *args, **kw):
    launches = (tfused.ICE_LAUNCHES, tfused.MIXED_LAUNCHES)
    got = step(*args, **kw)
    torch.cuda.synchronize()
    counter = 0 if step is tfused.fused_ice_step else 1
    now = (tfused.ICE_LAUNCHES, tfused.MIXED_LAUNCHES)
    assert now[counter] == launches[counter] + 1
    assert now[1 - counter] == launches[1 - counter]
    ref = plain(*args, **kw)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        scale = float(r.abs().max())
        torch.testing.assert_close(g, r, rtol=1e-9, atol=1e-9 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", _ICE_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_ice_kernel_matches_plain_fp64_on_gpu(kw):
    """Every algorithm, humidity kind and (zt == zu or not) branch of the
    ice kernel, fp64, rtol 1e-9 and atol 1e-9 * max|ref| (FMA contraction
    only)."""
    _cuda_or_skip()
    x = _ice_inputs(torch.float64, "cuda", humidity=kw["humidity"])
    _ice_kernel_vs_plain(tfused.fused_ice_step, tfused.fused_ice_step_plain,
                         kw["algo"], kw["zt"], 10.0, *_ice_args(x),
                         frice=x[7], humidity=kw["humidity"])


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [2.0, 10.0])
def test_ice_easy_settings_on_gpu(zt):
    """ice_easy's CdN, ChN, CeN reach the kernel (fp64, rtol 1e-9), and
    other values give other fluxes."""
    _cuda_or_skip()
    x = _ice_inputs(torch.float64, "cuda")
    _ice_kernel_vs_plain(tfused.fused_ice_step, tfused.fused_ice_step_plain,
                         "ice_easy", zt, 10.0, *_ice_args(x), **_EASY_KW)
    a = tfused.fused_ice_step("ice_easy", zt, 10.0, *_ice_args(x),
                              **_EASY_KW)
    b = tfused.fused_ice_step("ice_easy", zt, 10.0, *_ice_args(x))
    assert not torch.equal(a[1], b[1])


_MIXED_CONFIGS = ([dict(ice_algo="ice_lg15", ocean_algo=o) for o in _ALGOS]
                  + [dict(ice_algo=a, ocean_algo="ecmwf") for a in _ICE
                     if a != "ice_lg15"]
                  + [dict(simultaneous=True)])


@pytest.mark.cuda
@pytest.mark.parametrize("zt", [2.0, 10.0])
@pytest.mark.parametrize("kw", _MIXED_CONFIGS,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_mixed_kernel_matches_plain_fp64_on_gpu(kw, zt):
    """Every ice algorithm with ECMWF leads, every ocean algorithm with LG15
    ice and the simultaneous LG15_IO solve, fp64, rtol 1e-9 and atol 1e-9 *
    max|ref|."""
    _cuda_or_skip()
    x = _ice_inputs(torch.float64, "cuda")
    _ice_kernel_vs_plain(tfused.fused_mixed_step,
                         tfused.fused_mixed_step_plain, zt, 10.0, *x, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("humidity", ["rh", "dp"])
def test_mixed_kernel_humidity_kinds_fp64_on_gpu(humidity):
    _cuda_or_skip()
    x = _ice_inputs(torch.float64, "cuda", humidity=humidity)
    _ice_kernel_vs_plain(tfused.fused_mixed_step,
                         tfused.fused_mixed_step_plain, 2.0, 10.0, *x,
                         humidity=humidity)


@pytest.mark.cuda
def test_ice_kernels_take_ragged_and_empty_inputs_on_gpu():
    """A size that is not a multiple of the block (3 x 5 x 71 points) keeps
    its shape; a 0-point input launches nothing that fails."""
    _cuda_or_skip()
    x = _ice_inputs(torch.float32, "cuda", shape=(3, 5, 71))
    got = tfused.fused_ice_step("ice_lg15", 2.0, 10.0, *_ice_args(x),
                                frice=x[7])
    ref = tfused.fused_ice_step_plain("ice_lg15", 2.0, 10.0, *_ice_args(x),
                                      frice=x[7])
    for g, r in zip(got, ref):
        assert g.shape == (3, 5, 71) and g.dtype == torch.float32
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    got = tfused.fused_mixed_step(2.0, 10.0, *x)
    ref = tfused.fused_mixed_step_plain(2.0, 10.0, *x)
    for g, r in zip(got, ref):
        assert g.shape == (3, 5, 71)
        torch.testing.assert_close(g, r, rtol=1e-4,
                                   atol=1e-4 * float(r.abs().max()))
    empty = [a[:0] for a in x]
    assert all(o.shape == (0, 5, 71) for o in
               tfused.fused_ice_step("ice_an05", 2.0, 10.0,
                                     *_ice_args(empty)))
    assert all(o.shape == (0, 5, 71) for o in
               tfused.fused_mixed_step(2.0, 10.0, *empty))


@pytest.mark.cuda
def test_ice_kernels_refuse_gradients_and_missing_frice_on_gpu():
    """Neither kernel has a backward pass (nor has the Pallas kernel): an
    input that requires a gradient raises and names the eager path; under
    no_grad the same inputs run.  ice_lg15 without frice raises."""
    _cuda_or_skip()
    x = _ice_inputs(torch.float64, "cuda")
    with pytest.raises(ValueError, match="requires the ice concentration"):
        tfused.fused_ice_step("ice_lg15", 2.0, 10.0, *_ice_args(x))
    x[0].requires_grad_()
    launches = (tfused.ICE_LAUNCHES, tfused.MIXED_LAUNCHES)
    with pytest.raises(RuntimeError, match="api.flux_step_ice"):
        tfused.fused_ice_step("ice_lg15", 2.0, 10.0, *_ice_args(x),
                              frice=x[7])
    with pytest.raises(RuntimeError, match="api.flux_step_mixed"):
        tfused.fused_mixed_step(2.0, 10.0, *x)
    assert (tfused.ICE_LAUNCHES, tfused.MIXED_LAUNCHES) == launches
    with torch.no_grad():
        tfused.fused_ice_step("ice_lg15", 2.0, 10.0, *_ice_args(x),
                              frice=x[7])
        tfused.fused_mixed_step(2.0, 10.0, *x)
    assert (tfused.ICE_LAUNCHES, tfused.MIXED_LAUNCHES) == \
        (launches[0] + 1, launches[1] + 1)


# ---------------------------------------------------------------------------
# the validity envelope's corners (chip_smoke.py phase 21, abridged)
# ---------------------------------------------------------------------------

def _corner_cases():
    """(label, kernel call, plain call, number of outputs) of kernels 1, 3,
    4 and 5 on the envelope's corners: the first four points of the ocean
    envelope (u = 0 with t = sst and with t = sst + 25 K, 50 m/s with t =
    sst - 25 K, u = 0.001) and the first two of the ice envelope (wind 0
    and 50 m/s, frice 0 and 1); each call takes (dtype, device)."""
    from aerobulk_tpu_torch import measure
    ocean = [a[:4] for a in measure.ocean_envelope()]
    ice = [a[:2] for a in measure.ice_envelope()]

    def t(arrs, dt, dev, shape):
        return [torch.as_tensor(a, dtype=dt, device=dev).reshape(shape)
                .contiguous() for a in arrs]

    cases = []
    for algo in ("coare3p6", "ecmwf"):
        cfg = tapi.AeroBulkConfig(algo=algo, niter=10, use_skin=True)

        def step(fn, dt, dev, cfg=cfg):
            *args, lon = t(ocean, dt, dev, (1, 4))
            outs, st = fn(cfg, *args, lon=lon, isecday_utc=50000,
                          skin_state=tapi.init_skin_state(cfg, (1, 4), dt,
                                                          dev))
            return (*outs, *st)
        cases.append((f"step-{algo}", tfused.fused_flux_step,
                      tfused.fused_flux_step_plain, step))
    for algo in _ALGOS:
        bcfg = tapi.AeroBulkConfig(algo=algo, niter=10)
        cases.append((f"bulk-{algo}", tfused.fused_bulk_step,
                      tfused.fused_bulk_step_plain,
                      lambda fn, dt, dev, bcfg=bcfg:
                      fn(bcfg, *t(ocean[:6], dt, dev, (4,)))))
    for algo in _ICE:
        def ice_step(fn, dt, dev, algo=algo):
            Ts_i, _, tz, q, u, v, slp, fr = t(ice, dt, dev, (2,))
            return fn(algo, 2.0, 10.0, Ts_i, tz, q, u, v, slp, frice=fr,
                      niter=8)
        cases.append((f"ice-{algo}", tfused.fused_ice_step,
                      tfused.fused_ice_step_plain, ice_step))
    for kw in ([dict(ice_algo="ice_lg15", ocean_algo=o) for o in _ALGOS]
               + [dict(ice_algo=a, ocean_algo="ecmwf") for a in _ICE
                  if a != "ice_lg15"] + [dict(simultaneous=True)]):
        cases.append(("mixed-" + "-".join(str(v) for v in kw.values()),
                      tfused.fused_mixed_step, tfused.fused_mixed_step_plain,
                      lambda fn, dt, dev, kw=kw:
                      fn(2.0, 10.0, *t(ice, dt, dev, (2,)), niter=8, **kw)))
    return cases


_CORNERS = _corner_cases()


def test_envelope_corners_are_finite_on_cpu():
    """The plain versions (the wrappers on CPU tensors) on the corners:
    finite in fp64 and fp32 wherever the fp64 result is."""
    for label, kernel, plain, call in _CORNERS:
        ref = call(plain, torch.float64, "cpu")
        for dt in (torch.float64, torch.float32):
            for i, (g, r) in enumerate(zip(call(kernel, dt, "cpu"), ref)):
                assert not (torch.isfinite(r) & ~torch.isfinite(g)).any(), \
                    (label, dt, i)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", _CORNERS, ids=[c[0] for c in _CORNERS])
def test_envelope_corners_finite_on_gpu(case, dtype):
    """Every output of the kernel finite wherever the eager port in fp64 on
    the card is (chip_smoke.py phase 21's gate, on the corners)."""
    _cuda_or_skip()
    label, kernel, plain, call = case
    ref = call(plain, torch.float64, "cuda")
    got = call(kernel, dtype, "cuda")
    for i, (g, r) in enumerate(zip(got, ref)):
        lost = torch.isfinite(r) & ~torch.isfinite(g)
        assert not lost.any(), (label, i, g.tolist(), r.tolist())
