"""aerobulk_tpu_torch.capi.model_buffers (the flat-buffer entry point of the
C++ binding) on the CPU (``AEROBULK_CAPI_DEVICE=cpu``), against the port's
``flux_step`` and against aerobulk_tpu.capi.model_buffers on the same
buffers, at rtol 1e-12 (tests/test_capi.py's cases); then the C++ binding
of ``cpp_torch/`` built with g++ and run on the CPU.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

from aerobulk_tpu import capi as jcapi
from aerobulk_tpu_torch import capi, cxx
from aerobulk_tpu_torch.api import AeroBulkConfig, flux_step

SST = np.array([295.15, 295.15])
T_ZT = np.array([293.15, 298.15])
Q = np.array([0.012, 0.012])
U = np.array([5.0, 5.0])
V = np.array([0.0, 0.0])
SLP = np.array([101000.0, 101000.0])
OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap")


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv(capi.DEVICE_ENV, "cpu")


def _bufs(n, fill=0.0):
    return bytearray(np.full(n, fill).tobytes())


def _call(model_buffers, hum, niter=10, **kw):
    """One jt=1, Nt=1 call over the 2-point case; returns the outputs by
    name as numpy arrays."""
    outs = [_bufs(len(SST)) for _ in OUTPUTS]
    model_buffers(1, 1, kw.pop("algo", "ncar"), 2.0, 10.0, SST.tobytes(),
                  T_ZT.tobytes(), hum.tobytes(), U.tobytes(), V.tobytes(),
                  SLP.tobytes(), *outs, niter=niter, **kw)
    return {k: np.frombuffer(b) for k, b in zip(OUTPUTS, outs)}


@pytest.mark.parametrize("hum, humidity", [(Q, "sh"),
                                           (np.array([288.15, 289.15]), "dp")],
                         ids=["specific", "dew_point"])
def test_model_buffers_matches_flux_step_and_jax(hum, humidity):
    """Parity, and AEROBULK_INIT's humidity detection at jt == 1
    (mod_aerobulk.f90:126-153): a dew point [K] is detected, not taken as
    specific humidity."""
    got = _call(capi.model_buffers, hum)
    ref = _call(jcapi.model_buffers, hum)
    cfg = AeroBulkConfig(algo="ncar", zt=2.0, zu=10.0, niter=10,
                         humidity=humidity)
    out, _ = flux_step(cfg, *(torch.as_tensor(x) for x in
                              (SST, T_ZT, hum, U, V, SLP)))
    for k in OUTPUTS:
        r = getattr(out, k).numpy()
        atol = 1e-12 * np.max(np.abs(r))
        np.testing.assert_allclose(got[k], r, rtol=1e-12, atol=atol,
                                   err_msg=k)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=atol,
                                   err_msg=k)


def _skin_run(model_buffers, jt, Nt):
    n = 1
    QL, QH, Tx, Ty, E, Ts = (_bufs(n) for _ in range(6))
    model_buffers(jt, Nt, "coare3p6", 2.0, 10.0,
                  np.array([300.15]).tobytes(), np.array([299.15]).tobytes(),
                  np.array([0.016]).tobytes(), np.array([3.0]).tobytes(),
                  np.array([0.0]).tobytes(), np.array([101000.0]).tobytes(),
                  QL, QH, Tx, Ty, E, niter=10, use_skin=True,
                  rad_sw=np.array([700.0]).tobytes(),
                  rad_lw=np.array([420.0]).tobytes(), T_s=Ts)
    return np.frombuffer(Ts)[0], np.frombuffer(QL)[0]


def test_model_buffers_skin_state_carry():
    """jt/Nt state registry: a 2-step warm-layer run differs from two
    independent 1-step runs only through the carried state, as the JAX
    binding's does (rtol 1e-12)."""
    got = [_skin_run(capi.model_buffers, jt, Nt)
           for jt, Nt in ((1, 2), (2, 2), (1, 1))]
    ref = [_skin_run(jcapi.model_buffers, jt, Nt)
           for jt, Nt in ((1, 2), (2, 2), (1, 1))]
    (ts1, _), (ts2, _), (ts_fresh, _) = got
    assert ts1 == ts_fresh           # same initial state
    assert ts2 != ts1                # warm layer accumulated
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_model_buffers_rejects_bad_units():
    """The jt == 1 validation aborts on unit-inconsistent inputs, like the
    reference's check_unit_consistency (mod_phymbl.f90:1851-1954)."""
    outs = [_bufs(2) for _ in OUTPUTS]
    with pytest.raises(ValueError):
        capi.model_buffers(1, 1, "ncar", 2.0, 10.0,
                           np.array([22.0, 22.0]).tobytes(),   # Celsius
                           T_ZT.tobytes(), Q.tobytes(), U.tobytes(),
                           V.tobytes(), SLP.tobytes(), *outs, niter=10)


def test_registry_empty_after_the_last_record():
    capi._STATE.clear()
    for jt in (1, 2, 3):
        _skin_run(capi.model_buffers, jt, 3)
        assert len(capi._STATE) == (0 if jt == 3 else 1)


def test_without_gpu_names_the_cpu_option(monkeypatch):
    monkeypatch.delenv(capi.DEVICE_ENV)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="AEROBULK_CAPI_DEVICE=cpu"):
        _call(capi.model_buffers, Q)


def _cmake_build(build):
    """The example built by cpp_torch/CMakeLists.txt (cmake + ninja)."""
    for tool in ("cmake", "ninja"):
        if shutil.which(tool) is None:
            pytest.skip(f"no C++ toolchain: {tool}")
    subprocess.run(["cmake", "-S", str(cxx.CPP), "-B", str(build), "-G",
                    "Ninja", "-DCMAKE_BUILD_TYPE=Release"], check=True,
                   capture_output=True)
    subprocess.run(["ninja", "-C", str(build)], check=True,
                   capture_output=True)
    return build / cxx.EXAMPLE


@pytest.mark.parametrize("build_tool", ["g++", "cmake"])
def test_cpp_example_builds_and_runs_on_cpu(build_tool, tmp_path):
    missing = cxx.toolchain_missing()
    if missing:
        pytest.skip(f"no C++ toolchain: {missing}")
    exe = (cxx.build_example(tmp_path) if build_tool == "g++"
           else _cmake_build(tmp_path))
    res = cxx.run_example(exe, device="cpu")
    assert res.returncode == 0, res.stderr[-2000:]
    # the COARE 3.0 unstable point at the current reference semantics
    # (tests/test_capi.py::test_cpp_example_builds_and_runs)
    assert "-15.15530" in res.stdout
    assert "-81.38902" in res.stdout
    # two interleaved same-shape series told apart by series_id do not
    # share warm-layer state (the example exits non-zero otherwise)
    assert "interleaved series_id OK" in res.stdout
