"""The per-point adjoint of the gradient kernel (kernels/csrc/adjoint.cuh,
the body of fused_grad.cu and fused_grad_ecmwf.cu) built for the CPU.

The header compiles with a host C++ compiler as well as with nvcc, so a
small harness around ``abt::adj::flux_point_vjp`` (the forward sweep with
its iteration checkpoints, then the reverse sweep) is built here with
``g++ -O1`` in fp64 (``kernels._build.build_host``), once per session,
into the git-ignored ``kernels/_build/``, and loaded with ctypes.  Its 13
gradients are held to

  * ``fused_flux_step_vjp_plain`` (autograd of the eager step) on CPU
    tensors, at rtol 1e-9 and atol 1e-9 * max|ref| of the field: the two
    reverse passes sum the same partials in another order;
  * ``jax.vjp`` of ``aerobulk_tpu``'s step on the same numpy inputs, at the
    same tolerance.

Without a host compiler the tests skip.  The kernel itself, compiled by
nvcc, is held to the plain version on the card by the ``cuda`` tests of
tests/test_torch_kernels.py and by chip_smoke.py.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import skin as tsk
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as tfused

HARNESS = r"""
#include <cstdint>
#include "adjoint.cuh"

template <typename Solve>
static void sweep(const double* const* in, const double* const* ct,
                  double* const* g, int64_t n, const abt::Params& p) {
  for (int64_t i = 0; i < n; ++i) {
    double x[13], c[10], r[13];
    for (int j = 0; j < 13; ++j) x[j] = in[j][i];
    for (int j = 0; j < 10; ++j) c[j] = ct[j][i];
    abt::adj::flux_point_vjp<Solve>(x, c, r, p);
    for (int j = 0; j < 13; ++j) g[j][i] = r[j];
  }
}

extern "C" int abt_adjoint_host_f64(
    const double* const* in, const double* const* ct, double* const* g,
    int64_t n, int ecmwf, int niter, int charn_law, int visc_at_tzu,
    int humidity, double z0t_max, double z0t_coef, double z0t_pow,
    double beta0, double zt, double zu, double rdt, double gdept,
    double isecday_utc) {
  if (niter < 0 || niter > abt::adj::kMaxIter) return 1;
  abt::Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                z0t_pow, beta0, zt, zu, rdt, gdept, isecday_utc};
  if (ecmwf) sweep<abt::EcmwfSkin>(in, ct, g, n, p);
  else sweep<abt::CoareSkin>(in, ct, g, n, p);
  return 0;
}
"""
SHAPE = (4, 24)
ALGOS = ("coare3p0", "coare3p6", "ecmwf")
CASES = ("built", "tie", "calm_v", "t_eq_sst", "night", "dawn")


@pytest.fixture(scope="module")
def host_vjp():
    """The harness's VJP: (cfg, 13 inputs, 10 cotangents, isecday_utc) ->
    13 gradients, all fp64 CPU tensors."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the adjoint")
    out = _build.build_host(cxx, HARNESS, "adjoint")
    fn = ctypes.CDLL(str(out)).abt_adjoint_host_f64
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, ctypes.c_int64] + [ctypes.c_int] * 5 + \
        [ctypes.c_double] * 9
    fn.restype = ctypes.c_int

    def vjp(cfg, ins, cts, isd):
        ins = [x.contiguous() for x in ins]
        cts = [c.contiguous() for c in cts]
        grads = [torch.empty_like(ins[0]) for _ in range(13)]

        def ptrs(ts):
            return (P * len(ts))(*(t.data_ptr() for t in ts))

        law, visc, *z0t = tfused._coare_args(cfg.algo)
        err = fn(ptrs(ins), ptrs(cts), ptrs(grads), ins[0].numel(),
                 int(cfg.algo == "ecmwf"), cfg.niter, law, visc,
                 tfused._HUMIDITY[cfg.humidity], *z0t, cfg.zt, cfg.zu,
                 cfg.rdt, cfg.gdept, float(isd))
        assert err == 0
        return grads
    return vjp


def _case(algo, case, humidity="sh", seed=2):
    """numpy inputs, state and cotangents of one step: a warm layer built
    on part of the grid, the fresh state's tie (COARE: Hz_wl == HWL_MAX;
    ECMWF: dT_wl == 0) or one of the exact zeros of the path."""
    rng = np.random.default_rng(seed)
    sst = 285.0 + 15.0 * rng.random(SHAPE)
    q = 0.004 + 0.012 * rng.random(SHAPE)
    x = [sst, sst + rng.normal(0.0, 2.0, SHAPE), q,
         rng.normal(0.0, 6.0, SHAPE), rng.normal(0.0, 6.0, SHAPE),
         98000.0 + 4000.0 * rng.random(SHAPE), 500.0 * rng.random(SHAPE),
         250.0 + 150.0 * rng.random(SHAPE), 360.0 * rng.random(SHAPE)]
    x[2] = {"sh": q, "rh": 40.0 + 60.0 * (q - 0.004) / 0.012,
            "dp": x[1] - 1.0 - 8.0 * (q - 0.004) / 0.012}[humidity]
    lon = x[8]
    zeros = np.zeros(SHAPE)
    if algo == "ecmwf":
        dT = 0.3 * (lon > 180) if case in ("built", "dawn") else zeros
        st = [dT, np.full(SHAPE, tsk.RD0_ECMWF), zeros, zeros]
    elif case in ("built", "dawn"):
        st = [0.3 * (lon > 180), tsk.HWL_MAX - 15.0 * (lon > 90),
              2e5 * (lon < 90), 50.0 * (lon < 270)]
    else:
        st = [zeros, np.full(SHAPE, tsk.HWL_MAX), zeros, zeros]
    if case == "calm_v":
        x[4] = zeros
    elif case == "t_eq_sst":
        x[1] = x[0].copy()
    elif case == "night":
        x[6] = zeros
    elif case == "dawn":
        # local solar time 4.5-6.5 h at 12 UTC: the warm layer is reset
        x[8] = -115.0 + 30.0 * rng.random(SHAPE)
    cts = [rng.standard_normal(SHAPE) for _ in range(10)]
    return x + st, cts


def _tensors(arrays):
    return [torch.as_tensor(a, dtype=torch.float64) for a in arrays]


def _assert_close(got, ref, rtol=1e-9):
    for name, g, r in zip(tfused._INPUTS, got, ref):
        g, r = np.asarray(g), np.asarray(r)
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, r, rtol=rtol,
                                   atol=rtol * np.max(np.abs(r)),
                                   err_msg=name)


@pytest.mark.parametrize("niter", [1, 2, 5])
@pytest.mark.parametrize("humidity", ["sh", "rh", "dp"])
@pytest.mark.parametrize("algo", ALGOS)
def test_adjoint_matches_plain_vjp(host_vjp, algo, humidity, niter):
    """Every config branch the kernel takes from its arguments (algorithm,
    humidity kind, niter and so the warm layer's commits), from a built
    state."""
    cfg = tapi.AeroBulkConfig(algo=algo, humidity=humidity, niter=niter,
                              use_skin=True)
    ins, cts = _case(algo, "built", humidity)
    ins, cts = _tensors(ins), _tensors(cts)
    got = host_vjp(cfg, ins, cts, 20000)
    ref = tfused.fused_flux_step_vjp_plain(cfg, ins[:9],
                                           tsk.SkinState(*ins[9:]), cts, 20000)
    _assert_close(got, ref)
    assert not got[8].any()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("algo", ALGOS)
def test_adjoint_at_ties_and_zeros(host_vjp, algo, case):
    """The ties of a fresh state and the exact zeros of the path, where
    the stages' duals follow the reverse-mode conventions (dual.cuh)."""
    cfg = tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=True)
    ins, cts = _case(algo, case)
    ins, cts = _tensors(ins), _tensors(cts)
    got = host_vjp(cfg, ins, cts, 43200)
    ref = tfused.fused_flux_step_vjp_plain(cfg, ins[:9],
                                           tsk.SkinState(*ins[9:]), cts, 43200)
    _assert_close(got, ref)
    if case == "dawn" and algo != "ecmwf":
        # the reset throws the old state away: no gradient reaches it
        assert not got[9].any() and not got[11].any()


@pytest.mark.parametrize("case", ["tie", "calm_v", "t_eq_sst"])
@pytest.mark.parametrize("algo", ALGOS)
def test_adjoint_matches_jax_vjp(host_vjp, algo, case):
    """The harness against jax.vjp of aerobulk_tpu's step (the body of the
    Pallas _grad_kernel) on the same numpy inputs."""
    import jax
    import jax.numpy as jnp
    from aerobulk_tpu import api as japi
    from aerobulk_tpu import skin as jsk
    from aerobulk_tpu.kernels.fused import _jit_equiv

    ins, cts = _case(algo, case, seed=5)
    jcfg = japi.AeroBulkConfig(algo=algo, niter=5, use_skin=True)

    def f(*a):
        return _jit_equiv(jcfg, (*a[:9], 43200, jsk.SkinState(*a[9:])))
    _, vjp = jax.vjp(f, *map(jnp.asarray, ins))
    ref = vjp((tuple(map(jnp.asarray, cts[:6])),
               jsk.SkinState(*map(jnp.asarray, cts[6:]))))
    got = host_vjp(tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=True),
                   _tensors(ins), _tensors(cts), 43200)
    _assert_close(got, ref)


def test_adjoint_refuses_more_iterations_than_it_checkpoints(host_vjp):
    cfg = tapi.AeroBulkConfig(niter=tfused.GRAD_MAX_NITER + 1, use_skin=True)
    ins, cts = _case("coare3p6", "tie")
    with pytest.raises(AssertionError):
        host_vjp(cfg, _tensors(ins), _tensors(cts), 43200)
