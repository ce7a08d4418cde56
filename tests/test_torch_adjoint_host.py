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


#: the stages with a written-out adjoint (adjoint.cuh's ABT_ADJ): functor,
#: inputs, outputs, and each input's range for the random points
STAGES = (
    ("HumStage", 3, 1, ("hum", (260.0, 305.0), (90000.0, 105000.0))),
    ("WindStage", 2, 1, ((-15.0, 15.0), (-15.0, 15.0))),
    ("ThetaStage", 3, 1, ((90000.0, 105000.0), (250.0, 310.0),
                          (0.001, 0.02))),
    ("Surface0Stage", 2, 2, ((271.0, 305.0), (90000.0, 105000.0))),
    ("SurfaceStage", 4, 2, ((271.0, 305.0), (-1.0, 0.5), (-0.5, 2.0),
                            (90000.0, 105000.0))),
    ("DeltaStage", 4, 2, ((270.0, 305.0), (270.0, 305.0), (0.001, 0.02),
                          (0.001, 0.02))),
    ("QnsCoefStage", 8, 3, ((271.0, 305.0), (0.003, 0.03), (270.0, 305.0),
                            (0.001, 0.02), (0.05, 1.0), (-0.5, 0.5),
                            (-1e-3, 1e-3), (0.5, 20.0))),
    ("RhoStage", 3, 1, ((250.0, 310.0), (0.001, 0.02), (50000.0, 105000.0))),
    ("FluxStage", 12, 5, ((5e-4, 3e-3), (5e-4, 2e-3), (5e-4, 2e-3),
                          (270.0, 305.0), (0.001, 0.02), (0.5, 20.0),
                          (271.0, 305.0), (0.003, 0.03), (0.0, 20.0),
                          (-15.0, 15.0), (-15.0, 15.0), (95000.0, 105000.0))),
    ("FirstGuessStage<false>", 5, 7, ((271.0, 305.0), (265.0, 310.0),
                                      (0.003, 0.03), (0.001, 0.02),
                                      (0.0, 25.0))),
    ("FirstGuessStage<true>", 5, 7, ((271.0, 305.0), (265.0, 310.0),
                                     (0.003, 0.03), (0.001, 0.02),
                                     (0.0, 25.0))),
    ("CoarePreStage", 2, 2, ((1e-6, 1e-2), (250.0, 310.0))),
    ("CoareOolStage", 5, 1, ((270.0, 305.0), (0.001, 0.02), (0.01, 1.0),
                             (-0.5, 0.5), (-1e-3, 1e-3))),
    ("CoareUbStage", 3, 1, ((0.01, 1.0), (-0.5, 0.5), (0.0, 20.0))),
    ("CoareZ0Stage", 3, 2, ((0.01, 2.0), (-14.0, -4.0), (1.3e-5, 1.6e-5))),
    ("CoareScalesStage", 4, 2, ((-14.0, -8.0), (-3.0, 5.0), (-5.0, 5.0),
                                (-0.01, 0.01))),
    ("CoareUsStage", 3, 1, ((0.2, 20.0), (-14.0, -5.0), (-3.0, 5.0))),
    ("CoareHeightStage", 6, 2, ((-0.5, 0.5), (-1e-3, 1e-3), (-3.0, 5.0),
                                (-3.0, 5.0), (270.0, 305.0), (0.001, 0.02))),
    ("CoareCsStage", 5, 1, ((0.0, 1000.0), (-600.0, 100.0), (0.001, 1.0),
                            (1e-4, 3e-4), (-400.0, 50.0))),
    ("CoareWlStage", 8, 4, ((0.0, 900.0), (-400.0, 100.0), (0.0, 0.5),
                            (1e-4, 3e-4), (0.0, 1.0), (0.1, 20.0),
                            (-1e5, 5e6), (0.0, 1000.0))),
    ("CoareCoefStage", 8, 3, ((0.01, 1.0), (0.5, 20.0), (-0.5, 0.5),
                              (-1e-3, 1e-3), (270.0, 305.0), (271.0, 305.0),
                              (0.001, 0.02), (0.003, 0.03))),
    ("EcmwfPreStage", 6, 4, ((270.0, 305.0), (0.001, 0.02), (0.01, 1.0),
                             (-0.5, 0.5), (-1e-3, 1e-3), (1e-5, 1e-3))),
    ("EcmwfOolStage", 7, 1, ((271.0, 305.0), (270.0, 305.0), (0.003, 0.03),
                             (0.001, 0.02), (0.2, 20.0), (5.0, 15.0),
                             (5.0, 20.0))),
    ("EcmwfFmStage", 4, 1, ((-14.0, -4.0), (-3.0, 5.0), (1e-6, 1e-2),
                            (-200.0, 200.0))),
    ("EcmwfRoughStage", 3, 7, ((0.2, 20.0), (5.0, 20.0), (1.3e-5, 1.6e-5))),
    ("EcmwfPsiMzStage", 2, 1, ((1e-6, 1e-3), (-200.0, 200.0))),
    ("EcmwfPsiHzStage", 2, 1, ((1e-6, 1e-3), (-200.0, 200.0))),
    ("EcmwfUbStage", 3, 1, ((0.01, 1.0), (-0.5, 0.5), (0.0, 20.0))),
    ("EcmwfScalarStage<false>", 6, 2, ((-5.0, 5.0), (-14.0, -8.0),
                                       (-3.0, 5.0), (-1.0, 1.0), (-3.0, 5.0),
                                       (270.0, 305.0))),
    ("EcmwfScalarStage<true>", 6, 2, ((-0.01, 0.01), (-14.0, -8.0),
                                      (-3.0, 5.0), (-1.0, 1.0), (-3.0, 5.0),
                                      (0.001, 0.02))),
    ("EcmwfFStage", 6, 2, ((-14.0, -4.0), (-3.0, 5.0), (-1.0, 1.0),
                           (-14.0, -8.0), (-3.0, 5.0), (-1.0, 1.0))),
    ("EcmwfCsStage", 4, 1, ((0.0, 1000.0), (-600.0, 100.0), (0.001, 1.0),
                            (1e-4, 3e-4))),
    ("EcmwfWlPreStage", 6, 7, ((0.0, 900.0), (-400.0, 100.0), (0.001, 0.5),
                               (1e-4, 3e-4), (-0.5, 2.0), (0.5, 20.0))),
    ("EcmwfCoefStage", 5, 3, ((5.0, 20.0), (5.0, 20.0), (-14.0, -8.0),
                              (-3.0, 5.0), (-1.0, 1.0))),
)
#: each stage's points that are not differentiable, each an override of
#: one random point: maxp/minp ties, |x| at 0, the clip_mag and
#: nonzero_delta floors and caps, the guarded branches
EDGES = {
    "HumStage": ({2: 50000.0}, {2: 40000.0}, {1: 180.0}, {0: 180.0}),
    "WindStage": ({1: 0.0}, {0: 0.0}),
    "ThetaStage": ({1: 180.0},),
    "Surface0Stage": ({0: 200.25}, {0: 150.25}),
    "SurfaceStage": ({0: 199.5, 1: 0.25, 2: 0.25}, {0: 150.0, 1: 0.0}),
    "DeltaStage": ({0: 290.0, 1: 290.0, 2: 0.01, 3: 0.01},
                   {0: 1e-9, 1: 0.0, 2: 1e-12, 3: 0.0},
                   {0: 0.0, 1: 1e-9, 2: 0.0, 3: 1e-12}),
    "QnsCoefStage": ({0: 290.0, 2: 290.0}, {1: 0.01, 3: 0.01}),
    "RhoStage": ({2: 60000.0}, {2: 40000.0}),
    "FluxStage": ({8: 1e-3}, {8: 0.0}, {8: 5e-4}, {3: 290.0, 6: 290.0}),
    "FirstGuessStage<false>": ({0: 290.0, 1: 290.0}, {3: 1e-6}, {3: 1e-7},
                               {4: 0.0}, {4: 10.0}, {4: 18.0},
                               {0: 290.0, 1: 290.0, 2: 0.01, 3: 0.01}),
    "FirstGuessStage<true>": ({0: 290.0, 1: 290.0}, {3: 1e-6}, {4: 0.0}),
    "CoarePreStage": ({0: 1.0},),
    "CoareOolStage": ({2: 0.0}, {2: 1e-4}, {3: 0.0, 4: 0.0}),
    "CoareUbStage": ({1: 0.0}, {1: 0.3}, {1: 0.3, 2: 0.0}, {0: 0.0, 2: 0.1}),
    "CoareZ0Stage": ({0: 30.0}, {0: 1e-3}),
    "CoareScalesStage": ({2: 0.0, 3: 0.0},),
    "CoareUsStage": ({0: 0.0},),
    "CoareHeightStage": ({0: 0.0, 1: 0.0},),
    "CoareCsStage": ({4: 0.0}, {4: 20.0}, {2: 1e-4}, {2: 1e-5}, {0: 0.0},
                     {1: 300.0, 4: 20.0}),
    "CoareWlStage": ({5: 20.0}, {5: 0.1}, {5: 25.0}, {2: 0.002},
                     {4: 0.0, 0: 0.0, 1: -100.0}, {6: -1e7, 0: 0.0},
                     {0: 0.0, 1: -400.0, 6: 100.0}),
    "CoareCoefStage": ({0: 1e-3}, {4: 290.0, 5: 290.0},
                       {6: 0.01, 7: 0.01}),
    # 1/L clipped at 200 (zeta past psi's caps), its floored denominator,
    # 1/L = 0; z0t's clamp at 1e-9 and at 1
    "EcmwfPreStage": ({2: 1e-3}, {2: 0.0}, {3: 0.0, 4: 0.0}, {5: 5.0},
                      {5: 20.0}),
    # Ri_bulk at 0 (no virtual temperature difference) and clipped
    "EcmwfOolStage": ({0: 290.0, 1: 290.0, 2: 0.01, 3: 0.01}, {4: 0.01},
                      {0: 305.0, 1: 270.0, 4: 0.01}),
    # psi at zeta = 0, at its caps (zeta = 5, -50: ties) and past them
    "EcmwfFmStage": ({3: 0.0}, {2: 0.03125, 3: 160.0}, {2: 0.5, 3: -100.0},
                     {2: 0.5, 3: 200.0}),
    # the 0.001 caps of z0 (strong wind), of z0t and z0q (calm), |.| < 0
    "EcmwfRoughStage": ({0: 20.0, 1: 5.0}, {0: 0.01, 1: 20.0}, {1: -10.0}),
    "EcmwfPsiMzStage": ({1: 0.0}, {0: 0.03125, 1: 160.0},
                        {0: 0.5, 1: -100.0}, {0: 0.5, 1: 200.0}),
    "EcmwfPsiHzStage": ({1: 0.0}, {0: 0.03125, 1: 160.0},
                        {0: 0.5, 1: -100.0}, {0: 0.5, 1: 200.0}),
    "EcmwfUbStage": ({1: 0.0}, {1: -0.3}, {1: -0.3, 2: 0.0},
                     {0: 0.0, 2: 0.1}, {0: 0.0, 2: 0.0}),
    "EcmwfScalarStage<false>": ({0: 0.0},),
    # the humidity floor: at the tie (q_zu = 0 exactly) and below it
    "EcmwfScalarStage<true>": ({0: 0.0, 5: 0.0}, {0: 0.01, 5: 0.0},
                               {0: 0.0}),
    "EcmwfFStage": ({0: 0.0, 3: 0.0},),
    "EcmwfCsStage": ({2: 1e-4}, {2: 1e-5}, {0: 0.0}, {0: 0.0, 1: 0.0},
                     {1: 300.0}),
    # MAX(dT_wl / tcorr, 0) at the fresh state's tie and below it; Hz_wl at
    # gdept (step's switch); usw's floor; Qabs = 0
    "EcmwfWlPreStage": ({4: 0.0}, {4: -0.5}, {5: 1.0}, {2: 1e-4}, {2: 1e-5},
                        {0: 0.0, 1: 0.0}),
    # Cd and Ch on the Cx_min floor
    "EcmwfCoefStage": ({0: 1000.0}, {1: 1e6}),
}
#: (algorithm, humidity, zt, local solar hour): both charnock laws and z0t
#: closures, every humidity kind, zt != zu and zt == zu, day and dawn
STAGE_CTX = (("coare3p6", "sh", 2.0, 12.0), ("coare3p0", "rh", 10.0, 5.0),
             ("coare3p6", "dp", 10.0, 14.0))
HUM_RANGE = {"sh": (0.001, 0.02), "rh": (20.0, 100.0), "dp": (260.0, 300.0)}


@pytest.fixture(scope="module")
def stage_pair():
    """One stage's written-out adjoint and its dual-number VJP (the
    oracle): (stage, ctx, x (n, N), yb (n, M)) -> two (n, N) arrays."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the adjoint")
    cases = "\n".join(f"    case {i}: return pair<{name}>(k, x, yb, ga, gd, n);"
                      for i, (name, *_) in enumerate(STAGES))
    harness = STAGE_HARNESS.replace("CASES", cases)
    fn = ctypes.CDLL(str(_build.build_host(cxx, harness, "adjoint_stages")))
    fn = fn.abt_stage_adj_f64
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, P, ctypes.c_int64] + \
        [ctypes.c_int] * 3 + [ctypes.c_double] * 9
    fn.restype = ctypes.c_int
    names = [name for name, *_ in STAGES]

    def pair(name, ctx, x, yb):
        algo, humidity, zt, rhr = ctx
        cfg = tapi.AeroBulkConfig(algo=algo, humidity=humidity, zt=zt,
                                  use_skin=True)
        x, yb = np.ascontiguousarray(x), np.ascontiguousarray(yb)
        ga, gd = np.empty_like(x), np.empty_like(x)
        law, visc, *z0t = tfused._coare_args(algo)
        err = fn(names.index(name), *(a.ctypes.data for a in (x, yb, ga, gd)),
                 len(x), law, visc, tfused._HUMIDITY[humidity], *z0t, cfg.zt,
                 cfg.zu, cfg.rdt, cfg.gdept, rhr)
        assert err == 0, f"{name}: {err} outputs of its kept forward differ"
        return ga, gd
    return pair


STAGE_HARNESS = r"""
#include <cstdint>
#include "adjoint.cuh"

using namespace abt::adj;

// a stage whose forward keeps what its walk back reads (fwd, bwd, Tape)
template <typename F, typename = void> struct Kept : std::false_type {};
template <typename F>
struct Kept<F, std::void_t<typename F::template Tape<double>>> : std::true_type {};

// the adjoint and the duals' VJP of each point; returns how many outputs
// of a kept forward differ from the stage's primal
template <typename F>
static int pair(const Ctx& k, const double* x, const double* yb,
                double* ga, double* gd, int64_t n) {
  static_assert(HasAdj<F>::value, "the stage has no written-out adjoint");
  constexpr int N = F::kN, M = F::kM;
  int differ = 0;
  for (int64_t i = 0; i < n; ++i) {
    double xi[N], yi[M], a[N], d[N];
    double* pa[N];
    double* pd[N];
    for (int j = 0; j < N; ++j) {
      xi[j] = x[i * N + j];
      a[j] = d[j] = 0.0;
      pa[j] = &a[j];
      pd[j] = &d[j];
    }
    for (int m = 0; m < M; ++m) yi[m] = yb[i * M + m];
    F{k}.adj(xi, yi, pa);
    dual_vjp(F{k}, xi, yi, pd);
    for (int j = 0; j < N; ++j) {
      ga[i * N + j] = a[j];
      gd[i * N + j] = d[j];
    }
    if constexpr (Kept<F>::value) {
      typename F::template Tape<double> t;
      const Vec<double, M> kept = F{k}.fwd(xi, t);
      const Vec<double, M> primal = run<M>(F{k}, xi);
      for (int m = 0; m < M; ++m) differ += !(kept[m] == primal[m]);
    }
  }
  return differ;
}

extern "C" int abt_stage_adj_f64(
    int stage, const double* x, const double* yb, double* ga, double* gd,
    int64_t n, int charn_law, int visc_at_tzu, int humidity, double z0t_max,
    double z0t_coef, double z0t_pow, double beta0, double zt, double zu,
    double rdt, double gdept, double rhr_sol) {
  const abt::Params p{5, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                      z0t_pow, beta0, zt, zu, rdt, gdept, 0.0};
  const Ctx k = ctx_of(p, rhr_sol);
  switch (stage) {
CASES
  }
  return -1;
}
"""


def _stage_points(name, ranges, ctx, edges, rng):
    """The random points of one stage under ``ctx``, or (``edges``) its
    points that are not differentiable, each on a random point of its
    own; and each input's scale, the larger end of its range."""
    ranges = [HUM_RANGE[ctx[1]] if r == "hum" else r for r in ranges]
    n = 64 if not edges else len(EDGES[name])
    x = np.stack([rng.uniform(lo, hi, n) for lo, hi in ranges], axis=1)
    if edges:
        for row, over in zip(x, EDGES[name]):
            for j, v in over.items():
                row[j] = v
    return x, np.array([max(abs(lo), abs(hi)) for lo, hi in ranges])


@pytest.mark.parametrize("edges", [False, True], ids=["random", "edges"])
@pytest.mark.parametrize("stage", [name for name, *_ in STAGES])
def test_stage_adjoint_matches_its_duals(stage_pair, stage, edges):
    """Each written-out adjoint against the Dual<S, N> Jacobian of the same
    functor (dual.cuh's rules) contracted with random cotangents, at rtol
    1e-12, on random points and on the stage's ties, floors, caps and
    guarded branches, under both COARE versions, every humidity kind,
    zt != zu and zt == zu, day and dawn; a stage whose forward keeps what
    its walk back reads (fwd, which both sweeps run) gives its primal's
    values bit for bit.  The absolute
    tolerance is 1e-12
    of the stage's largest first-order effect, in the outputs' units (an
    adjoint times its input's scale): where a derivative cancels to 0, as
    FluxStage's in the wind speed, both routes leave rounding there."""
    _, n_in, n_out, ranges = next(s for s in STAGES if s[0] == stage)
    rng = np.random.default_rng(11)
    for ctx in STAGE_CTX:
        x, scale = _stage_points(stage, ranges, ctx, edges, rng)
        yb = rng.standard_normal((len(x), n_out))
        got, ref = stage_pair(stage, ctx, x, yb)
        assert (np.isfinite(got) == np.isfinite(ref)).all(), (ctx, x)
        effect = np.max(np.abs(np.nan_to_num(ref)) * scale)
        for j in range(n_in):
            np.testing.assert_allclose(
                got[:, j], ref[:, j], rtol=1e-12,
                atol=1e-12 * effect / scale[j],
                err_msg=f"{stage} input {j} under {ctx}")


def test_adjoint_refuses_more_iterations_than_it_checkpoints(host_vjp):
    cfg = tapi.AeroBulkConfig(niter=tfused.GRAD_MAX_NITER + 1, use_skin=True)
    ins, cts = _case("coare3p6", "tie")
    with pytest.raises(AssertionError):
        host_vjp(cfg, _tensors(ins), _tensors(cts), 43200)
