"""The per-point bodies of the ice and mixed kernels 4 and 5 built for the CPU.

``abt::ice_point<double, kIce>`` for the seven sea-ice algorithms (the body
of kernels/csrc/ice_step.cu) and ``abt::mixed_point<double, kOcean, kIce>``
(the body of mixed_step.cuh: LG15 ice with each of the five ocean
algorithms, every other ice algorithm with ECMWF leads, and the
simultaneous LG15_IO solve) compile with a host C++ compiler as well as
with nvcc.  A small
harness with the kernels' own C arguments is built here with ``g++ -O1``
in fp64 (``kernels._build.build_host``), called with the arguments the
wrappers build (``fused._ice_args``, ``fused._mixed_args``) and held, on
the same numpy inputs, to

  * the eager port on CPU tensors (``fused_ice_step_plain``,
    ``fused_mixed_step_plain``);
  * ``aerobulk_tpu.api.flux_step_ice`` / ``flux_step_mixed`` under
    ``jax.jit``.

Tolerance, per field, as tests/test_torch_forward_host.py's: the median
relative difference at most 1e-12, no point whose error exceeds 10% of the
field's median magnitude, and the largest pointwise relative difference
at most 1e-10.  The bodies take every power as exp2(c log2 x) and theta's
last power as one exp, where both references call pow: a few ulp.  The
inputs are tests/test_torch_ice.py's forcing (frice 0 and 1 included), its
calm unstable points where the reference blows up (|QH| of 1e4-1e7 W/m^2:
LG15_IO's water side, BEST's ice side), where both references agree with
each other and with the body, and its two fp32 conditioning points; every
humidity kind, zt != zu and zt == zu.  Without a host compiler the tests
skip.  The kernels, compiled by nvcc with their fp32 approximations, are
held to the plain versions on the card by chip_smoke.py.
"""

import ctypes
import functools
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as tfused
from test_torch_ice import _CALM, _COND_ICE_BEST, _COND_NCAR_LEADS, _forcing

HARNESS = r"""
#include <cstdint>
#include "mixed_point.cuh"

template <int kIce>
static void ice(void* const* ptrs, int64_t n, const abt::Params& p,
                const abt::IceKw& kw) {
  for (int64_t i = 0; i < n; ++i) {
    double x[7], y[6];
    for (int j = 0; j < 6; ++j) x[j] = static_cast<const double*>(ptrs[j])[i];
    x[6] = abt::ice_needs_frice(kIce) ? static_cast<const double*>(ptrs[6])[i] : 0.0;
    abt::ice_point<double, kIce>(x, y, p, kw);
    for (int j = 0; j < 6; ++j) static_cast<double*>(ptrs[7 + j])[i] = y[j];
  }
}

template <int kOcean, int kIce>
static void mixed(void* const* ptrs, int64_t n, const abt::Params& p,
                  const abt::IceKw& kw) {
  for (int64_t i = 0; i < n; ++i) {
    double x[8], y[5];
    for (int j = 0; j < 8; ++j) x[j] = static_cast<const double*>(ptrs[j])[i];
    abt::mixed_point<double, kOcean, kIce>(x, y, p, kw);
    for (int j = 0; j < 5; ++j) static_cast<double*>(ptrs[8 + j])[i] = y[j];
  }
}

// the arguments of abt_ice_step_f64 and abt_mixed_step_<ocean>_f64 without the
// stream
extern "C" int abt_ice_host_f64(void* const* ptrs, int64_t n, int algo, int niter,
                                int humidity, double zt, double zu, double CdN,
                                double ChN, double CeN, double sqrt_CdN,
                                double log_ztzu, double log_zu10) {
  const abt::Params p{niter, 0, 0, humidity, 0.0, 0.0, 0.0, 0.0, zt, zu, 0.0, 0.0, 0.0};
  const abt::IceKw kw{CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10};
  return abt::with_ice_algo(algo, [&](auto k) { ice<decltype(k)::value>(ptrs, n, p, kw); })
             ? 0 : 1;
}

template <int kOcean>
static bool mixed_of(int ice_algo, void* const* ptrs, int64_t n, const abt::Params& p,
                     const abt::IceKw& kw) {
  return abt::with_ice_algo(ice_algo, [&](auto k) {
    mixed<kOcean, decltype(k)::value>(ptrs, n, p, kw);
  });
}

extern "C" int abt_mixed_host_f64(void* const* ptrs, int64_t n, int ice_algo,
                                  int ocean_algo, int simultaneous, int niter,
                                  int charn_law, int visc_at_tzu, int humidity,
                                  double z0t_max, double z0t_coef, double z0t_pow,
                                  double beta0, double zt, double zu, double CdN,
                                  double ChN, double CeN, double sqrt_CdN,
                                  double log_ztzu, double log_zu10) {
  const abt::Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                      z0t_pow, beta0, zt, zu, 0.0, 0.0, 0.0};
  const abt::IceKw kw{CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10};
  bool known;
  switch (simultaneous ? abt::kSimultaneous : ocean_algo) {
    case abt::kSimultaneous: known = mixed_of<abt::kSimultaneous>(ice_algo, ptrs, n, p, kw); break;
    case abt::kCoare3p0: known = mixed_of<abt::kCoare3p0>(ice_algo, ptrs, n, p, kw); break;
    case abt::kCoare3p6: known = mixed_of<abt::kCoare3p6>(ice_algo, ptrs, n, p, kw); break;
    case abt::kEcmwf: known = mixed_of<abt::kEcmwf>(ice_algo, ptrs, n, p, kw); break;
    case abt::kNcar: known = mixed_of<abt::kNcar>(ice_algo, ptrs, n, p, kw); break;
    case abt::kAndreas: known = mixed_of<abt::kAndreas>(ice_algo, ptrs, n, p, kw); break;
    default: known = false;
  }
  return known ? 0 : 1;
}
"""
ICE = list(tfused._ICE_ALGOS)
OCEAN = list(tfused._BULK_ALGOS)
#: (ice_algo, ocean_algo, simultaneous): the mixed cells of chip_smoke.py's
#: phase 12
MIXED = ([("ice_lg15", o, False) for o in OCEAN]
         + [(a, "ecmwf", False) for a in ICE if a != "ice_lg15"]
         + [("ice_lg15", "ecmwf", True)])
_MIXED_IDS = ["lg15_io" if s else f"{i}+{o}" for i, o, s in MIXED]
EASY_KW = {"CdN": 1.6e-3, "ChN": 1.5e-3, "CeN": 1.5e-3}
NITER = 5
#: the inputs in the mixed kernel's order (the ice kernel's drops sst)
NAMES = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
ZT = [2.0, 10.0]       # zt != zu and zt == zu (zu = 10)


@pytest.fixture(scope="module")
def host():
    """The harness: {"ice": fn, "mixed": fn} with the kernels' arguments."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the bodies")
    lib = ctypes.CDLL(str(_build.build_host(cxx, HARNESS, "ice")))
    fns = {}
    for kind, argtypes in (("ice", _build._ICE_ARGTYPES),
                           ("mixed", _build._MIXED_ARGTYPES)):
        fn = getattr(lib, f"abt_{kind}_host_f64")
        fn.argtypes = argtypes[:-1]
        fn.restype = ctypes.c_int
        fns[kind] = fn
    return fns


def _inputs(humidity, seed):
    """The forcing of tests/test_torch_ice.py as 8 fp64 arrays in NAMES'
    order; with specific humidity also its calm unstable and conditioning
    points."""
    f = _forcing(humidity, seed=seed)
    cols = [f[n].ravel() for n in NAMES]
    if humidity == "sh":
        extra = np.column_stack([_CALM, _COND_ICE_BEST, _COND_NCAR_LEADS])
        cols = [np.concatenate([c, e]) for c, e in zip(cols, extra)]
    return cols


def _run(fn, ins, n_out, args):
    ins = [None if x is None else np.ascontiguousarray(x, dtype=np.float64)
           for x in ins]
    n = next(x for x in ins if x is not None).size
    outs = [np.empty(n) for _ in range(n_out)]
    ptrs = (ctypes.c_void_p * (len(ins) + n_out))(
        *(None if x is None else x.ctypes.data for x in (*ins, *outs)))
    assert fn(ptrs, n, *args) == 0
    return outs


def _ice_host(host, algo, zt, humidity, ins):
    kw = EASY_KW if algo == "ice_easy" else {}
    frice = ins[7]
    args = tfused._ice_args(algo, zt, 10.0, frice, NITER, humidity, kw)
    return _run(host["ice"], [ins[0], *ins[2:7], frice], 6, args)


def _mixed_host(host, case, zt, humidity, ins):
    ice, ocean, simul = case
    args = tfused._mixed_args(zt, 10.0, ice, ocean, NITER, humidity, simul)
    return _run(host["mixed"], ins, 5, args)


def _ice_eager(algo, zt, humidity, ins):
    t = [torch.as_tensor(x) for x in ins]
    kw = EASY_KW if algo == "ice_easy" else {}
    return tfused.fused_ice_step_plain(algo, zt, 10.0, t[0], *t[2:7],
                                       frice=t[7], niter=NITER,
                                       humidity=humidity, **kw)


def _mixed_eager(case, zt, humidity, ins):
    ice, ocean, simul = case
    return tfused.fused_mixed_step_plain(
        zt, 10.0, *map(torch.as_tensor, ins), ice_algo=ice, ocean_algo=ocean,
        niter=NITER, humidity=humidity, simultaneous=simul)


@functools.cache
def _jax_ice(algo, zt, humidity):
    kw = EASY_KW if algo == "ice_easy" else {}

    def f(Ts_i, t, hum, u, v, slp, frice):
        out, _ = japi.flux_step_ice(algo, zt, 10.0, Ts_i, t, hum, u, v, slp,
                                    frice=frice, niter=NITER,
                                    humidity=humidity, **kw)
        return out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s
    return jax.jit(f)


@functools.cache
def _jax_mixed(case, zt, humidity):
    ice, ocean, simul = case

    def f(*x):
        net, _, _ = japi.flux_step_mixed(zt, 10.0, *x, ice_algo=ice,
                                         ocean_algo=ocean, niter=NITER,
                                         humidity=humidity,
                                         simultaneous=simul)
        return net.QL, net.QH, net.Tau, net.Evap, net.T_s
    return jax.jit(f)


def _assert_parity(names, got, ref):
    """Median relative difference <= 1e-12, no significant point and no
    pointwise relative difference above 1e-10, field by field."""
    for name, g, r in zip(names, got, ref):
        g = np.asarray(g, dtype=np.float64).ravel()
        r = np.asarray(r, dtype=np.float64).ravel()
        assert np.isfinite(g).all() and np.isfinite(r).all(), name
        d = np.abs(g - r)
        nonzero = np.abs(r[r != 0])
        med = float(np.median(nonzero)) if nonzero.size else 0.0
        if med == 0.0:       # zero everywhere (no sublimation)
            assert d.max() == 0.0, name
            continue
        rel = d / np.maximum(np.abs(r), 1e-3 * med)
        assert np.median(rel) <= 1e-12, (name, np.median(rel))
        assert not np.any(d > 0.1 * med), (name, d.max(), med)
        assert rel.max() <= 1e-10, (name, rel.max())


@pytest.mark.parametrize("zt", ZT)
@pytest.mark.parametrize("algo", ICE)
def test_ice_body_matches_eager_port(host, algo, zt):
    ins = _inputs("sh", seed=60 + ICE.index(algo))
    _assert_parity(tfused.ICE_OUTPUTS, _ice_host(host, algo, zt, "sh", ins),
                   _ice_eager(algo, zt, "sh", ins))


@pytest.mark.parametrize("zt", ZT)
@pytest.mark.parametrize("algo", ICE)
def test_ice_body_matches_jax(host, algo, zt):
    ins = _inputs("sh", seed=60 + ICE.index(algo))
    ref = _jax_ice(algo, zt, "sh")(*map(jnp.asarray, (ins[0], *ins[2:])))
    _assert_parity(tfused.ICE_OUTPUTS, _ice_host(host, algo, zt, "sh", ins),
                   ref)


@pytest.mark.parametrize("humidity", ["rh", "dp"])
@pytest.mark.parametrize("algo", ICE)
def test_ice_body_humidity_kinds(host, algo, humidity):
    """Relative humidity and dew point reach q_zt through the body's
    q_air_of, against both references."""
    ins = _inputs(humidity, seed=70 + ICE.index(algo))
    got = _ice_host(host, algo, 2.0, humidity, ins)
    _assert_parity(tfused.ICE_OUTPUTS, got, _ice_eager(algo, 2.0, humidity,
                                                       ins))
    _assert_parity(tfused.ICE_OUTPUTS, got, _jax_ice(algo, 2.0, humidity)(
        *map(jnp.asarray, (ins[0], *ins[2:]))))


@pytest.mark.parametrize("zt", ZT)
@pytest.mark.parametrize("case", MIXED, ids=_MIXED_IDS)
def test_mixed_body_matches_eager_port(host, case, zt):
    ins = _inputs("sh", seed=80 + MIXED.index(case))
    _assert_parity(tfused.MIXED_OUTPUTS, _mixed_host(host, case, zt, "sh", ins),
                   _mixed_eager(case, zt, "sh", ins))


@pytest.mark.parametrize("zt", ZT)
@pytest.mark.parametrize("case", MIXED, ids=_MIXED_IDS)
def test_mixed_body_matches_jax(host, case, zt):
    ins = _inputs("sh", seed=80 + MIXED.index(case))
    _assert_parity(tfused.MIXED_OUTPUTS, _mixed_host(host, case, zt, "sh", ins),
                   _jax_mixed(case, zt, "sh")(*map(jnp.asarray, ins)))


@pytest.mark.parametrize("humidity", ["rh", "dp"])
@pytest.mark.parametrize("case", [MIXED[2], MIXED[-1]],
                         ids=[_MIXED_IDS[2], _MIXED_IDS[-1]])
def test_mixed_body_humidity_kinds(host, case, humidity):
    """BASELINE config 5's cell (LG15 + ECMWF) and LG15_IO with relative
    humidity and dew point, against both references."""
    ins = _inputs(humidity, seed=90)
    got = _mixed_host(host, case, 2.0, humidity, ins)
    _assert_parity(tfused.MIXED_OUTPUTS, got,
                   _mixed_eager(case, 2.0, humidity, ins))
    _assert_parity(tfused.MIXED_OUTPUTS, got, _jax_mixed(case, 2.0, humidity)(
        *map(jnp.asarray, ins)))


def test_calm_points_blow_up_in_the_body_too(host):
    """The calm unstable points of the config-5 forcing blow up in the body
    as in both references (|QH| > 1e4 W/m^2 on the LG15_IO water side and
    BEST's ice side), and the body follows them there."""
    ins = [c for c in _CALM]
    for case, side, pts in ((("ice_lg15", "ecmwf", True), "water", [0, 1]),
                            (("ice_best", "ecmwf", False), "ice", [2, 3])):
        got = _mixed_host(host, case, 2.0, "sh", ins)
        _assert_parity(tfused.MIXED_OUTPUTS, got,
                       _mixed_eager(case, 2.0, "sh", ins))
        net, out_i, out_w = japi.flux_step_mixed(
            2.0, 10.0, *map(jnp.asarray, ins), ice_algo=case[0],
            ocean_algo=case[1], niter=NITER, simultaneous=case[2])
        qh = np.abs(np.asarray((out_w if side == "water" else out_i).QH))
        assert (qh[pts] > 1e4).all(), qh
        np.testing.assert_allclose(got[1], np.asarray(net.QH), rtol=1e-10)
