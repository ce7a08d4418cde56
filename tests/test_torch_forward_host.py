"""The per-point bodies of the forward kernels 1 and 3 built for the CPU.

``abt::flux_point<CoareSkin>`` and ``flux_point<EcmwfSkin>`` (the bodies of
kernels/csrc/fused_step.cu and fused_step_ecmwf.cu) and
``abt::bulk_point<double, kAlgo>`` for the five ocean algorithms (the body
of bulk_step.cu) compile with a host C++ compiler as well as with nvcc.  A
small harness around them is built here with ``g++ -O1`` in fp64
(``kernels._build.build_host``) and held, on the same numpy inputs, to

  * the eager port on CPU tensors (``fused_flux_step_plain``,
    ``fused_bulk_step_plain``);
  * ``aerobulk_tpu.api.flux_step`` under ``jax.jit`` (the XLA path).

Tolerance, per field: the median relative difference at most 1e-12 and no
point whose error exceeds 10% of the field's median magnitude (the
"significant" points of chip_smoke.py's parity, with the warm-layer state
scaled by its nonzero points), and the largest pointwise relative
difference at most 1e-10.  The bodies compute powers as exp2(c log2 x) and
theta's last power as one exp, where both references call pow: a few ulp,
so the medians stay below 2e-15.  The largest pointwise difference, 7.8e-12
against either reference, is in QH where it is near zero (0.1-0.3 W/m^2
against a median of 0.17-16): QH is proportional to theta - T_s, and that
difference cancels the digits theta's rounding leaves.  The inputs and the
edge cases (a tie of the fresh state, calm wind, t = sst, night, dawn) are
those of tests/test_torch_adjoint_host.py.  Without a host compiler the
tests skip.  The kernels themselves, compiled by nvcc with their fp32
approximations, are held to the plain version on the card by
chip_smoke.py.
"""

import ctypes
import functools
import shutil

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import skin as tsk
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as tfused
from test_torch_adjoint_host import CASES, _case, _tensors

HARNESS = r"""
#include <cstdint>
#include "algos_point.cuh"

template <typename Solve>
static void step(const double* const* in, double* const* out, int64_t n,
                 const abt::Params& p) {
  for (int64_t i = 0; i < n; ++i) {
    double x[13], y[10];
    for (int j = 0; j < 13; ++j) x[j] = in[j][i];
    abt::flux_point<Solve>(x, y, p);
    for (int j = 0; j < 10; ++j) out[j][i] = y[j];
  }
}

template <int kAlgo>
static void bulk(const double* const* in, double* const* out, int64_t n,
                 const abt::Params& p) {
  for (int64_t i = 0; i < n; ++i) {
    double x[6], y[6];
    for (int j = 0; j < 6; ++j) x[j] = in[j][i];
    abt::bulk_point<double, kAlgo>(x, y, p);
    for (int j = 0; j < 6; ++j) out[j][i] = y[j];
  }
}

// kind: 0 COARE + skin, 1 ECMWF + skin, 2 + abt::BulkAlgo the stateless step
extern "C" int abt_forward_host_f64(
    const double* const* in, double* const* out, int64_t n, int kind,
    int niter, int charn_law, int visc_at_tzu, int humidity, double z0t_max,
    double z0t_coef, double z0t_pow, double beta0, double zt, double zu,
    double rdt, double gdept, double isecday_utc) {
  const abt::Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max,
                      z0t_coef, z0t_pow, beta0, zt, zu, rdt, gdept,
                      isecday_utc};
  switch (kind) {
    case 0: step<abt::CoareSkin>(in, out, n, p); break;
    case 1: step<abt::EcmwfSkin>(in, out, n, p); break;
    case 2 + abt::kCoare3p0: bulk<abt::kCoare3p0>(in, out, n, p); break;
    case 2 + abt::kCoare3p6: bulk<abt::kCoare3p6>(in, out, n, p); break;
    case 2 + abt::kEcmwf: bulk<abt::kEcmwf>(in, out, n, p); break;
    case 2 + abt::kNcar: bulk<abt::kNcar>(in, out, n, p); break;
    case 2 + abt::kAndreas: bulk<abt::kAndreas>(in, out, n, p); break;
    default: return 1;
  }
  return 0;
}
"""
ISD = 43200
#: (algorithm, use_skin): kernel 1's two builds (COARE in both versions)
#: and kernel 3's five algorithms
SOLVES = [("coare3p0", True), ("coare3p6", True), ("ecmwf", True),
          ("coare3p0", False), ("coare3p6", False), ("ecmwf", False),
          ("ncar", False), ("andreas", False)]
_IDS = [f"{a}_{'skin' if s else 'bulk'}" for a, s in SOLVES]


@pytest.fixture(scope="module")
def host_step():
    """The harness: (cfg, 13 inputs) -> the kernel's 10 outputs (skin) or
    (cfg, 6 inputs) -> its 6 outputs (stateless), fp64 CPU tensors."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++) to build the bodies")
    fn = ctypes.CDLL(str(_build.build_host(cxx, HARNESS, "forward"))
                     ).abt_forward_host_f64
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_int64] + [ctypes.c_int] * 5 + \
        [ctypes.c_double] * 9
    fn.restype = ctypes.c_int

    def run(cfg, ins):
        ins = [x.contiguous() for x in ins]
        outs = [torch.empty_like(ins[0]) for _ in range(4 + len(ins) // 2)]

        def ptrs(ts):
            return (P * len(ts))(*(t.data_ptr() for t in ts))

        kind = (int(cfg.algo == "ecmwf") if cfg.use_skin
                else 2 + tfused._BULK_ALGOS[cfg.algo])
        law, visc, *z0t = tfused._coare_args(cfg.algo)
        assert fn(ptrs(ins), ptrs(outs), ins[0].numel(), kind, cfg.niter,
                  law, visc, tfused._HUMIDITY[cfg.humidity], *z0t, cfg.zt,
                  cfg.zu, cfg.rdt, cfg.gdept, float(ISD)) == 0
        return outs
    return run


@functools.cache
def _jax_step(algo, use_skin, humidity):
    """aerobulk_tpu's flux_step under jax.jit, reduced to the kernel's
    outputs."""
    import jax
    from aerobulk_tpu import api as japi
    from aerobulk_tpu import skin as jsk
    cfg = japi.AeroBulkConfig(algo=algo, niter=5, use_skin=use_skin,
                              humidity=humidity)

    def f(*x):
        if use_skin:
            out, st = japi.flux_step(cfg, *x[:6], rad_sw=x[6], rad_lw=x[7],
                                     isecday_utc=ISD, lon=x[8],
                                     skin_state=jsk.SkinState(*x[9:]))
        else:
            out, st = japi.flux_step(cfg, *x)
        fields = (out.QL, out.QH, out.Tau_x, out.Tau_y, out.Evap, out.T_s)
        return fields + (tuple(st) if use_skin else ())
    return jax.jit(f)


def _inputs(algo, use_skin, case, humidity="sh"):
    ins, _ = _case(algo if use_skin else "coare3p6", case, humidity)
    return ins if use_skin else ins[:6]


def _eager(cfg, ins):
    t = _tensors(ins)
    if cfg.use_skin:
        outs, st = tfused.fused_flux_step_plain(
            cfg, *t[:8], lon=t[8], isecday_utc=ISD,
            skin_state=tsk.SkinState(*t[9:]))
        return [*outs, *st]
    return list(tfused.fused_bulk_step_plain(cfg, *t))


def _assert_parity(got, ref):
    """Median relative difference <= 1e-12, no significant point and no
    pointwise relative difference above 1e-10, field by field."""
    for name, g, r in zip(tfused._OUTPUTS, got, ref):
        g = np.asarray(g, dtype=np.float64).ravel()
        r = np.asarray(r, dtype=np.float64).ravel()
        assert np.isfinite(g).all() and np.isfinite(r).all(), name
        d = np.abs(g - r)
        nonzero = np.abs(r[r != 0])
        med = float(np.median(nonzero)) if nonzero.size else 0.0
        if med == 0.0:       # zero everywhere (the warm layer never built)
            assert d.max() == 0.0, name
            continue
        rel = d / np.maximum(np.abs(r), 1e-3 * med)
        assert np.median(rel) <= 1e-12, (name, np.median(rel))
        assert not np.any(d > 0.1 * med), (name, d.max(), med)
        assert rel.max() <= 1e-10, (name, rel.max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("algo,use_skin", SOLVES, ids=_IDS)
def test_body_matches_eager_port(host_step, algo, use_skin, case):
    cfg = tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=use_skin)
    ins = _inputs(algo, use_skin, case)
    _assert_parity(host_step(cfg, _tensors(ins)), _eager(cfg, ins))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("algo,use_skin", SOLVES, ids=_IDS)
def test_body_matches_jax(host_step, algo, use_skin, case):
    import jax.numpy as jnp
    cfg = tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=use_skin)
    ins = _inputs(algo, use_skin, case)
    ref = _jax_step(algo, use_skin, "sh")(*map(jnp.asarray, ins))
    _assert_parity(host_step(cfg, _tensors(ins)), ref)


@pytest.mark.parametrize("humidity", ["rh", "dp"])
@pytest.mark.parametrize("algo,use_skin", SOLVES, ids=_IDS)
def test_body_humidity_kinds(host_step, algo, use_skin, humidity):
    """Relative humidity and dew point reach q_zt through the kernel's
    q_air_of, against both references."""
    import jax.numpy as jnp
    cfg = tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=use_skin,
                              humidity=humidity)
    ins = _inputs(algo, use_skin, "built", humidity)
    got = host_step(cfg, _tensors(ins))
    _assert_parity(got, _eager(cfg, ins))
    _assert_parity(got, _jax_step(algo, use_skin, humidity)(
        *map(jnp.asarray, ins)))
