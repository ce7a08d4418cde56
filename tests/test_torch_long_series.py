"""A month of hourly stateful records through the port's eager
``run_series``, fp32 against fp64 and fp64 against the JAX package, on the
CPU (COARE 3.6 + cool skin + warm layer).

The forcing is the reference's month (tests/test_long_series.py's weather
machine: seed 405, 6 points, 720 records, ``hum_zt`` from the scalar
oracle's ``q_sat``).  Gates:

* fp32 against fp64 at the reference's own asserted budgets
  (tests/test_long_series.py::test_fp32_state_drift_budget_720_steps):
  final Qnt_ac < 4e3 J/m^2, Tau_ac < 0.1 N.s/m^2, dT_wl < 1e-5 K; dT_wl
  over the run < 1e-4 K; QL and QH over the run < 0.5 W/m^2.  The
  measured values print beside docs/SCALING.md's (the JAX package's, CPU).
* the port's fp64 series against ``aerobulk_tpu.api.run_series`` in fp64
  on the same forcing: every record's fluxes and the final SkinState at
  rtol 1e-11 and atol 1e-12 * max|ref| of the field (720 records of state
  carried through the dawn resets; the worst relative gaps print).
"""

import jax.numpy as jnp
import numpy as np
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi
from test_long_series import _weather_forcing

NT, NPTS, SEED = 720, 6, 405
#: docs/SCALING.md "fp32 drift budget" (the JAX package on the CPU)
SCALING_MD = {"Qnt_ac": 36.0, "Tau_ac": 1.1e-3, "dT_wl_final": 3.1e-8,
              "dT_wl_traj": 1.3e-6, "QL_traj": 2.5e-3, "QH_traj": 2.5e-3}
BUDGET = {"Qnt_ac": 4e3, "Tau_ac": 0.1, "dT_wl_final": 1e-5,
          "dT_wl_traj": 1e-4, "QL_traj": 0.5, "QH_traj": 0.5}


def _port_run(f, isd, lon, dtype):
    cfg = tapi.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                              use_skin=True)
    forcing = {k: torch.as_tensor(v, dtype=dtype) for k, v in f.items()}
    return tapi.run_series(cfg, forcing, isecday_utc=isd,
                           lon=torch.as_tensor(lon, dtype=dtype),
                           skin_state=tapi.init_skin_state(cfg, (NPTS,), dtype,
                                                           "cpu"))


def test_month_fp32_drift_and_fp64_parity_with_jax():
    f, isd, lon = _weather_forcing(NT, NPTS, seed=SEED)
    o64, s64 = _port_run(f, isd, lon, torch.float64)
    o32, s32 = _port_run(f, isd, lon, torch.float32)

    def drift(a, b):
        return float((a.double() - b).abs().max())

    got = {"Qnt_ac": drift(s32.Qnt_ac, s64.Qnt_ac),
           "Tau_ac": drift(s32.Tau_ac, s64.Tau_ac),
           "dT_wl_final": drift(s32.dT_wl, s64.dT_wl),
           "dT_wl_traj": drift(o32.diag.dT_wl, o64.diag.dT_wl),
           "QL_traj": drift(o32.QL, o64.QL),
           "QH_traj": drift(o32.QH, o64.QH)}
    print(f"\nport eager fp32 drift over {NT} records (docs/SCALING.md, "
          "the JAX package, in brackets):")
    for k, v in got.items():
        print(f"  {k:12s} {v:.3g}  [{SCALING_MD[k]:.3g}]  budget {BUDGET[k]}")
    for k, v in got.items():
        assert v < BUDGET[k], (k, v)

    # the month must exercise the warm layer: builds, dawn resets
    dT = o64.diag.dT_wl
    assert float(dT.max()) > 0.05
    assert int(((dT[:-1] > 0) & (dT[1:] == 0)).sum()) >= 20 * NPTS

    cfg = japi.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                              use_skin=True)
    jo, js = japi.run_series(cfg, {k: jnp.asarray(v) for k, v in f.items()},
                             isecday_utc=jnp.asarray(isd),
                             lon=jnp.asarray(lon),
                             skin_state=japi.init_skin_state(cfg, (NPTS,)))
    worst = {}
    pairs = [(n, getattr(o64, n), getattr(jo, n))
             for n in ("QL", "QH", "Tau", "Tau_x", "Tau_y", "Evap", "T_s")]
    pairs += [(n, g, r) for n, g, r in zip(s64._fields, s64, js)]
    for name, g, r in pairs:
        g, r = g.numpy(), np.asarray(r)
        worst[name] = float(np.max(np.abs(g - r)
                                   / np.maximum(np.abs(r), 1e-300)))
        np.testing.assert_allclose(g, r, rtol=1e-11,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)
    print("port fp64 against aerobulk_tpu.run_series fp64, worst relative "
          "gap: " + ", ".join(f"{k} {v:.2g}" for k, v in worst.items()))


def test_measure_weather_forcing_is_the_references():
    """chip_smoke.py's copy of the weather machine
    (``measure.weather_forcing``) draws the reference's month and year:
    bitwise, but for the humidity (the port's vectorized q_sat against the
    scalar oracle's, rtol 1e-14)."""
    from aerobulk_tpu_torch import measure
    for nt, npts, seed, seasonal in ((NT, NPTS, SEED, False),
                                     (8760, 4, 406, True)):
        got = measure.weather_forcing(nt, npts, seed, seasonal=seasonal)
        ref = _weather_forcing(nt, npts, seed=seed, seasonal=seasonal)
        for k in ref[0]:
            np.testing.assert_allclose(got[0][k], ref[0][k],
                                       rtol=1e-14 if k == "hum_zt" else 0,
                                       err_msg=k)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])


def test_chip_smoke_fields_stats_are_diff_stats():
    """Phase 20(c)'s batched statistics (chip_smoke.fields_stats) give
    exactly what diff_stats and its callers' reductions give field by
    field: the significant fraction, the largest difference, its 99.99th
    percentile and the median relative difference; NaN where the reference
    is NaN, a field that is zero everywhere, a field of zeros in part, and
    the reference's scale passed in by a second pair."""
    import chip_smoke
    rng = np.random.default_rng(11)
    b = rng.normal(0.0, 3.0, (5, 3000))
    b[1] = 0.0
    b[2, :2000] = 0.0
    b[3, rng.random(3000) < 0.1] = np.nan
    a = b + rng.normal(0.0, 0.05, b.shape) * (rng.random(b.shape) < 0.3)
    a[1, :7] = 1e-5
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    got, med = chip_smoke.fields_stats(a, b, "test")
    again, _ = chip_smoke.fields_stats(a, b, "test", med)
    assert again == got
    for i in range(b.shape[0]):
        s = chip_smoke.diff_stats(a[i], b[i], what="test")
        d = s["d"][s["keep"]]
        assert got["sig_frac"][i] == s["sig_frac"]
        assert got["max_abs"][i] == float(d.max())
        assert got["p9999_abs"][i] == float(torch.topk(
            d, d.numel() - int(0.9999 * d.numel())).values[-1])
        assert got["median_rel"][i] == chip_smoke.median(s["rel"])
        assert float(med[i]) == s["med"]
