"""The reference's validity envelope through the port's eager path, fp64 and
fp32 on the CPU, against the JAX package in fp64.

Inputs are the reference's own (tests/test_fuzz_robustness.py): 20,000
ocean points over AEROBULK_INIT's ranges with the corners forced in (u = 0
with t = sst and t = sst + 25 K, 50 m/s with t = sst - 25 K, u = 0.001;
``_fuzz_inputs``, seed 77), and 8,000 ice points (seed 13, wind 0 and
50 m/s, frice 0 and 1 at the first two).  Every ocean algorithm runs at
niter=10, with cool skin and warm layer where it has them; every ice
algorithm at niter=8.

In both dtypes, every assertion the reference makes: finite fluxes and
diagnostics, Cd >= 0.999 Cx_min, dT_wl >= 0, and tau below ref_tau_max
where the wind is under 25 m/s.  Against ``aerobulk_tpu`` in fp64, on a
seeded subset of 2,000 points that holds the corners (the JAX steps run
unjitted, so the subset keeps their time small): NaN masks identical, and
every field at rtol 1e-11 and atol 1e-12 * max|ref|.  The per-step tests'
forcing holds 1e-12; the envelope's extremes are worse conditioned (worst
relative gap measured: 2.0e-12, COARE 3.6's QL; the gaps print).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu import constants as c
from aerobulk_tpu import thermo as jth
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch.ice import ICE_ALGOS
from test_fuzz_robustness import _fuzz_inputs

OCEAN = ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas")
SKIN = ("coare3p0", "coare3p6", "ecmwf")
OUT_FIELDS = ("QL", "QH", "Tau", "Tau_x", "Tau_y", "Evap", "T_s")
DIAG_FIELDS = ("Cd", "Ch", "Ce", "z0", "u_star", "UN10")
N_SUBSET = 2000


def _subset(n, corners, seed=2024):
    rng = np.random.default_rng(seed)
    rest = rng.choice(np.arange(corners, n), N_SUBSET - corners,
                      replace=False)
    return np.concatenate([np.arange(corners), np.sort(rest)])


def _ocean_inputs():
    return [np.asarray(x) for x in _fuzz_inputs()]


def _ice_inputs():
    """tests/test_fuzz_robustness.py::test_ice_algos_finite_over_validity_
    envelope's draws (seed 13)."""
    rng = np.random.default_rng(13)
    n = 8000
    Ts_i = rng.uniform(230.0, 273.15, n)
    t = np.clip(Ts_i + rng.uniform(-20.0, 20.0, n), 180.0, 330.0)
    slp = rng.uniform(c.ref_slp_min, c.ref_slp_max, n)
    qs = np.asarray(jth.q_sat(jnp.asarray(t), jnp.asarray(slp), l_ice=True))
    q = rng.uniform(0.0, 1.0, n) * qs
    wnd = rng.uniform(0.0, 50.0, n)
    wnd[:2] = [0.0, 50.0]
    fr = rng.uniform(0.0, 1.0, n)
    fr[:2] = [0.0, 1.0]
    return Ts_i, t, q, wnd, np.zeros(n), slp, fr


def _ocean_step(pkg, algo, arrays, to):
    sst, t, q, u, v, slp, rsw, rlw, lon = (to(a) for a in arrays)
    skin = algo in SKIN
    cfg = pkg.AeroBulkConfig(algo=algo, niter=10, use_skin=skin)
    kw = dict(rad_sw=rsw, rad_lw=rlw, isecday_utc=50000, lon=lon) \
        if skin else {}
    return pkg.flux_step(cfg, sst, t, q, u, v, slp, **kw)


def _assert_like_jax(got, ref, names, what):
    for name in names:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r),
                                      err_msg=f"{what}.{name}: NaN masks")
        fin = np.isfinite(r)
        np.testing.assert_allclose(
            g, r, rtol=1e-11, atol=1e-12 * np.max(np.abs(r[fin])),
            err_msg=f"{what}.{name}")


def _worst_rel(got, ref, names):
    out = {}
    for name in names:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        fin = np.isfinite(r) & (r != 0)
        if fin.any():      # Tau_y is 0 everywhere over ice (V_zu = 0)
            out[name] = float(np.max(np.abs(g[fin] - r[fin])
                                     / np.abs(r[fin])))
    return out


@pytest.mark.parametrize("algo", OCEAN)
def test_ocean_envelope_finite_and_like_jax(algo):
    arrays = _ocean_inputs()
    for dtype in (torch.float64, torch.float32):
        out, st = _ocean_step(tapi, algo, arrays,
                              lambda a: torch.as_tensor(a, dtype=dtype))
        what = f"{algo} {dtype}"
        for name in OUT_FIELDS:
            x = getattr(out, name)
            bad = ~torch.isfinite(x)
            assert not bad.any(), (
                f"{what} {name}: {int(bad.sum())} non-finite, e.g. "
                f"{torch.nonzero(bad).reshape(-1)[:5].tolist()}")
        for name in DIAG_FIELDS:
            assert torch.isfinite(getattr(out.diag, name)).all(), \
                f"{what} diag.{name}"
        assert (out.diag.Cd >= c.Cx_min * 0.999).all(), what
        if algo in SKIN:
            assert (st.dT_wl >= 0.0).all(), what
        wnd = np.hypot(arrays[3], arrays[4])
        assert float(out.Tau[torch.as_tensor(wnd < 25.0)].max()) \
            < c.ref_tau_max, what

    idx = _subset(len(arrays[0]), 4)
    sub = [a[idx] for a in arrays]
    ref, ref_st = _ocean_step(japi, algo, sub, jnp.asarray)
    got, got_st = _ocean_step(tapi, algo, sub, torch.as_tensor)
    print(f"\n{algo}: worst relative gap to aerobulk_tpu over "
          f"{N_SUBSET} envelope points: "
          f"{_worst_rel(got, ref, OUT_FIELDS)}")
    _assert_like_jax(got, ref, OUT_FIELDS, algo)
    _assert_like_jax(got.diag, ref.diag, DIAG_FIELDS, f"{algo}.diag")
    if algo in SKIN:
        _assert_like_jax(got_st, ref_st, got_st._fields, f"{algo}.state")


def _ice_step(pkg, algo, arrays, to):
    Ts_i, t, q, u, v, slp, fr = (to(a) for a in arrays)
    return pkg.flux_step_ice(algo, 2.0, 10.0, Ts_i, t, q, u, v, slp,
                             frice=fr, niter=8)


@pytest.mark.parametrize("algo", sorted(ICE_ALGOS))
def test_ice_envelope_finite_and_like_jax(algo):
    arrays = _ice_inputs()
    for dtype in (torch.float64, torch.float32):
        out, d = _ice_step(tapi, algo, arrays,
                           lambda a: torch.as_tensor(a, dtype=dtype))
        for name in ("QL", "QH", "Tau"):
            assert torch.isfinite(getattr(out, name)).all(), \
                f"{algo} {dtype} {name}"
        for name in ("Cd", "Ch", "Ce"):
            assert torch.isfinite(getattr(d, name)).all(), \
                f"{algo} {dtype} {name}"

    idx = _subset(len(arrays[0]), 2)
    sub = [a[idx] for a in arrays]
    ref, ref_d = _ice_step(japi, algo, sub, jnp.asarray)
    got, got_d = _ice_step(tapi, algo, sub, torch.as_tensor)
    print(f"\n{algo}: worst relative gap to aerobulk_tpu over {N_SUBSET} "
          f"envelope points: {_worst_rel(got, ref, OUT_FIELDS)}")
    _assert_like_jax(got, ref, OUT_FIELDS, algo)
    _assert_like_jax(got_d, ref_d, ("Cd", "Ch", "Ce"), f"{algo}.diag")


def test_measure_envelopes_are_the_references():
    """chip_smoke.py's copies (``measure.ocean_envelope``,
    ``measure.ice_envelope``) draw the reference's points: bitwise, but
    for the humidity, which goes through each package's q_sat (rtol
    1e-14)."""
    from aerobulk_tpu_torch import measure
    for name, g, r in zip(("sst", "t", "q", "u", "v", "slp", "rsw", "rlw",
                           "lon"), measure.ocean_envelope(), _ocean_inputs()):
        np.testing.assert_allclose(g, r, rtol=1e-14 if name == "q" else 0,
                                   err_msg=name)
    got = measure.ice_envelope()
    for name, g, r in zip(("Ts_i", "t", "q", "wnd", "v", "slp", "frice"),
                          (got[0], *got[2:]), _ice_inputs()):
        np.testing.assert_allclose(g, r, rtol=1e-14 if name == "q" else 0,
                                   err_msg=name)
    sst, t = got[1], got[2]
    assert np.all((sst >= c.ref_sst_min) & (sst <= c.ref_sst_max))
    inside = (sst > c.ref_sst_min) & (sst < c.ref_sst_max)
    assert np.all(np.abs(sst - t)[inside] <= 25.0)
