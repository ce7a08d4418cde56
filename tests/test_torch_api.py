"""aerobulk_tpu_torch.api against aerobulk_tpu.api, fp64 on the CPU: the
single step for every humidity kind, the doc/ex_ab.dat goldens, and the
host-side validation with its errors.

Tolerance: rtol 1e-12 (docs/PARITY.md §1); QH, Tau_x, Tau_y cross zero, and
so do QL and Evap where the air is moister than the surface (condensation,
common with the rh and dp inputs): these also get atol = 1e-12 * max|ref|.
The goldens keep the rtol 1e-5 of tests/test_golden_ocean.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi
from test_golden_ocean import (EX_AB, Q_ZT, RLW, RSW, SLP, SST, T_ZT, TOY,
                               U, V)

SHAPE = (6, 32)
_CROSSING = ("QH", "Tau_x", "Tau_y", "QL", "Evap")


def _forcing(humidity, seed=0):
    rng = np.random.default_rng(seed)
    sst = 280.0 + 22.0 * rng.random(SHAPE)
    t = sst + rng.normal(0.0, 2.0, SHAPE)
    hum = {"sh": 0.003 + 0.015 * rng.random(SHAPE),
           "rh": 40.0 + 60.0 * rng.random(SHAPE),
           "dp": t - 1.0 - 8.0 * rng.random(SHAPE)}[humidity]
    return dict(sst=sst, t_zt=t, hum_zt=hum, U_zu=rng.normal(0, 7, SHAPE),
                V_zu=rng.normal(0, 7, SHAPE),
                slp=97000.0 + 6000.0 * rng.random(SHAPE),
                rad_sw=800.0 * rng.random(SHAPE),
                rad_lw=250.0 + 150.0 * rng.random(SHAPE),
                lon=-180.0 + 540.0 * rng.random(SHAPE))


def _assert_outputs(got, ref):
    for name in ("QL", "QH", "Tau", "Tau_x", "Tau_y", "Evap", "T_s",
                 "rho_a"):
        r = np.asarray(getattr(ref, name))
        atol = 1e-12 * np.max(np.abs(r)) if name in _CROSSING else 0.0
        np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                   rtol=1e-12, atol=atol, err_msg=name)


@pytest.mark.parametrize("use_skin", [False, True])
@pytest.mark.parametrize("algo", ["coare3p0", "coare3p6"])
@pytest.mark.parametrize("humidity", ["sh", "rh", "dp"])
def test_flux_step_matches_jax(humidity, algo, use_skin):
    f = _forcing(humidity)
    kw = dict(algo=algo, zt=2.0, zu=10.0, niter=5, use_skin=use_skin,
              humidity=humidity)
    ref, ref_state = japi.flux_step(
        japi.AeroBulkConfig(**kw),
        *(jnp.asarray(f[n]) for n in ("sst", "t_zt", "hum_zt", "U_zu",
                                      "V_zu", "slp")),
        rad_sw=jnp.asarray(f["rad_sw"]), rad_lw=jnp.asarray(f["rad_lw"]),
        isecday_utc=20000, lon=jnp.asarray(f["lon"]))
    got, got_state = tapi.flux_step(
        tapi.AeroBulkConfig(**kw),
        *(torch.as_tensor(f[n]) for n in ("sst", "t_zt", "hum_zt", "U_zu",
                                          "V_zu", "slp")),
        rad_sw=torch.as_tensor(f["rad_sw"]),
        rad_lw=torch.as_tensor(f["rad_lw"]), isecday_utc=20000,
        lon=torch.as_tensor(f["lon"]))
    _assert_outputs(got, ref)
    for name, g, r in zip(got_state._fields, got_state, ref_state):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(np.asarray(r))),
                                   err_msg=name)


@pytest.mark.parametrize("algo", ["coare3p0", "coare3p6"])
def test_ex_ab_golden(algo):
    exp = EX_AB[algo]
    cfg = tapi.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=50,
                              use_skin=exp["skin"])
    T = torch.as_tensor
    out, _ = tapi.flux_step(cfg, T(SST), T(T_ZT), T(Q_ZT), T(U), T(V),
                            T(SLP), rad_sw=T(RSW),
                            # ex_ab.dat was made with the reference's
                            # hardcoded library clock
                            rad_lw=T(RLW), isecday_utc=12)
    np.testing.assert_allclose(out.QH.numpy(), exp["QH"], rtol=1e-5)
    np.testing.assert_allclose(out.QL.numpy(), exp["QL"], rtol=1e-5)
    np.testing.assert_allclose(out.Evap.numpy() * 86400.0, exp["E"],
                               rtol=1e-5)
    np.testing.assert_allclose(out.Tau_x.numpy(), exp["Tx"], rtol=1e-5)
    np.testing.assert_allclose(out.Tau_y.numpy(), 0.0, atol=1e-12)
    np.testing.assert_allclose(out.T_s.numpy() - 273.15, exp["Ts"],
                               atol=2e-5)


@pytest.mark.parametrize("algo", ["coare3p0", "coare3p6"])
def test_readme_toy_table(algo):
    exp = TOY[algo]
    cfg = tapi.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=20)
    T = lambda a: torch.as_tensor(a[:1])
    out, _ = tapi.flux_step(cfg, T(SST), T(T_ZT), T(Q_ZT), T(U), T(V),
                            T(SLP))
    d = out.diag
    for key, field, rtol in (("Cd", "Cd", 2e-3), ("Ce", "Ce", 2e-3),
                             ("Ch", "Ch", 2e-3), ("z0", "z0", 5e-3),
                             ("us", "u_star", 2e-3), ("UN10", "UN10", 2e-3),
                             ("CdN", "CdN", 2e-3), ("CeN", "CeN", 2e-3),
                             ("ChN", "ChN", 2e-3)):
        np.testing.assert_allclose(getattr(d, field).numpy(), exp[key],
                                   rtol=rtol, err_msg=key)


def test_flux_wrapper_equals_flux_step():
    f = _forcing("sh", seed=3)
    T = torch.as_tensor
    args = [T(f[n]) for n in ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")]
    a = tapi.flux("coare3p6", 2.0, 10.0, *args, niter=4)
    b, _ = tapi.flux_step(tapi.AeroBulkConfig(niter=4), *args)
    torch.testing.assert_close(a.QL, b.QL, rtol=0, atol=0)


# --- host-side validation ----------------------------------------------------

def _both(fn_name, *args, **kw):
    """Run a validation function in both packages; return both results or
    both exceptions."""
    out = []
    for mod in (japi, tapi):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except ValueError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("values", [
    0.003 + 0.015 * np.arange(12) / 12,     # specific humidity
    280.0 + np.arange(12.0),                # dew point
    40.0 + 5.0 * np.arange(12.0),           # relative humidity
    np.full(12, 500.0),                     # nothing: raises
])
def test_detect_humidity_type_matches_jax(values):
    j, t = _both("detect_humidity_type", values)
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
    else:
        assert t == j
    # a tensor input reads the same as the numpy one
    if not isinstance(j, ValueError):
        assert tapi.detect_humidity_type(torch.as_tensor(values)) == j


@pytest.mark.parametrize("field,values", [
    ("sst", 290.0 + np.arange(5.0)),
    ("sst", np.array([290.0, 12.0, 291.0])),        # degC given: raises
    ("slp", np.array([1010.0, 1012.0])),            # hPa given: raises
    ("wnd", np.array([3.0, 60.0])),
])
def test_check_unit_consistency_matches_jax(field, values):
    j, t = _both("check_unit_consistency", field, values)
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError) and str(t) == str(j)
    else:
        assert t is None and j is None


@pytest.mark.parametrize("case", ["ok", "auto", "masked", "units", "shape"])
def test_init_matches_jax(case):
    f = _forcing("sh", seed=4)
    humidity = "auto" if case == "auto" else "sh"
    if case == "masked":
        f["sst"] = f["sst"] - 273.15          # every point out of range
    if case == "units":
        f["hum_zt"] = f["hum_zt"] * 1000.0    # g/kg given as kg/kg
    if case == "shape":
        f["slp"] = f["slp"][:, :5]
    args = [f[n] for n in ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")]
    rad = dict(rad_sw=f["rad_sw"], rad_lw=f["rad_lw"])
    j = t = None
    try:
        j = japi.init(japi.AeroBulkConfig(humidity=humidity), *args, **rad)
    except ValueError as e:
        j = e
    try:
        t = tapi.init(tapi.AeroBulkConfig(humidity=humidity),
                      *(torch.as_tensor(a) for a in args), **rad)
    except ValueError as e:
        t = e
    if isinstance(j, ValueError):
        assert isinstance(t, ValueError)
        assert str(t).replace("aerobulk_tpu_torch", "aerobulk_tpu") == str(j)
    else:
        np.testing.assert_array_equal(t[0], j[0])
        assert t[1] == j[1]


def test_config_errors_match_jax():
    for kw in (dict(algo="nope"), dict(humidity="gkg"),
               dict(algo="ncar", use_skin=True)):
        with pytest.raises(ValueError) as je:
            japi.AeroBulkConfig(**kw)
        with pytest.raises(ValueError) as te:
            tapi.AeroBulkConfig(**kw)
        assert str(te.value) == str(je.value)


def test_flux_step_needs_solar_clock_with_skin():
    f = {k: torch.as_tensor(v) for k, v in _forcing("sh").items()}
    cfg = tapi.AeroBulkConfig(use_skin=True)
    with pytest.raises(ValueError, match="isecday_utc"):
        tapi.flux_step(cfg, f["sst"], f["t_zt"], f["hum_zt"], f["U_zu"],
                       f["V_zu"], f["slp"], rad_sw=f["rad_sw"],
                       rad_lw=f["rad_lw"])


def test_flux_sanity_matches_jax():
    f = _forcing("sh", seed=6)
    names = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")
    jout, _ = japi.flux_step(japi.AeroBulkConfig(),
                             *(jnp.asarray(f[n]) for n in names))
    tout, _ = tapi.flux_step(tapi.AeroBulkConfig(),
                             *(torch.as_tensor(f[n]) for n in names))
    assert int(tapi.flux_sanity_count(tout)) == 0
    assert tapi.check_flux_sanity(tout) is tout
    bad_j = jout._replace(QL=jout.QL.at[0, 0].set(jnp.nan),
                          Tau=jout.Tau.at[1, 1].set(20.0))
    ql, tau = tout.QL.clone(), tout.Tau.clone()
    ql[0, 0], tau[1, 1] = float("nan"), 20.0
    bad_t = tout._replace(QL=ql, Tau=tau)
    assert int(tapi.flux_sanity_count(bad_t)) == \
        int(japi.flux_sanity_count(bad_j)) == 2
    with pytest.raises(ValueError) as je:
        japi.check_flux_sanity(bad_j)
    with pytest.raises(ValueError) as te:
        tapi.check_flux_sanity(bad_t)
    assert str(te.value) == str(je.value)
    # the reduced (fused) output set rebuilds |tau| from its components
    reduced = bad_t._replace(Tau=None)
    assert int(tapi.flux_sanity_count(reduced)) >= 1


# --- run_series(batch_records=True): the stateless series in one call -------

_STEP = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")
_REDUCED = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")


def _series(nt=5, seed=8):
    f = _forcing("sh", seed=seed)
    rng = np.random.default_rng(seed)
    return {k: np.stack([v * (1.0 + 0.05 * rng.standard_normal()
                              if k in ("U_zu", "V_zu") else 1.0)
                         for _ in range(nt)])
            for k, v in f.items() if k != "lon"}


@pytest.mark.parametrize("backend", ["eager", "fused"])
@pytest.mark.parametrize("algo", ["coare3p0", "coare3p6", "ecmwf", "ncar",
                                  "andreas"])
def test_batched_series_matches_jax(algo, backend):
    """Against aerobulk_tpu's run_series(batch_records=True) (its jit
    batch).  On CPU tensors the fused backend is the plain version: the
    reduced output set, and no launch."""
    f = _series()
    kw = dict(algo=algo, zt=2.0, zu=10.0, niter=5)
    ref, _ = japi.run_series(japi.AeroBulkConfig(**kw),
                             {k: jnp.asarray(f[k]) for k in _STEP},
                             batch_records=True)
    from aerobulk_tpu_torch.kernels import fused as tfused
    launches = tfused.BULK_LAUNCHES
    got, state = tapi.run_series(tapi.AeroBulkConfig(**kw),
                                 {k: torch.as_tensor(f[k]) for k in _STEP},
                                 batch_records=True, backend=backend)
    assert tfused.BULK_LAUNCHES == launches
    assert state.dT_wl.shape == f["sst"].shape[1:]
    for name in _REDUCED:
        r = np.asarray(getattr(ref, name))
        atol = 1e-12 * np.max(np.abs(r)) if name in _CROSSING else 0.0
        np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                   rtol=1e-12, atol=atol, err_msg=name)
    if backend == "fused":
        assert got.Tau is None and got.rho_a is None and got.diag is None
    else:
        _assert_outputs(got, ref)


def test_batched_series_equals_the_record_loop():
    """The records of a stateless config are independent: one call on the
    whole series gives the loop's values to the bit."""
    f = {k: torch.as_tensor(v) for k, v in _series(nt=3).items()}
    cfg = tapi.AeroBulkConfig(algo="ncar")
    batch, _ = tapi.run_series(cfg, f, batch_records=True)
    loop, _ = tapi.run_series(cfg, f)
    for name in _REDUCED:
        torch.testing.assert_close(getattr(batch, name),
                                   getattr(loop, name), rtol=0, atol=0)


def test_batched_series_fused_warns_of_ignored_inputs():
    f = {k: torch.as_tensor(v) for k, v in _series(nt=2).items()}
    with pytest.warns(UserWarning, match="ignoring.*rad_sw.*lon"):
        tapi.run_series(tapi.AeroBulkConfig(algo="ncar"), f,
                        batch_records=True, backend="fused",
                        lon=torch.zeros_like(f["sst"][0]))


@pytest.mark.parametrize("kw,backend,match", [
    (dict(use_skin=True), "eager", "stateless"),
    (dict(use_skin=True), "fused", "stateless"),
    (dict(), "jit", "unknown backend"),
])
def test_batched_series_errors_match_jax(kw, backend, match):
    f = _series(nt=2)
    if backend == "jit":       # the reference's name for its eager backend
        jb = "nope"
    else:
        jb = "jit" if backend == "eager" else backend
    with pytest.raises(ValueError) as je:
        japi.run_series(japi.AeroBulkConfig(**kw),
                        {k: jnp.asarray(v) for k, v in f.items()},
                        batch_records=True, backend=jb)
    with pytest.raises(ValueError, match=match) as te:
        tapi.run_series(tapi.AeroBulkConfig(**kw),
                        {k: torch.as_tensor(v) for k, v in f.items()},
                        batch_records=True, backend=backend)
    if backend != "jit":
        assert str(te.value) == str(je.value)


def test_init_skin_state_defaults_to_the_card(monkeypatch):
    """``device`` omitted means the CUDA device; with no GPU the call
    raises.  The test hides any card, so it never reaches for one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for algo in ("coare3p6", "ecmwf"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapi.init_skin_state(tapi.AeroBulkConfig(algo=algo), (2, 3))
        st = tapi.init_skin_state(tapi.AeroBulkConfig(algo=algo), (2, 3),
                                  device="cpu")
        assert st.Hz_wl.device.type == "cpu"
