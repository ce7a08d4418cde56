"""The sea-ice family and the mixed ocean+ice cell of aerobulk_tpu_torch
against aerobulk_tpu's, fp64 on the CPU: the ice branch of thermo, the
Jordan-99 psi functions, the form-drag closures, the seven ice algorithms
(every FluxResult field, zt != zu and zt == zu), api.flux_step_ice for
every algorithm and humidity kind, api.flux_step_mixed (LG15 with every
ocean algorithm, every ice algorithm with ECMWF, the simultaneous LG15_IO
solve; net, ice and ocean parts), and the plain versions of the ice and
mixed kernels (what the Pallas bodies call: flux_step_ice /
flux_step_mixed, aerobulk_tpu/kernels/fused.py:185-190, 106-111).

Tolerance: rtol 1e-12 (docs/PARITY.md §1).  Fields that change sign with
the air-sea differences or pass through 0 (L, compared as 1/L; the fluxes
QL, QH, Tau_x, Tau_y, Evap; the blended net) also get atol = 1e-12 *
max|ref|, as in tests/test_torch_algos.py.  No iterated algorithm needs a
wider tolerance: test_reference_is_reproducible_here holds aerobulk_tpu's
own eager and jit evaluations of the three iterated solves (AN05, BEST,
EASY) to the same bar on these inputs, the precedent
tests/test_torch_coare.py sets for COARE's Ce.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu import ice as jice
from aerobulk_tpu import stability as jsb
from aerobulk_tpu import thermo as jth
from aerobulk_tpu.ice import form_drag as jfd
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import ice as tice
from aerobulk_tpu_torch import stability as tsb
from aerobulk_tpu_torch import thermo as tth
from aerobulk_tpu_torch.ice import form_drag as tfd
from aerobulk_tpu_torch.kernels import fused as tfused

N = 256
ICE = list(tice.ICE_ALGOS)
OCEAN = ["coare3p0", "coare3p6", "ecmwf", "ncar", "andreas"]
_NEAR_ZERO = ("L", "QL", "QH", "Tau_x", "Tau_y", "Evap")
_TURB = ("Ts_i", "t_zt", "qs_i", "q_zt", "U_zu")
_OUT = ("QL", "QH", "Tau", "Tau_x", "Tau_y", "Evap", "T_s", "rho_a")


def _close(name, got, ref, rtol=1e-12, near_zero=_NEAR_ZERO):
    g, r = np.asarray(got), np.asarray(ref)
    if name == "L":
        g, r = 1.0 / g, 1.0 / r
    atol = 1e-12 * np.max(np.abs(r)) if name in near_zero else 0.0
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


def _compare(got, ref):
    assert got._fields == ref._fields
    for name, g, r in zip(got._fields, got, ref):
        _close(name, g.detach().numpy(), r)


def _turb_inputs(seed, n=N):
    """Ice surfaces from 230 K to the melting point, air within 6 K of them
    (both signs of the air-ice differences), humidities on either side of
    saturation over ice, winds from calm (below the 0.2 m/s threshold) to
    storm, ice fractions over [0, 1] with exact 0 and 1."""
    rng = np.random.default_rng(seed)
    Ts = 230.0 + 43.15 * rng.random(n)
    qs_i = np.array(jth.q_sat(jnp.asarray(Ts), 101000.0, l_ice=True))
    U = np.concatenate([0.3 + 24.0 * rng.random(n - 8),
                        [0.0, 0.1, 0.2, 0.5, 1.0, 20.0, 30.0, 0.2]])
    frice = rng.random(n)
    frice[:3] = (0.0, 1.0, 0.5)
    return dict(Ts_i=Ts, t_zt=Ts + rng.uniform(-6.0, 6.0, n), qs_i=qs_i,
                q_zt=qs_i * (0.3 + 1.0 * rng.random(n)), U_zu=U,
                frice=frice)


# ---------------------------------------------------------------------------
# the ice branch of thermo, the ice psi functions, the form-drag closures
# ---------------------------------------------------------------------------

def test_ice_thermo_matches_jax():
    rng = np.random.default_rng(1)
    Ta = np.concatenate([[150.0, 180.0, 273.16], 200.0 + 80.0 * rng.random(N)])
    slp = 97000.0 + 7000.0 * rng.random(Ta.size)
    J, T = jnp.asarray, torch.as_tensor
    for name, args in (("e_sat_ice", (Ta,)), ("de_sat_dt_ice", (Ta,)),
                       ("dq_sat_dt_ice", (Ta, slp))):
        _close(name, getattr(tth, name)(*map(T, args)).numpy(),
               getattr(jth, name)(*map(J, args)))
    for l_ice in (False, True):
        _close("q_sat", tth.q_sat(T(Ta), T(slp), l_ice=l_ice).numpy(),
               jth.q_sat(J(Ta), J(slp), l_ice=l_ice))
        _close("qlw_net", tth.qlw_net(T(slp / 300.0), T(Ta),
                                      l_ice=l_ice).numpy(),
               jth.qlw_net(J(slp / 300.0), J(Ta), l_ice=l_ice))


@pytest.mark.parametrize("l_ice", [False, True])
def test_bulk_formula_ice_branch_matches_jax(l_ice):
    """Over ice: sublimation's latent heat of the unclamped flux, and Evap
    keeps only its negative part (both signs of q - qs are drawn)."""
    rng = np.random.default_rng(2)
    ts = 240.0 + 30.0 * rng.random(N)
    qs = 1e-3 * rng.random(N)
    args = (10.0, ts, qs, ts + rng.normal(0, 3, N), qs * 2 * rng.random(N),
            1e-3 + 1e-3 * rng.random(N), 1e-3 * rng.random(N),
            1e-3 * rng.random(N), 20 * rng.random(N), 0.2 + 20 * rng.random(N),
            98000.0 + 5000.0 * rng.random(N))
    got = tth.bulk_formula(*args[:1], *map(torch.as_tensor, args[1:]),
                           l_ice=l_ice)
    ref = jth.bulk_formula(*args[:1], *map(jnp.asarray, args[1:]),
                           l_ice=l_ice)
    for name, g, r in zip(("Tau", "QH", "QL", "Evap", "rho"), got, ref):
        _close(name, g.numpy(), r)
    if l_ice:
        assert (got[3] <= 0).all() and (got[2] > 0).any()


_ZETA = np.concatenate([np.linspace(-50.0, 50.0, 401), [-1e-12, 0.0, -0.0,
                                                        1e-12, 1.0 / 16.0]])


@pytest.mark.parametrize("fn", ["psi_m_ice", "psi_h_ice"])
def test_ice_psi_matches_jax(fn):
    """psi over zeta in [-50, 50], the stable/unstable knife at 0 (both
    signs of zero) and the unstable branch's root at zeta = 1/16."""
    _close(fn, getattr(tsb, fn)(torch.as_tensor(_ZETA)).numpy(),
           getattr(jsb, fn)(jnp.asarray(_ZETA)))


def test_louis_functions_match_jax():
    """f_m_louis / f_h_louis with tensor coefficients (LG15) and with Python
    floats (BEST, where the products with the constants are folded in
    double), across both signs of RiB and its knife at 0."""
    rng = np.random.default_rng(3)
    rib = np.concatenate([[0.0, -0.0, -1.0, 1e-9], rng.normal(0, 0.5, N)])
    cdn = 1e-3 + 2e-3 * rng.random(rib.size)
    z0 = 1e-4 + 1e-3 * rng.random(rib.size)
    for name in ("f_m_louis", "f_h_louis"):
        tf, jf = getattr(tth, name), getattr(jth, name)
        for zu in (2.0, 10.0):
            _close(name, tf(zu, *map(torch.as_tensor, (rib, cdn, z0))).numpy(),
                   jf(zu, *map(jnp.asarray, (rib, cdn, z0))))
            _close(name, tf(zu, torch.as_tensor(rib), 1.7e-3, 6.9e-4).numpy(),
                   jf(zu, jnp.asarray(rib), 1.7e-3, 6.9e-4))


_FRICE = np.concatenate([[0.0, 1.0], np.linspace(0.01, 0.99, 99)])


@pytest.mark.parametrize("closure", ["cdn10_f_lu12", "cdn_f_lu12_eq36",
                                     "cdn10_f_lu13", "cdn_f_lg15",
                                     "cdn_f_lg15_light"])
def test_form_drag_closures_match_jax(closure):
    """The five form-drag closures of mod_cdn_form_ice.f90, ice fraction
    from exactly 0 to exactly 1."""
    z0 = np.full(_FRICE.size, 4.54e-4)
    extra = {"cdn10_f_lu12": (z0,), "cdn_f_lg15": (z0,),
             "cdn_f_lg15_light": (z0,)}.get(closure, ())
    lead = () if closure in ("cdn10_f_lu12", "cdn10_f_lu13") else (10.0,)
    got = getattr(tfd, closure)(*lead, *map(torch.as_tensor,
                                            (_FRICE,) + extra))
    ref = getattr(jfd, closure)(*lead, *map(jnp.asarray, (_FRICE,) + extra))
    _close(closure, got.numpy(), ref)
    assert np.isfinite(got.numpy()).all()


def test_registry_matches_jax():
    assert list(tice.ICE_ALGOS) == list(jice.ICE_ALGOS)
    for name, (fn, needs_frice) in tice.ICE_ALGOS.items():
        assert needs_frice == jice.ICE_ALGOS[name][1]
        assert fn.__name__ == jice.ICE_ALGOS[name][0].__name__


# ---------------------------------------------------------------------------
# the seven ice algorithms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("zt", [2.0, 10.0])
@pytest.mark.parametrize("algo", ICE)
def test_turb_ice_matches_jax(algo, zt):
    """Every FluxResult field of each algorithm, for zt != zu (the height
    adjustment) and zt == zu (the branch decided on the host)."""
    f = _turb_inputs(7 + ICE.index(algo))
    jfn, needs_frice = jice.ICE_ALGOS[algo]
    tfn = tice.ICE_ALGOS[algo][0]
    extra = ("frice",) if needs_frice else ()
    ref = jfn(zt, 10.0, *(jnp.asarray(f[n]) for n in _TURB + extra), niter=5)
    got = tfn(zt, 10.0, *(torch.as_tensor(f[n]) for n in _TURB + extra),
              niter=5)
    _compare(got, ref)


def test_turb_ice_lg15_io_water_side_matches_jax():
    f = _turb_inputs(21)
    rng = np.random.default_rng(22)
    sst = 271.2 + 15.0 * rng.random(N)
    ssq = 0.98 * np.asarray(jth.q_sat(jnp.asarray(sst), 101000.0))
    for zt in (2.0, 10.0):
        ref = jice.turb_ice_lg15_io(
            zt, 10.0, *(jnp.asarray(f[n]) for n in _TURB + ("frice",)),
            Ts_w=jnp.asarray(sst), qs_w=jnp.asarray(ssq))
        got = tice.turb_ice_lg15_io(
            zt, 10.0, *(torch.as_tensor(f[n]) for n in _TURB + ("frice",)),
            Ts_w=torch.as_tensor(sst), qs_w=torch.as_tensor(ssq))
        for g, r in zip(got, ref):
            _compare(g, r)


def test_ice_easy_settings_match_jax():
    f = _turb_inputs(30)
    kw = dict(CdN=1.6e-3, ChN=1.5e-3, CeN=1.5e-3, niter=4)
    ref = jice.turb_ice_easy(2.0, 10.0, *(jnp.asarray(f[n]) for n in _TURB),
                             **kw)
    got = tice.turb_ice_easy(2.0, 10.0,
                             *(torch.as_tensor(f[n]) for n in _TURB), **kw)
    _compare(got, ref)


def test_an05_scalar_roughness_regimes_match_jax():
    """rough_leng_tq across the three regimes of the roughness Reynolds
    number and the gap (2.49999, 2.5) where every mask is 0 and z0t = z0q =
    z0 (the reference's 0.5+SIGN masks)."""
    nua = 1.4e-5
    re = np.concatenate([[0.135, 0.1350001, 2.499995, 2.49999, 2.5, 3.0],
                         np.geomspace(1e-3, 50.0, 60)])
    z0 = np.full(re.size, 1e-3)
    us = re * nua / z0
    got = tice.rough_leng_tq(*map(torch.as_tensor, (z0, us, np.full(re.size,
                                                                    nua))))
    ref = jice.rough_leng_tq(*map(jnp.asarray, (z0, us, np.full(re.size,
                                                                nua))))
    for name, g, r in zip(("z0t", "z0q"), got, ref):
        _close(name, g.numpy(), r)
    gap = (re > 2.49999) & (re < 2.5)
    assert gap.any()
    np.testing.assert_array_equal(got[0].numpy()[gap], z0[gap])
    _close("z0", tice.rough_leng_m(torch.as_tensor(us),
                                   torch.full((re.size,), nua,
                                              dtype=torch.float64)).numpy(),
           jice.rough_leng_m(jnp.asarray(us), jnp.full(re.size, nua)))


def test_reference_is_reproducible_here():
    """The precedent for the iterated algorithms: aerobulk_tpu's own eager
    and jit AN05, BEST and EASY agree at rtol 1e-12 on every field of the
    inputs of this file but EASY's q_zu, which differs by a relative 4.8e-12
    at one point where q_zu nears its MAX(., 0) clamp (4e-16 of max|q_zu|,
    inside atol 1e-12 * max|ref|).  The port holds the eager evaluation at
    rtol 1e-12 on every field (test_turb_ice_matches_jax), so it takes no
    exception."""
    f = _turb_inputs(8)
    args = [jnp.asarray(f[n]) for n in _TURB]
    for fn in (jice.turb_ice_an05, jice.turb_ice_best, jice.turb_ice_easy):
        eager = fn(2.0, 10.0, *args)
        jit = jax.jit(functools.partial(fn, 2.0, 10.0))(*args)
        for name, e, j in zip(eager._fields, eager, jit):
            _close(name, np.asarray(e), np.asarray(j),
                   near_zero=_NEAR_ZERO + ("q_zu",))
    got = tice.turb_ice_easy(2.0, 10.0,
                             *(torch.as_tensor(f[n]) for n in _TURB))
    _close("q_zu", got.q_zu.numpy(), jice.turb_ice_easy(2.0, 10.0,
                                                         *args).q_zu)


# ---------------------------------------------------------------------------
# api.flux_step_ice and api.flux_step_mixed
# ---------------------------------------------------------------------------

SHAPE = (6, 32)
_STEP = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")
_MIXED = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")


def _forcing(humidity, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    Ts = 235.0 + 38.0 * rng.random(shape)
    t = Ts + rng.uniform(-6.0, 6.0, shape)
    hum = {"sh": 1e-4 + 3e-3 * rng.random(shape),
           "rh": 40.0 + 60.0 * rng.random(shape),
           "dp": t - 0.5 - 7.5 * rng.random(shape)}[humidity]
    frice = rng.random(shape)
    frice.flat[:2] = (0.0, 1.0)
    return dict(Ts_i=Ts, sst=271.2 + 15.0 * rng.random(shape), t_zt=t,
                hum_zt=hum, U_zu=rng.normal(0, 7, shape),
                V_zu=rng.normal(0, 7, shape),
                slp=97000.0 + 6000.0 * rng.random(shape), frice=frice)


def _assert_outputs(got, ref, diag=True):
    for name in _OUT:
        _close(name, getattr(got, name).detach().numpy(), getattr(ref, name))
    if diag:
        _compare(got.diag, ref.diag)


@pytest.mark.parametrize("humidity", ["sh", "rh", "dp"])
@pytest.mark.parametrize("algo", ICE)
def test_flux_step_ice_matches_jax(algo, humidity):
    f = _forcing(humidity, seed=ICE.index(algo))
    ref, ref_res = japi.flux_step_ice(
        algo, 2.0, 10.0, *(jnp.asarray(f[n]) for n in _STEP),
        frice=jnp.asarray(f["frice"]), humidity=humidity)
    got, got_res = tapi.flux_step_ice(
        algo, 2.0, 10.0, *(torch.as_tensor(f[n]) for n in _STEP),
        frice=torch.as_tensor(f["frice"]), humidity=humidity)
    _assert_outputs(got, ref)
    _compare(got_res, ref_res)


def test_flux_step_ice_needs_frice():
    f = _forcing("sh")
    with pytest.raises(ValueError, match="requires the ice concentration"):
        tapi.flux_step_ice("ice_lg15", 2.0, 10.0,
                           *(torch.as_tensor(f[n]) for n in _STEP))


_MIXED_CASES = ([dict(ice_algo="ice_lg15", ocean_algo=o) for o in OCEAN]
                + [dict(ice_algo=a, ocean_algo="ecmwf") for a in ICE
                   if a != "ice_lg15"]
                + [dict(simultaneous=True)])


@pytest.mark.parametrize("zt", [2.0, 10.0])
@pytest.mark.parametrize("kw", _MIXED_CASES,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_flux_step_mixed_matches_jax(kw, zt):
    """The net, ice and ocean parts of the mixed cell."""
    f = _forcing("sh", seed=40)
    ref = japi.flux_step_mixed(zt, 10.0, *(jnp.asarray(f[n]) for n in _MIXED),
                               **kw)
    got = tapi.flux_step_mixed(zt, 10.0,
                               *(torch.as_tensor(f[n]) for n in _MIXED), **kw)
    for g, r in zip(got, ref):
        _assert_outputs(g, r)


@pytest.mark.parametrize("humidity", ["rh", "dp"])
@pytest.mark.parametrize("simultaneous", [False, True])
def test_flux_step_mixed_humidity_kinds_match_jax(humidity, simultaneous):
    f = _forcing(humidity, seed=41)
    ref = japi.flux_step_mixed(2.0, 10.0,
                               *(jnp.asarray(f[n]) for n in _MIXED),
                               humidity=humidity, simultaneous=simultaneous)
    got = tapi.flux_step_mixed(2.0, 10.0,
                               *(torch.as_tensor(f[n]) for n in _MIXED),
                               humidity=humidity, simultaneous=simultaneous)
    for g, r in zip(got, ref):
        _assert_outputs(g, r)


# ---------------------------------------------------------------------------
# the plain versions of the ice and mixed kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("algo", ICE)
def test_fused_ice_step_plain_matches_jax(algo):
    """What the kernel is held to on the card, against what the Pallas
    body _ice_kernel runs (flux_step_ice, fused.py:185-190)."""
    f = _forcing("sh", seed=50)
    kw = dict(CdN=1.6e-3, ChN=1.5e-3, CeN=1.5e-3) if algo == "ice_easy" \
        else {}
    ref, _ = japi.flux_step_ice(algo, 2.0, 10.0,
                                *(jnp.asarray(f[n]) for n in _STEP),
                                frice=jnp.asarray(f["frice"]), **kw)
    got = tfused.fused_ice_step_plain(
        algo, 2.0, 10.0, *(torch.as_tensor(f[n]) for n in _STEP),
        frice=torch.as_tensor(f["frice"]), **kw)
    for name, g in zip(tfused.ICE_OUTPUTS, got):
        _close(name, g.numpy(), getattr(ref, name))


@pytest.mark.parametrize("kw", _MIXED_CASES,
                         ids=lambda kw: "-".join(map(str, kw.values())))
def test_fused_mixed_step_plain_matches_jax(kw):
    """Against what the Pallas body _mixed_kernel runs (flux_step_mixed's
    net, fused.py:106-111); Tau is the stress magnitude."""
    f = _forcing("sh", seed=51)
    ref, _, _ = japi.flux_step_mixed(2.0, 10.0,
                                     *(jnp.asarray(f[n]) for n in _MIXED),
                                     **kw)
    got = tfused.fused_mixed_step_plain(
        2.0, 10.0, *(torch.as_tensor(f[n]) for n in _MIXED), **kw)
    for name, g in zip(tfused.MIXED_OUTPUTS, got):
        _close(name, g.numpy(), getattr(ref, name))


def test_mixed_net_is_the_area_blend():
    """net = frice * ice + (1 - frice) * ocean, so frice = 0 and 1 give the
    ocean and ice fluxes exactly."""
    f = _forcing("sh", seed=52)
    net, out_i, out_w = tapi.flux_step_mixed(
        2.0, 10.0, *(torch.as_tensor(f[n]) for n in _MIXED))
    for name in ("QL", "QH", "Tau", "Evap", "T_s"):
        n, i, w = (getattr(o, name).flatten() for o in (net, out_i, out_w))
        assert n[0] == w[0] and n[1] == i[1], name


# Calm, unstable points of the config-5 forcing (bench.py's cold draw, seed
# 42; rows Ts_i, sst, t_zt, q, U, V, slp, frice) where the reference's
# solves blow up: at |U| < 0.5 m/s the LG15_IO water side (points 0-1) and
# BEST's ice side (points 2-3) give |QH| of 1e4-1e7 W/m^2.
_CALM = np.array([
    [263.564, 263.564, 260.616, 0.00228522, 0.0943879, -0.22501, 99211.8,
     0.226583],
    [253.824, 253.824, 249.29, 0.00298823, 0.287538, 0.104942, 101318.0,
     0.75258],
    [265.879, 265.879, 262.739, 0.0104075, 0.00251963, -0.132513, 98449.7,
     0.82767],
    [268.609, 268.609, 265.516, 0.00298427, -0.203979, 0.305211, 101465.0,
     0.791654]]).T


@pytest.mark.parametrize("kw,side,pts", [
    (dict(simultaneous=True), 2, [0, 1]),
    (dict(ice_algo="ice_best"), 1, [2, 3])])
def test_calm_unstable_blow_up_is_the_reference(kw, side, pts):
    """The port reproduces the reference's huge sensible heat flux at calm,
    unstable points (the fp32 'significant' points of the mixed kernel on
    the card are these points, PERF.md), at rtol 1e-12."""
    ref = japi.flux_step_mixed(2.0, 10.0, *map(jnp.asarray, _CALM), **kw)
    got = tapi.flux_step_mixed(2.0, 10.0, *map(torch.as_tensor, _CALM), **kw)
    for g, r in zip(got, ref):
        _assert_outputs(g, r)
    qh = np.abs(got[side].QH.numpy())
    assert (qh[pts] > 1e4).all(), qh


# Two fp32 "significant" points of chip_smoke.py's phases 11-12 that are
# not reference blow-ups (PERF.md §6), from the same cold draw, rows as in
# _CALM: ice_best at (554, 1095), calm (|U| = 0.21 m/s) and unstable; the
# LG15 + NCAR cell at (232, 1356).
_COND_ICE_BEST = np.array([
    271.0, 271.46823210368984, 268.92948946838374, 0.003804871304272895,
    0.20598997873371222, -0.03136428545892891, 100564.14099889813,
    0.78431159907244])
_COND_NCAR_LEADS = np.array([
    261.69264191194765, 261.69264191194765, 260.5419653531696,
    0.008575785952615135, 2.032077465307349, -6.8894735868565,
    98355.67186707408, 0.24824929804166007])


def test_calm_ice_best_point_is_conditioning():
    """Below the blow-up threshold BEST's calm, unstable solve still loses
    digits: fp64 matches JAX, but the eager fp32 step on the CPU moves
    Tau_y by over 2% (the card's kernel lands near it, its plain version
    near fp64), more than 10% of the field's median (0.049 N/m^2)."""
    x = _COND_ICE_BEST[[0, 2, 3, 4, 5, 6]]
    frice = _COND_ICE_BEST[7:]
    ref, _ = japi.flux_step_ice("ice_best", 2.0, 10.0,
                                *(jnp.asarray(v[None]) for v in x),
                                frice=jnp.asarray(frice))
    tau = {}
    for dtype in (torch.float64, torch.float32):
        got = tfused.fused_ice_step_plain(
            "ice_best", 2.0, 10.0,
            *(torch.tensor([v], dtype=dtype) for v in x),
            frice=torch.tensor(frice, dtype=dtype))
        tau[dtype] = float(got[3][0])
    np.testing.assert_allclose(tau[torch.float64], float(ref.Tau_y[0]),
                               rtol=1e-9)
    assert abs(tau[torch.float32] / tau[torch.float64] - 1.0) > 0.02
    assert abs(tau[torch.float32] - tau[torch.float64]) > 0.1 * 0.049


def test_ncar_leads_point_is_f3():
    """The LG15 + NCAR cell's point sits at NCAR's zeta = 0 switch (F3,
    ROADMAP §3): fp64 and fp32 cross it at iteration 5 with |zeta| below
    1e-5, where fp32 carries a 19-35% error, so another fp32 rounding (the
    kernel's) may take the other neutral Stanton number."""
    from aerobulk_tpu_torch.algos.ncar import turb_ncar
    sst, t, q, u, v, slp = _COND_NCAR_LEADS[1:7]
    zeta = {}
    for dtype in (torch.float64, torch.float32):
        sst_, t_, q_, u_, v_, slp_ = (torch.tensor([a], dtype=dtype)
                                      for a in (sst, t, q, u, v, slp))
        wnd = torch.sqrt(u_ * u_ + v_ * v_)
        ssq = 0.98 * tth.q_sat(sst_, slp_)
        theta = tth.theta_from_z_p0_t_q(2.0, slp_, t_, q_)
        zeta[dtype] = np.array([float(10.0 / turb_ncar(
            2.0, 10.0, sst_, theta, ssq, q_, wnd, niter=k).L)
            for k in range(1, 6)])
    z64, z32 = zeta[torch.float64], zeta[torch.float32]
    assert (z64[:4] < 0).all() and z64[4] > 0 and np.abs(z64[3:]).max() < 1e-5
    assert (np.abs(z32[3:] / z64[3:] - 1.0) > 0.15).all()


# The two BEST QL points that chip_smoke.py phases 11-12 list as fp32
# significant but not reference blow-ups (PERF.md §6), from the same cold
# draw, rows as in _CALM: (102, 211) in ice_best and in the BEST + ECMWF
# cell, (713, 427) in ice_best.  Both are calm (|U| < 0.5 m/s) and unstable,
# with |QH| over 100 times its field median while |QL| stays under 100 times
# its own.
_COND_BEST_QL = {
    "102_211": np.array([
        253.61814092027706, 253.61814092027706, 248.25617709205585,
        0.0008977822952764649, -0.1597858330521914, -0.37059436086990116,
        101237.38461974404, 0.19947122424321984]),
    "713_427": np.array([
        253.88287981433194, 253.88287981433194, 251.7780573561899,
        0.0023405862402585418, 0.07633315893930155, 0.13823868754495705,
        100587.99986543521, 0.4450430401216817])}
#: the medians of |QL| and |QH| of ice_best over the cold draw (fp64)
_BEST_MEDIAN_QL, _BEST_MEDIAN_QH = 136.78, 16.38


@pytest.mark.parametrize("point", sorted(_COND_BEST_QL))
def test_calm_ice_best_ql_points_are_conditioning(point):
    """At these points BEST's solve is on its way to blowing up (|QH| over
    100x its median) and QL, below the 100x line, depends on Ts_i and t_zt
    so steeply that rounding the two to fp32, one ulp each, moves it by more
    than 10% of its field median in fp64: any fp32 evaluation may land that
    far (the kernel lands 17.5 and 80 W/m^2 from fp64, PERF.md §6).  fp64
    matches JAX."""
    x = _COND_BEST_QL[point]

    def step(v, dtype=torch.float64):
        return tfused.fused_ice_step_plain(
            "ice_best", 2.0, 10.0,
            *(torch.tensor([a], dtype=dtype) for a in v[[0, 2, 3, 4, 5, 6]]),
            frice=torch.tensor([v[7]], dtype=dtype))

    ref, _ = japi.flux_step_ice("ice_best", 2.0, 10.0,
                                *(jnp.asarray(v[None]) for v in x[[0, 2, 3,
                                                                   4, 5, 6]]),
                                frice=jnp.asarray(x[7:]))
    got = step(x)
    for name, g in zip(tfused.ICE_OUTPUTS, got):
        np.testing.assert_allclose(float(g[0]), float(getattr(ref, name)[0]),
                                   rtol=1e-9, err_msg=name)
    ql, qh = float(got[0][0]), float(got[1][0])
    assert abs(qh) > 100.0 * _BEST_MEDIAN_QH
    assert abs(ql) < 100.0 * _BEST_MEDIAN_QL
    ulp = 2.0 ** -24
    y = x.copy()
    y[0] *= 1.0 + ulp               # Ts_i
    y[2] *= 1.0 - ulp               # t_zt
    assert abs(float(step(y)[0][0]) - ql) > 0.1 * _BEST_MEDIAN_QL
