"""The wave-state and custom Charnock closures of the port's COARE solve
(``turb_coare``'s ``wave_hs``, ``wave_cp`` and ``charn_fn``,
``closures.charn_coare3p6_wave``) and what they enable: the vmap ensemble,
the hessian through the solve and the Charnock calibration
(``aerobulk_tpu_torch.calibrate_charnock``), fp64 on the CPU.

Against the JAX package: tests/test_io_wave.py's three wave cases on the
port; the solve with waves and with a ``charn_fn`` against
``aerobulk_tpu.algos.coare.turb_coare3p6`` at rtol 1e-12 (Ce 2e-11, as
tests/test_torch_coare.py holds it); the K=4 ``torch.func.vmap`` ensemble
against the member loop at rtol 1e-12 (tests/test_transforms.py);
``torch.func.hessian`` of the calibration loss against ``jax.hessian``
(unjitted) at rtol 1e-9, and against central differences of
``torch.func.grad`` at tests/test_transforms.py's rtol 5e-5; the port's
``calibrate_charnock.fluxes`` against the JAX example's at rtol 1e-12;
and the calibration at tests/test_grad.py's abridged settings (n=256, 250
Adam steps) with its assertions.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu.algos.coare import turb_coare3p6 as jturb
from aerobulk_tpu.closures import charn_coare3p6_wave as jwave
from aerobulk_tpu_torch import calibrate_charnock as tcal
from aerobulk_tpu_torch import thermo as tth
from aerobulk_tpu_torch.algos.coare import turb_coare3p6
from aerobulk_tpu_torch.closures import charn_coare3p6_wave

REPO = Path(__file__).resolve().parent.parent


def _jax_example():
    """examples/calibrate_charnock.py of the JAX package, loaded as a
    module."""
    path = REPO / "examples" / "calibrate_charnock.py"
    spec = importlib.util.spec_from_file_location("jax_calibrate_charnock",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _t(x):
    return torch.full((3,), x, dtype=torch.float64)


def _state3():
    return (_t(295.15), _t(293.2), _t(0.0165), _t(0.012), _t(9.0))


# tests/test_io_wave.py::test_wave_charnock_changes_roughness, on the port

def test_young_steep_sea_is_rougher_than_the_wind_law():
    r0, _ = turb_coare3p6(2.0, 10.0, *_state3(), niter=10)
    r1, _ = turb_coare3p6(2.0, 10.0, *_state3(), niter=10, wave_hs=_t(3.0),
                          wave_cp=_t(6.0))
    assert float(r1.z0[0]) > float(r0.z0[0])
    assert float(r1.Cd[0]) > float(r0.Cd[0])


def test_old_swell_is_smoother_than_a_young_sea():
    r1, _ = turb_coare3p6(2.0, 10.0, *_state3(), niter=10, wave_hs=_t(3.0),
                          wave_cp=_t(6.0))
    r2, _ = turb_coare3p6(2.0, 10.0, *_state3(), niter=10, wave_hs=_t(1.0),
                          wave_cp=_t(18.0))
    assert float(r2.z0[0]) < float(r1.z0[0])


def test_wave_charnock_grows_with_us_over_cp():
    us = torch.tensor(0.3, dtype=torch.float64)
    young, old = charn_coare3p6_wave(us, 3.0, 6.0), charn_coare3p6_wave(
        us, 3.0, 18.0)
    assert float(young) > float(old)
    np.testing.assert_allclose(float(young), float(jwave(jnp.float64(0.3),
                                                         3.0, 6.0)),
                               rtol=1e-14)


# the solve against aerobulk_tpu

def _solve_inputs(n=48, seed=21):
    rng = np.random.default_rng(seed)
    sst = 280.0 + 22.0 * rng.random(n)
    slp = 98000.0 + 5000.0 * rng.random(n)
    return dict(sst=sst, theta=sst + rng.normal(0.0, 2.0, n),
                ssq=0.98 * 0.02 * rng.random(n) + 0.005,
                q=0.004 + 0.012 * rng.random(n), U=0.5 + 18.0 * rng.random(n),
                hs=0.5 + 5.0 * rng.random(n), cp=4.0 + 16.0 * rng.random(n),
                rsw=800.0 * rng.random(n), rlw=250.0 + 150.0 * rng.random(n),
                slp=slp, lon=360.0 * rng.random(n))


def _assert_result(got, ref):
    for name, g, r in zip(ref._fields, got, ref):
        r = np.asarray(r)
        rtol = 2e-11 if name == "Ce" else 1e-12
        np.testing.assert_allclose(g.numpy(), r, rtol=rtol,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)


CLOSURES = {
    "waves": lambda f, J: dict(wave_hs=J(f["hs"]), wave_cp=J(f["cp"])),
    "charn_fn": lambda f, J: dict(
        charn_fn=(lambda w: jnp.clip(0.0021 * w - 0.004, 0.0, 0.028))
        if J is jnp.asarray else tcal.linear_law(0.0021, -0.004)),
    "charn_fn_and_waves": lambda f, J: dict(
        CLOSURES["charn_fn"](f, J), **CLOSURES["waves"](f, J)),
}


@pytest.mark.parametrize("skin", [False, True])
@pytest.mark.parametrize("closure", sorted(CLOSURES))
def test_turb_coare3p6_with_closures_matches_jax(closure, skin):
    f = _solve_inputs()

    def kw(J):
        k = dict(niter=5, **CLOSURES[closure](f, J))
        if skin:
            k.update(use_cs=True, use_wl=True, Qsw=J(0.934 * f["rsw"]),
                     rad_lw=J(f["rlw"]), slp=J(f["slp"]), isecday_utc=40000,
                     lon=J(f["lon"]))
        return k

    def to_torch(x):
        return torch.as_tensor(x)

    args = ("sst", "theta", "ssq", "q", "U")
    ref, ref_state = jturb(2.0, 10.0, *(jnp.asarray(f[a]) for a in args),
                           **kw(jnp.asarray))
    got, got_state = turb_coare3p6(2.0, 10.0, *(to_torch(f[a]) for a in args),
                                   **kw(to_torch))
    _assert_result(got, ref)
    for g, r in zip(got_state, ref_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(np.asarray(r))))


def test_waves_replace_a_custom_charnock_inside_the_loop():
    """With both wave fields, the loop's Charnock is the wave law whatever
    ``charn_fn`` says; only the first guess takes ``charn_fn``, so the two
    solves differ only by what 8 iterations leave of the first guess."""
    f = _solve_inputs()
    args = [torch.as_tensor(f[a]) for a in ("sst", "theta", "ssq", "q", "U")]
    waves = dict(wave_hs=torch.as_tensor(f["hs"]),
                 wave_cp=torch.as_tensor(f["cp"]))
    a, _ = turb_coare3p6(2.0, 10.0, *args, niter=8, **waves)
    b, _ = turb_coare3p6(2.0, 10.0, *args, niter=8,
                         charn_fn=tcal.linear_law(0.0021, -0.004), **waves)
    c, _ = turb_coare3p6(2.0, 10.0, *args, niter=8,
                         charn_fn=tcal.linear_law(0.0021, -0.004))
    wave_gap = float((b.Cd - a.Cd).abs().max())
    law_gap = float((c.Cd - a.Cd).abs().max())
    assert wave_gap < 0.1 * law_gap, (wave_gap, law_gap)
    # only one of the two wave fields: the wind law
    d, _ = turb_coare3p6(2.0, 10.0, *args, niter=8,
                         wave_hs=waves["wave_hs"])
    e, _ = turb_coare3p6(2.0, 10.0, *args, niter=8)
    assert torch.equal(d.Cd, e.Cd)


# transforms through the solve (tests/test_transforms.py, on the port)

PARAMS = [[1.0e-3, 0.0], [1.7e-3, -5.0e-3], [2.4e-3, 2.0e-3],
          [1.2e-3, 8.0e-3]]


def test_vmap_charnock_ensemble_matches_loop():
    obs = tcal.make_campaign(n=128, seed=11, device="cpu")
    params = torch.tensor(PARAMS, dtype=torch.float64)     # (K, 2)

    def member(p):
        tau, qh, ql = tcal.fluxes(obs, charn_fn=tcal.linear_law(p[0], p[1]))
        return torch.stack([tau, qh, ql])

    batched = torch.func.vmap(member)(params)               # (K, 3, n)
    looped = torch.stack([member(p) for p in params])
    np.testing.assert_allclose(batched.numpy(), looped.numpy(), rtol=1e-12,
                               atol=1e-12)
    assert batched[:, 0].std(dim=0).max() > 1e-4, "members did not differ"


def test_fluxes_match_the_jax_example():
    jmod = _jax_example()
    obs = tcal.make_campaign(n=256, seed=1, device="cpu")
    jobs = {k: jnp.asarray(v.numpy()) for k, v in obs.items()}
    for law in (None, (0.0021, -0.004)):
        got = tcal.fluxes(obs, None if law is None else tcal.linear_law(*law))
        ref = jmod.fluxes(jobs, None if law is None else (
            lambda w: jnp.clip(law[0] * w + law[1], 0.0, 0.028)))
        for g, r in zip(got, ref):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                       atol=1e-12 * np.max(np.abs(r)))
    # and the campaign itself: the same numpy draws through each package's
    # thermo
    jobs_ref = jmod.make_campaign(n=256, seed=1)
    for k, v in obs.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jobs_ref[k]),
                                   rtol=1e-14, err_msg=k)


def test_hessian_through_solve_matches_jax():
    jmod = _jax_example()
    obs = tcal.make_campaign(n=64, seed=5, device="cpu")
    tau_o, qh_o, ql_o = tcal.fluxes(obs)

    def loss(p):
        tau, qh, ql = tcal.fluxes(obs, charn_fn=tcal.linear_law(p[0], p[1]))
        return ((tau - tau_o) ** 2 + (qh - qh_o) ** 2
                + (ql - ql_o) ** 2).mean()

    p0 = torch.tensor([tcal.TRUE_SLOPE, tcal.TRUE_OFFSET],
                      dtype=torch.float64)
    H = torch.func.hessian(loss)(p0).numpy()
    assert np.all(np.isfinite(H))
    np.testing.assert_allclose(H, H.T, rtol=1e-10)
    assert np.linalg.eigvalsh(H).min() > 0.0

    g = torch.func.grad(loss)
    eps = 1e-7
    for j in range(2):
        e = torch.zeros(2, dtype=torch.float64)
        e[j] = eps
        fd_col = ((g(p0 + e) - g(p0 - e)) / (2 * eps)).numpy()
        np.testing.assert_allclose(H[:, j], fd_col, rtol=5e-5,
                                   atol=1e-8 * np.abs(H).max())

    jobs = {k: jnp.asarray(v.numpy()) for k, v in obs.items()}
    jt, jq, jl = jmod.fluxes(jobs)

    def jloss(p):
        charn = lambda w: jnp.clip(p[0] * w + p[1], 0.0, 0.028)  # noqa: E731
        tau, qh, ql = jmod.fluxes(jobs, charn_fn=charn)
        return ((tau - jt) ** 2 + (qh - jq) ** 2 + (ql - jl) ** 2).mean()

    Hj = np.asarray(jax.hessian(jloss)(jnp.array([tcal.TRUE_SLOPE,
                                                  tcal.TRUE_OFFSET])))
    np.testing.assert_allclose(H, Hj, rtol=1e-9)


def test_charnock_calibration_recovers_coefficients():
    """tests/test_grad.py::test_charnock_calibration_recovers_coefficients
    (n=256, 250 steps) with torch.optim.Adam in place of optax."""
    obs = tcal.make_campaign(n=256, seed=1, device="cpu")
    target = tuple(x.detach() for x in tcal.fluxes(obs))
    slope, offset = tcal.calibrate(obs, target, steps=250, verbose=False)
    assert abs(slope - tcal.TRUE_SLOPE) < 0.05 * tcal.TRUE_SLOPE
    assert abs(offset - tcal.TRUE_OFFSET) < 1.0e-3


def test_linear_law_is_the_clipped_line():
    w = torch.linspace(0.0, 30.0, 61, dtype=torch.float64)
    np.testing.assert_array_equal(
        tcal.linear_law(0.0017, -0.005)(w).numpy(),
        np.asarray(jnp.clip(0.0017 * jnp.asarray(w.numpy()) - 0.005, 0.0,
                            0.028)))
    np.testing.assert_array_equal(tcal.linear_law(0.0017, -0.005)(w).numpy(),
                                  tth.maxc(tth.minc(0.0017 * w - 0.005, 0.028),
                                           0.0).numpy())
