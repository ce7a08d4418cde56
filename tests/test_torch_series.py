"""The slice as a whole: a 48-record COARE 3.6 + skin time series in the
port, eager and through the fused backend, against aerobulk_tpu's
run_series; one fused step against the Pallas kernel run in interpret
mode; and gradients through a 6-record series against jax.vjp of the
looped JAX step.  fp64 on the CPU.

Tolerance of the series: rtol 1e-12 (docs/PARITY.md §1); QL, QH, Tau_x,
Tau_y and Evap cross zero and also get atol = 1e-12 * max|ref|, as does
the warm-layer state, which passes through 0 where the accumulated heat
cancels.

Tolerance of the series gradients (forcing and initial state): rtol 1e-10
and atol 1e-12 * max|ref| of the field (the two reverse passes sum the same
terms in another order); run_series(remat=True) against the default: rtol
1e-12, as tests/test_grad.py requires of jax.checkpoint.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu import skin as jsk
from aerobulk_tpu.kernels import fused_flux_step as j_fused
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import skin as tsk
from aerobulk_tpu_torch.convert import (config_from_reference,
                                        skin_state_from_numpy,
                                        skin_state_to_numpy)
from aerobulk_tpu_torch.kernels import fused as tfused

NT, SHAPE = 48, (8, 32)
NAMES = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw")
OUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
_CROSSING = ("QL", "QH", "Tau_x", "Tau_y", "Evap")


def _series_forcing(seed=21):
    """48 hourly records with the sun following each point's local day, so
    the warm layer builds in daylight and is reset in the dawn window."""
    rng = np.random.default_rng(seed)
    lon = -180.0 + 540.0 * rng.random(SHAPE)
    hours = np.arange(NT)[:, None, None]
    local_h = np.mod(hours + lon / 15.0, 24.0)
    sun = np.clip(np.cos((local_h - 12.0) * np.pi / 12.0), 0.0, None)
    sst = 285.0 + 15.0 * rng.random(SHAPE)
    grow = lambda a: np.broadcast_to(a, (NT,) + SHAPE).copy()
    f = dict(sst=grow(sst),
             t_zt=grow(sst + rng.normal(0.0, 1.5, SHAPE)),
             hum_zt=grow(0.004 + 0.012 * rng.random(SHAPE)),
             U_zu=rng.normal(0.0, 4.0, (NT,) + SHAPE),
             V_zu=rng.normal(0.0, 4.0, (NT,) + SHAPE),
             slp=grow(98000.0 + 4000.0 * rng.random(SHAPE)),
             rad_sw=900.0 * sun * (0.7 + 0.3 * rng.random((NT,) + SHAPE)),
             rad_lw=grow(300.0 + 100.0 * rng.random(SHAPE)))
    return f, lon


def _close(name, got, ref):
    ref = np.asarray(ref)
    atol = 1e-12 * np.max(np.abs(ref)) if name in _CROSSING else 0.0
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=atol, err_msg=name)


@pytest.fixture(scope="module")
def jax_series():
    f, lon = _series_forcing()
    cfg = japi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    state0 = japi.init_skin_state(cfg, SHAPE)
    isd = np.arange(NT) * 3600
    outs, state = japi.run_series(cfg, {k: jnp.asarray(v) for k, v in f.items()},
                                  skin_state=state0, isecday_utc=jnp.asarray(isd),
                                  lon=jnp.asarray(lon))
    return cfg, f, lon, isd, state0, outs, state


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_series_matches_jax(jax_series, backend):
    jcfg, f, lon, isd, state0, ref, ref_state = jax_series
    launches = tfused.LAUNCHES
    got, got_state = tapi.run_series(
        config_from_reference(jcfg),
        {k: torch.as_tensor(v) for k, v in f.items()},
        skin_state=skin_state_from_numpy(state0, device="cpu"),
        isecday_utc=isd,
        lon=torch.as_tensor(lon), backend=backend)
    # on CPU tensors the fused backend is the plain version: no launch
    assert tfused.LAUNCHES == launches
    for name in OUTS:
        _close(name, getattr(got, name).numpy(), getattr(ref, name))
    for name, g, r in zip(got_state._fields, skin_state_to_numpy(got_state),
                          ref_state):
        np.testing.assert_allclose(g, r, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(np.asarray(r))),
                                   err_msg=name)
    if backend == "fused":
        assert got.Tau is None and got.rho_a is None and got.diag is None
    else:
        _close("Tau", got.Tau.numpy(), ref.Tau)
        _close("rho_a", got.rho_a.numpy(), ref.rho_a)


def test_series_builds_and_resets_warm_layer(jax_series):
    """The series crosses the dawn window at every longitude."""
    dT = np.asarray(jax_series[5].diag.dT_wl)
    assert np.sum(dT > 0) > 0
    assert np.sum((dT[:-1] > 0) & (dT[1:] == 0)) > 0


def test_run_series_rejects_bad_calls():
    f, lon = _series_forcing()
    forcing = {k: torch.as_tensor(v[:2]) for k, v in f.items()}
    cfg = tapi.AeroBulkConfig(use_skin=True)
    with pytest.raises(ValueError, match="isecday_utc"):
        tapi.run_series(cfg, forcing)
    with pytest.raises(ValueError, match="backend"):
        tapi.run_series(cfg, forcing, isecday_utc=[0, 3600], backend="jit")
    with pytest.raises(ValueError, match="2 records"):
        tapi.run_series(cfg, forcing, isecday_utc=[0, 3600, 7200])
    with pytest.raises(ValueError, match="skin"):
        tapi.run_series(tapi.AeroBulkConfig(), forcing, backend="fused")


def test_fused_step_matches_pallas_interpret():
    """One step of the port's fused_flux_step (the plain version, on CPU)
    against the Pallas kernel in interpret mode, as
    tests/test_pallas_kernel.py runs it.  The interpreted kernel uses the
    polynomial arctan, hence that test's own rtol 5e-7 / atol 1e-9."""
    jcfg = japi.AeroBulkConfig(algo="coare3p6", niter=4, use_skin=True)
    shape = (8, 128)
    rng = np.random.default_rng(11)
    sst = 285.0 + 15.0 * rng.random(shape)
    args = (sst, sst + rng.normal(0, 2, shape),
            0.004 + 0.012 * rng.random(shape), rng.normal(0, 6, shape),
            rng.normal(0, 6, shape), 98000 + 4000 * rng.random(shape),
            500 * rng.random(shape), 250 + 150 * rng.random(shape))
    lon = 360 * rng.random(shape)
    state = japi.init_skin_state(jcfg, shape)
    ref, ref_state = j_fused(jcfg, *map(jnp.asarray, args),
                             lon=jnp.asarray(lon), skin_state=state,
                             block=(8, 128), interpret=True)
    got, got_state = tfused.fused_flux_step(
        config_from_reference(jcfg), *map(torch.as_tensor, args),
        lon=torch.as_tensor(lon),
        skin_state=skin_state_from_numpy(state, device="cpu"))
    for name, g, r in zip(OUTS + got_state._fields, got + got_state,
                          ref + ref_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-7,
                                   atol=1e-9, err_msg=name)


def _close_grads(got, ref, names, rtol=1e-10):
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(g), r, rtol=rtol,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# the series: gradients through the carried warm-layer state
# ---------------------------------------------------------------------------

GRAD_NT = 6
GRAD_SHAPE = (4, 32)
FORCING = NAMES
STATE = ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")


def _grad_series_case(seed=5):
    """6 hourly records around 11-16 UTC; a third of the points sit in
    the dawn window at some record, so the warm layer is reset in it."""
    rng = np.random.default_rng(seed)
    lon = np.where(rng.random(GRAD_SHAPE) < 0.35,
                   -125.0 + 40.0 * rng.random(GRAD_SHAPE),
                   360.0 * rng.random(GRAD_SHAPE))
    sst = 285.0 + 15.0 * rng.random(GRAD_SHAPE)
    grow = lambda a: np.broadcast_to(a, (GRAD_NT,) + GRAD_SHAPE).copy()
    f = dict(sst=grow(sst), t_zt=grow(sst + rng.normal(0.0, 1.5, GRAD_SHAPE)),
             hum_zt=grow(0.004 + 0.012 * rng.random(GRAD_SHAPE)),
             U_zu=rng.normal(0.0, 5.0, (GRAD_NT,) + GRAD_SHAPE),
             V_zu=rng.normal(0.0, 5.0, (GRAD_NT,) + GRAD_SHAPE),
             slp=grow(98000.0 + 4000.0 * rng.random(GRAD_SHAPE)),
             rad_sw=700.0 * rng.random((GRAD_NT,) + GRAD_SHAPE),
             rad_lw=grow(300.0 + 100.0 * rng.random(GRAD_SHAPE)))
    st = dict(dT_wl=0.5 * rng.random(GRAD_SHAPE),
              Hz_wl=np.full(GRAD_SHAPE, 20.0),
              Qnt_ac=3e5 * rng.random(GRAD_SHAPE),
              Tau_ac=100.0 * rng.random(GRAD_SHAPE))
    isd = 39600 + 3600 * np.arange(GRAD_NT)
    w = {o: rng.standard_normal((GRAD_NT,) + GRAD_SHAPE) for o in OUTS}
    return f, lon, st, isd, w


@pytest.fixture(scope="module")
def jax_series_grads():
    f, lon, st, isd, w = _grad_series_case()
    jcfg = japi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)

    def loss(forcing, state):
        total = 0.0
        for k in range(GRAD_NT):
            out, state = japi.flux_step(
                jcfg, *(forcing[n][k] for n in FORCING[:6]),
                rad_sw=forcing["rad_sw"][k], rad_lw=forcing["rad_lw"][k],
                isecday_utc=int(isd[k]), lon=jnp.asarray(lon),
                skin_state=state)
            total = total + sum(jnp.sum(w[o][k] * getattr(out, o))
                                for o in OUTS)
        return total + jnp.sum(state.Hz_wl) + jnp.sum(state.dT_wl)

    forcing = {n: jnp.asarray(f[n]) for n in FORCING}
    state = jsk.SkinState(*(jnp.asarray(st[n]) for n in STATE))
    val, (gf, gs) = jax.value_and_grad(loss, argnums=(0, 1))(forcing, state)
    return float(val), [gf[n] for n in FORCING] + list(gs)


def _torch_series_grads(backend, remat):
    f, lon, st, isd, w = _grad_series_case()
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    forcing = {n: torch.tensor(f[n], requires_grad=True) for n in FORCING}
    state0 = tsk.SkinState(*(torch.tensor(st[n], requires_grad=True)
                             for n in STATE))
    out, state = tapi.run_series(cfg, forcing, skin_state=state0,
                                 isecday_utc=isd, lon=torch.as_tensor(lon),
                                 backend=backend, remat=remat)
    loss = sum((torch.as_tensor(w[o]) * getattr(out, o)).sum() for o in OUTS)
    loss = loss + state.Hz_wl.sum() + state.dT_wl.sum()
    leaves = [forcing[n] for n in FORCING] + list(state0)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return float(loss.detach()), [g.numpy() for g in grads]


@pytest.mark.parametrize("backend,remat", [("eager", False), ("eager", True),
                                           ("fused", False), ("fused", True)])
def test_series_gradients_match_jax(jax_series_grads, backend, remat):
    """On CPU tensors the fused backend is the plain version, so autograd
    runs through it and the gradient kernel is not launched; remat has
    no effect there."""
    ref_val, ref = jax_series_grads
    launches = tfused.GRAD_LAUNCHES
    val, got = _torch_series_grads(backend, remat)
    assert tfused.GRAD_LAUNCHES == launches
    np.testing.assert_allclose(val, ref_val, rtol=1e-12)
    _close_grads(got, ref, FORCING + STATE)


def test_series_dawn_reset_happens():
    """The series above meets the reset: some point has a built warm layer
    at one record and none at the next."""
    f, lon, st, isd, _ = _grad_series_case()
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    out, _ = tapi.run_series(
        cfg, {n: torch.as_tensor(f[n]) for n in FORCING},
        skin_state=tsk.SkinState(*(torch.as_tensor(st[n]) for n in STATE)),
        isecday_utc=isd, lon=torch.as_tensor(lon))
    dT = out.diag.dT_wl.numpy()
    assert np.sum(dT > 0) > 0
    assert np.sum((dT[:-1] > 0) & (dT[1:] == 0)) > 0


def test_series_remat_gradient_equals_default():
    """remat recomputes each record's forward in the backward pass and
    must not change the gradient (rtol 1e-12, tests/test_grad.py)."""
    v0, g0 = _torch_series_grads("eager", False)
    v1, g1 = _torch_series_grads("eager", True)
    assert v0 == v1
    for name, a, b in zip(FORCING + STATE, g1, g0):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0, err_msg=name)
