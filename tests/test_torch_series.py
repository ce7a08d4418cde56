"""The slice as a whole: a 48-record COARE 3.6 + skin time series in the
port, eager and through the fused backend, against aerobulk_tpu's
run_series; and one fused step against the Pallas kernel run in interpret
mode.  fp64 on the CPU.

Tolerance of the series: rtol 1e-12 (docs/PARITY.md §1); QL, QH, Tau_x,
Tau_y and Evap cross zero and also get atol = 1e-12 * max|ref|, as does
the warm-layer state, which passes through 0 where the accumulated heat
cancels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu.kernels import fused_flux_step as j_fused
from aerobulk_tpu_torch import api as tapi
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
        skin_state=skin_state_from_numpy(state0), isecday_utc=isd,
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
        lon=torch.as_tensor(lon), skin_state=skin_state_from_numpy(state))
    for name, g, r in zip(OUTS + got_state._fields, got + got_state,
                          ref + ref_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-7,
                                   atol=1e-9, err_msg=name)
