"""aerobulk_tpu_torch.skin against aerobulk_tpu.skin, fp64 on the CPU.

Tolerance: rtol 1e-12 (docs/PARITY.md §1).  The warm-layer state is never
negative, so no absolute floor is needed; the solar clock is compared
exactly, since it decides the dawn reset.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import skin as jsk
from aerobulk_tpu_torch import skin as tsk
from aerobulk_tpu_torch.convert import skin_state_from_numpy

N = 300


def _forcing(rng):
    return dict(Qsw=800.0 * rng.random(N), Qnsol=rng.normal(-150.0, 120.0, N),
                ustar=rng.random(N), sst=271.0 + 32.0 * rng.random(N),
                Qlat=-300.0 * rng.random(N), Tau=0.5 * rng.random(N),
                lon=-720.0 + 1440.0 * rng.random(N))


def _state(rng):
    return jsk.SkinState(dT_wl=jnp.asarray(2.0 * rng.random(N)),
                         Hz_wl=jnp.asarray(0.05 + 25.0 * rng.random(N)),
                         Qnt_ac=jnp.asarray(rng.normal(2e5, 4e5, N)),
                         Tau_ac=jnp.asarray(1e3 * rng.random(N)))


def test_cs_coare_matches_jax():
    f = _forcing(np.random.default_rng(1))
    args = [f[k] for k in ("Qsw", "Qnsol", "ustar", "sst", "Qlat")]
    ref = jsk.cs_coare(*map(jnp.asarray, args))
    got = tsk.cs_coare(*map(torch.as_tensor, args))
    # dT_cs changes sign with the absorbed flux
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(np.asarray(ref))))


@pytest.mark.parametrize("isecday", [0, 12, 21600, 43200, 86399])
def test_local_solar_seconds_matches_jax(isecday):
    # longitudes below 0 and above 360, and the 15-degree hour edges
    lon = np.concatenate([np.linspace(-720.0, 720.0, 2881),
                          [-0.0, 359.9999999, 360.0, 375.0, -15.0]])
    ref = np.asarray(jsk.local_solar_seconds(jnp.asarray(lon), isecday))
    got = tsk.local_solar_seconds(torch.as_tensor(lon), isecday).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("isecday", [0, 18000, 43200])
def test_wl_coare_one_call_matches_jax(isecday):
    rng = np.random.default_rng(isecday)
    f = _forcing(rng)
    st = _state(rng)
    args = [f[k] for k in ("Qsw", "Qnsol", "Tau", "sst", "lon")]
    ref = jsk.wl_coare(*map(jnp.asarray, args[:4]), jnp.asarray(args[4]),
                       isecday, st, rdt=1800.0, gdept=1.5)
    got = tsk.wl_coare(*map(torch.as_tensor, args[:4]),
                       torch.as_tensor(args[4]), isecday,
                       skin_state_from_numpy(st, device="cpu"), rdt=1800.0,
                       gdept=1.5)
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, err_msg=name)


def test_wl_coare_sequence_builds_and_resets():
    """30 hourly records carried in both packages: every longitude passes
    through the 4-6.5 h dawn window, and the solar forcing follows the
    local day, so layers build by day and reset at dawn."""
    rng = np.random.default_rng(5)
    lon = 360.0 * rng.random(N)
    sst = 285.0 + 15.0 * rng.random(N)
    qnsol = rng.normal(-60.0, 40.0, N)
    tau = 0.02 + 0.3 * rng.random(N)
    jst = jsk.init_skin_state_coare((N,))
    tst = tsk.init_skin_state_coare((N,), device="cpu")
    built = resets = 0
    prev = np.zeros(N)
    for k in range(30):
        isd = 3600 * k
        local_h = np.mod(k + lon / 15.0, 24.0)
        qsw = 900.0 * np.clip(np.cos((local_h - 12.0) * np.pi / 12.0), 0, None)
        jst = jsk.wl_coare(jnp.asarray(qsw), jnp.asarray(qnsol),
                           jnp.asarray(tau), jnp.asarray(sst),
                           jnp.asarray(lon), isd, jst)
        tst = tsk.wl_coare(torch.as_tensor(qsw), torch.as_tensor(qnsol),
                           torch.as_tensor(tau), torch.as_tensor(sst),
                           torch.as_tensor(lon), isd, tst)
        for name, g, r in zip(tst._fields, tst, jst):
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                       err_msg=f"record {k} {name}")
        dT = tst.dT_wl.numpy()
        built += int(np.sum(dT > 0))
        resets += int(np.sum((prev > 0) & (dT == 0)))
        prev = dT
    assert built > 0 and resets > 0


# --- the ECMWF schemes (Zeng & Beljaars 2005, Takaya et al. 2010) -----------

def test_cs_ecmwf_matches_jax():
    f = _forcing(np.random.default_rng(2))
    args = [f[k] for k in ("Qsw", "Qnsol", "ustar", "sst")]
    ref = jsk.cs_ecmwf(*map(jnp.asarray, args))
    got = tsk.cs_ecmwf(*map(torch.as_tensor, args))
    # dT_cs changes sign with the absorbed flux
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12,
                               atol=1e-12 * np.max(np.abs(np.asarray(ref))))


def test_phi_takaya_matches_jax():
    """Both branches and the zeta = 0 edge of the stability function."""
    z = np.concatenate([[0.0, -0.0, 1e-12, -1e-12],
                        np.linspace(-50.0, 50.0, 1001)])
    ref = np.asarray(jsk._phi_takaya(jnp.asarray(z)))
    got = tsk._phi_takaya(torch.as_tensor(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-12)


@pytest.mark.parametrize("ustk", [False, True])
@pytest.mark.parametrize("rdt,gdept", [(3600.0, 1.0), (1800.0, 5.0)])
def test_wl_ecmwf_matches_jax(rdt, gdept, ustk):
    """One call from a state with and without a layer (dT_wl 0 at a third
    of the points), heating and cooling, gdept above and below the fixed
    3 m depth, with and without the Stokes drift."""
    rng = np.random.default_rng(int(rdt) + int(gdept))
    f = _forcing(rng)
    dT = 1.5 * rng.random(N) * (rng.random(N) > 0.33)
    st = jsk.SkinState(dT_wl=jnp.asarray(dT), Hz_wl=jnp.full(N, 3.0),
                       Qnt_ac=jnp.zeros(N), Tau_ac=jnp.zeros(N))
    kw = dict(rdt=rdt, gdept=gdept)
    us = 0.05 * rng.random(N) if ustk else None
    args = [f[k] for k in ("Qsw", "Qnsol", "ustar", "sst")]
    ref = jsk.wl_ecmwf(*map(jnp.asarray, args), st, **kw,
                       ustk=None if us is None else jnp.asarray(us))
    got = tsk.wl_ecmwf(*map(torch.as_tensor, args),
                       skin_state_from_numpy(st, device="cpu"), **kw,
                       ustk=None if us is None else torch.as_tensor(us))
    assert np.any(np.asarray(ref.dT_wl) > 0) and np.any(np.asarray(ref.dT_wl) == 0)
    for name, g, r in zip(got._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, err_msg=name)


def test_init_skin_state_ecmwf_matches_jax():
    j = jsk.init_skin_state_ecmwf((3, 4))
    t = tsk.init_skin_state_ecmwf((3, 4), device="cpu")
    for g, r in zip(t, j):
        np.testing.assert_array_equal(g.numpy(), r)


@pytest.mark.parametrize("build", [
    lambda: tsk.init_skin_state_coare((2, 3)),
    lambda: tsk.init_skin_state_ecmwf((2, 3)),
    lambda: skin_state_from_numpy(jsk.init_skin_state_coare((2, 3))),
], ids=["coare", "ecmwf", "from_numpy"])
def test_state_constructors_default_to_the_card(build, monkeypatch):
    """Without ``device`` a state is built on the CUDA device; with no GPU
    that raises rather than falling back to the CPU.  The test hides any
    card, so it never reaches for one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
