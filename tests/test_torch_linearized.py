"""aerobulk_tpu_torch.api.flux_step_linearized and flux_step_ice_linearized
against aerobulk_tpu.api's, fp64 on the CPU: one ``torch.func.jvp`` against
one ``jax.jvp`` (unjitted), for every field of ``_LINEARIZABLE`` and
``_ICE_LINEARIZABLE``.

Cases: COARE 3.6 + skin, ECMWF + skin and NCAR; a fresh skin state (the
``Hz_wl == HWL_MAX`` tie of COARE's warm layer, the ``dT_wl == 0`` ties of
ECMWF's) and the state one step later; a point with wind exactly 0 and one
with air and sea at one temperature.  Ice: ice_lg15, ice_nemo and ice_an05
with a point at zero wind and one at ``t_zt == Ts_i``.

Tolerance: the port's gradient bar (PERF.md §2), rtol 1e-10 and atol
1e-12 * max|ref| of each field (the derivatives cross zero); NaN masks
identical (the derivative in U or V at zero wind is 0/0 in both).  One
stated exception, COARE's Ce: its value is held at rtol 2e-11
(tests/test_torch_coare.py: the reference's own eager and jit solves differ
by up to 4.2e-12 there), and its derivative is held at 100 times that,
2e-9.  dCe = Ce (dqs/qs - d(dq)/dq) is the small difference of two terms
about 1000 times larger, so a gap of 1.3e-13 in the value (the libm
``pow`` of z0t) becomes 1.35e-10 in the derivative (measured, the worst
point of these cases; jax.jit against unjitted jax.jvp there: 6.4e-12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi

SHAPE = (3, 16)
FIELDS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
          "rad_lw")
ICE_FIELDS = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def _forcing(seed=3):
    rng = np.random.default_rng(seed)
    sst = 280.0 + 22.0 * rng.random(SHAPE)
    f = dict(sst=sst, t_zt=sst + rng.normal(0.0, 2.0, SHAPE),
             hum_zt=0.003 + 0.014 * rng.random(SHAPE),
             U_zu=rng.normal(0.0, 7.0, SHAPE), V_zu=rng.normal(0.0, 7.0, SHAPE),
             slp=97000.0 + 6000.0 * rng.random(SHAPE),
             rad_sw=800.0 * rng.random(SHAPE),
             rad_lw=250.0 + 150.0 * rng.random(SHAPE),
             lon=-180.0 + 540.0 * rng.random(SHAPE))
    f["U_zu"][0, 0] = f["V_zu"][0, 0] = 0.0       # calm
    f["t_zt"][0, 1] = f["sst"][0, 1]             # air at the sea's temperature
    return f


def _ice_forcing(seed=5):
    rng = np.random.default_rng(seed)
    Ts_i = 240.0 + 31.0 * rng.random(SHAPE)
    f = dict(Ts_i=Ts_i, t_zt=Ts_i + rng.normal(0.0, 3.0, SHAPE),
             hum_zt=2e-4 + 2e-3 * rng.random(SHAPE),
             U_zu=rng.normal(0.0, 7.0, SHAPE), V_zu=rng.normal(0.0, 7.0, SHAPE),
             slp=97000.0 + 6000.0 * rng.random(SHAPE),
             frice=0.05 + 0.9 * rng.random(SHAPE))
    f["U_zu"][0, 0] = f["V_zu"][0, 0] = 0.0
    f["t_zt"][0, 1] = f["Ts_i"][0, 1]
    return f


def _leaves(tree):
    """The tensors of a FluxOutput / FluxResult / SkinState, flattened."""
    out = []
    for x in tree:
        if isinstance(x, tuple):
            out.extend(_leaves(x))
        else:
            out.append(x)
    return out


def _names(tree):
    out = []
    for name, x in zip(tree._fields, tree):
        out.extend(_names(x) if isinstance(x, tuple) else [name])
    return out


#: rtol of the derivative of each diagnostic that is not held at 1e-10
DERIV_RTOL = {"Ce": 2e-9}


def _assert_tree(got, ref, what, rtol_of=None):
    for name, g, r in zip(_names(ref), _leaves(got), _leaves(ref)):
        r = np.asarray(r)
        g = g.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(r),
                                      err_msg=f"{what} {name}: NaN masks")
        fin = np.isfinite(r)
        scale = np.max(np.abs(r[fin])) if fin.any() else 0.0
        rtol = (rtol_of or {}).get(name, 1e-10)
        np.testing.assert_allclose(g, r, rtol=rtol, atol=1e-12 * scale,
                                   err_msg=f"{what} {name}")


def _state(algo, fresh, f):
    """A fresh skin state of both packages, or the state one step later."""
    jcfg = japi.AeroBulkConfig(algo=algo, use_skin=True)
    j0 = japi.init_skin_state(jcfg, SHAPE)
    if fresh:
        return j0, tapi.init_skin_state(tapi.AeroBulkConfig(algo=algo,
                                                            use_skin=True),
                                        SHAPE, torch.float64, "cpu")
    _, j1 = japi.flux_step(jcfg, *(jnp.asarray(f[n]) for n in FIELDS[:6]),
                           rad_sw=jnp.asarray(f["rad_sw"]),
                           rad_lw=jnp.asarray(f["rad_lw"]),
                           isecday_utc=30000, lon=jnp.asarray(f["lon"]),
                           skin_state=j0)
    return j1, type(tapi.init_skin_state(
        tapi.AeroBulkConfig(algo=algo, use_skin=True), (1,), torch.float64,
        "cpu"))(*(torch.as_tensor(np.asarray(x)) for x in j1))


CASES = [("coare3p6", True, True), ("coare3p6", True, False),
         ("ecmwf", True, True), ("ecmwf", True, False),
         ("ncar", False, True)]


@pytest.mark.parametrize("wrt", FIELDS)
@pytest.mark.parametrize("algo,skin,fresh", CASES,
                         ids=[f"{a}{'_skin' if s else ''}"
                              f"{'_fresh' if fr else '_stepped'}"
                              for a, s, fr in CASES])
def test_flux_step_linearized_matches_jax_jvp(algo, skin, fresh, wrt):
    f = _forcing()
    kw = dict(algo=algo, zt=2.0, zu=10.0, niter=5, use_skin=skin)
    extra = dict(isecday_utc=40000) if skin else {}
    if skin:
        jst, tst = _state(algo, fresh, f)
    else:
        jst, tst = None, None
    jout, jd, jnext = japi.flux_step_linearized(
        japi.AeroBulkConfig(**kw), *(jnp.asarray(f[n]) for n in FIELDS[:6]),
        rad_sw=jnp.asarray(f["rad_sw"]), rad_lw=jnp.asarray(f["rad_lw"]),
        lon=jnp.asarray(f["lon"]), skin_state=jst, wrt=wrt, **extra)
    tout, td, tnext = tapi.flux_step_linearized(
        tapi.AeroBulkConfig(**kw),
        *(torch.as_tensor(f[n]) for n in FIELDS[:6]),
        rad_sw=torch.as_tensor(f["rad_sw"]),
        rad_lw=torch.as_tensor(f["rad_lw"]), lon=torch.as_tensor(f["lon"]),
        skin_state=tst, wrt=wrt, **extra)
    _assert_tree(tout, jout, "out")
    _assert_tree(td, jd, f"d/d{wrt}",
                 DERIV_RTOL if algo.startswith("coare") else None)
    if skin:
        _assert_tree(tnext, jnext, "state")


ICE_CASES = ["ice_lg15", "ice_nemo", "ice_an05"]


@pytest.mark.parametrize("wrt", ICE_FIELDS)
@pytest.mark.parametrize("ice_algo", ICE_CASES)
def test_flux_step_ice_linearized_matches_jax_jvp(ice_algo, wrt):
    f = _ice_forcing()
    jout, jd, jres = japi.flux_step_ice_linearized(
        ice_algo, 2.0, 10.0, *(jnp.asarray(f[n]) for n in ICE_FIELDS),
        frice=jnp.asarray(f["frice"]), niter=5, wrt=wrt)
    tout, td, tres = tapi.flux_step_ice_linearized(
        ice_algo, 2.0, 10.0, *(torch.as_tensor(f[n]) for n in ICE_FIELDS),
        frice=torch.as_tensor(f["frice"]), niter=5, wrt=wrt)
    _assert_tree(tout, jout, "out")
    _assert_tree(td, jd, f"d/d{wrt}")
    _assert_tree(tres, jres, "res")


def test_linearized_is_the_jvp_of_flux_step():
    """The primal outputs equal flux_step's bitwise, and a ones tangent
    through ``torch.func.jvp`` of QH alone gives the same derivative
    bitwise (NaN at the calm point in both: d|U| is 0/0 there)."""
    f = _forcing()
    cfg = tapi.AeroBulkConfig(use_skin=True)
    args = [torch.as_tensor(f[n]) for n in FIELDS[:6]]
    kw = dict(rad_sw=torch.as_tensor(f["rad_sw"]),
              rad_lw=torch.as_tensor(f["rad_lw"]),
              lon=torch.as_tensor(f["lon"]), isecday_utc=40000,
              skin_state=tapi.init_skin_state(cfg, SHAPE, torch.float64,
                                              "cpu"))
    out, d, _ = tapi.flux_step_linearized(cfg, *args, wrt="t_zt", **kw)
    ref, _ = tapi.flux_step(cfg, *args, **kw)
    for g, r in zip(_leaves(out), _leaves(ref)):
        torch.testing.assert_close(g, r, rtol=0, atol=0, equal_nan=True)

    def f_t(t):
        return tapi.flux_step(cfg, args[0], t, *args[2:], **kw)[0].QH

    _, dqh = torch.func.jvp(f_t, (args[1],), (torch.ones_like(args[1]),))
    torch.testing.assert_close(dqh, d.QH, rtol=0, atol=0, equal_nan=True)


def test_linearized_refuses_unknown_or_missing_fields():
    f = _forcing()
    args = [torch.as_tensor(f[n]) for n in FIELDS[:6]]
    cfg = tapi.AeroBulkConfig(algo="ncar")
    with pytest.raises(ValueError, match="not one of"):
        tapi.flux_step_linearized(cfg, *args, wrt="lon")
    with pytest.raises(ValueError, match="not provided"):
        tapi.flux_step_linearized(cfg, *args, wrt="rad_sw")
    g = _ice_forcing()
    with pytest.raises(ValueError, match="not one of"):
        tapi.flux_step_ice_linearized(
            "ice_nemo", 2.0, 10.0, *(torch.as_tensor(g[n])
                                     for n in ICE_FIELDS), wrt="sst")
    # the reference raises the same errors
    with pytest.raises(ValueError, match="not one of"):
        japi.flux_step_linearized(japi.AeroBulkConfig(algo="ncar"),
                                  *(jnp.asarray(f[n]) for n in FIELDS[:6]),
                                  wrt="lon")
    with pytest.raises(ValueError, match="not provided"):
        japi.flux_step_linearized(japi.AeroBulkConfig(algo="ncar"),
                                  *(jnp.asarray(f[n]) for n in FIELDS[:6]),
                                  wrt="rad_sw")


def test_ice_fp32_jvp_nan_points_are_the_references():
    """At two near-neutral points of BASELINE config 5's cold forcing
    (chip_smoke.py phase 22's ice linearization at 721x1440), the fp32
    derivative in Ts_i is NaN while the fp64 one is finite.  The JAX
    package's fp32 ``jax.jvp`` gives NaN at the same points in the same
    outputs and diagnostics; the port reproduces it (and its fp64 matches
    the JAX fp64 at rtol 1e-10)."""
    from aerobulk_tpu_torch import measure
    pts = [(87, 141), (188, 965)]
    cold = measure.cold_forcing((721, 1440), "cpu", torch.float64)
    Ts_i, _, t, q, u, v, slp, fr = (torch.stack([x[p] for p in pts])
                                    for x in cold)
    args = (Ts_i, t, q, u, v, slp)
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        _, td, _ = tapi.flux_step_ice_linearized(
            "ice_lg15", 2.0, 10.0, *(a.to(dtype) for a in args),
            frice=fr.to(dtype), niter=5, wrt="Ts_i")
        _, jd, _ = japi.flux_step_ice_linearized(
            "ice_lg15", 2.0, 10.0,
            *(jnp.asarray(a.numpy(), jdtype) for a in args),
            frice=jnp.asarray(fr.numpy(), jdtype), niter=5, wrt="Ts_i")
        for name, g, r in zip(_names(jd), _leaves(td), _leaves(jd)):
            np.testing.assert_array_equal(
                torch.isnan(g).numpy(), np.isnan(np.asarray(r)),
                err_msg=f"{dtype} {name}")
        if dtype == torch.float64:
            assert all(torch.isfinite(x).all() for x in _leaves(td))
            _assert_tree(td, jd, "fp64 d/dTs_i")
        else:
            assert torch.isnan(td.QL).all() and torch.isnan(td.QH).all()
