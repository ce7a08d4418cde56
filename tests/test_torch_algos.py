"""The ECMWF, NCAR, Andreas and neutral-10m algorithms of aerobulk_tpu_torch
against aerobulk_tpu's, fp64 on the CPU: every FluxResult field and the
ECMWF state, the single step of all five ocean algorithms for the three
humidity kinds, and a 6-record ECMWF + skin series.

The cases cover zt == zu and zt != zu and niter in {1, 4, 5}; ECMWF runs
with its skin schemes off, the cool skin alone, the warm layer alone and
both.

Tolerance: rtol 1e-12 (docs/PARITY.md §1), with stated exceptions:
  * fields that change sign with the air-sea differences or pass through 0
    (dT_cs, dT_wl, L through one_on_L, the fluxes that cross zero) also get
    atol = 1e-12 * max|ref|, and L is compared as 1/L, as in
    tests/test_torch_coare.py;
  * none beyond those: aerobulk_tpu's own eager and jit evaluations of these
    algorithms agree to rtol 1e-12 on these inputs
    (test_reference_is_reproducible_here holds that), so no field needs
    the Ce exception of COARE.
"""

import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu import skin as jsk
from aerobulk_tpu.algos import andreas as jandreas
from aerobulk_tpu.algos import ecmwf as jecmwf
from aerobulk_tpu.algos import ncar as jncar
from aerobulk_tpu.algos.neutral_10m import turb_neutral_10m as j_n10
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch.algos import OCEAN_ALGOS
from aerobulk_tpu_torch.algos import andreas as tandreas
from aerobulk_tpu_torch.algos import ecmwf as tecmwf
from aerobulk_tpu_torch.algos import ncar as tncar
from aerobulk_tpu_torch.algos.neutral_10m import turb_neutral_10m as t_n10
from aerobulk_tpu_torch.convert import skin_state_from_numpy

N = 256
HEIGHTS_NITER = [(2.0, 1), (10.0, 1), (2.0, 4), (10.0, 4), (2.0, 5),
                 (10.0, 5)]
SKIN = [(False, False), (True, False), (False, True), (True, True)]
_NEAR_ZERO = ("dT_cs", "L", "dT_wl")
_NAMES = ("T_s", "t_zt", "q_s", "q_zt", "U_zu")


def _inputs(seed):
    """Surface and air states of either sign of the air-sea differences,
    kept off zero (Ch and Ce are ratios of them), winds from calm to storm
    (NCAR's 33 m/s branch, Andreas' RiB >= 0.15 guard at low wind)."""
    rng = np.random.default_rng(seed)
    sst = 271.0 + 32.0 * rng.random(N)
    q_s = 0.98 * (0.004 + 0.02 * rng.random(N))
    dt = rng.choice([-1.0, 1.0], N) * (1.5 + 3.0 * rng.random(N))
    U = np.concatenate([0.3 + 22.0 * rng.random(N - 16),
                        [0.0, 0.1, 0.25, 0.5, 1.0, 32.0, 33.0, 34.0, 36.0,
                         40.0, 45.0, 50.0, 0.2, 0.6, 1.5, 2.0]])
    f = dict(T_s=sst, t_zt=sst + dt, q_s=q_s,
             q_zt=q_s * (0.4 + 0.45 * rng.random(N)), U_zu=U,
             Qsw=900.0 * rng.random(N), rad_lw=250.0 + 180.0 * rng.random(N),
             slp=97000.0 + 7000.0 * rng.random(N))
    state = jsk.SkinState(dT_wl=jnp.asarray(1.5 * rng.random(N)),
                          Hz_wl=jnp.full(N, 3.0),
                          Qnt_ac=jnp.zeros(N), Tau_ac=jnp.zeros(N))
    return f, state


def _close(name, got, ref, rtol=1e-12):
    g, r = np.asarray(got), np.asarray(ref)
    if name == "L":
        g, r = 1.0 / g, 1.0 / r
    atol = 1e-12 * np.max(np.abs(r)) if name in _NEAR_ZERO else 0.0
    np.testing.assert_allclose(g, r, rtol=rtol, atol=atol, err_msg=name)


def _compare(got, ref):
    assert got._fields == ref._fields
    for name, g, r in zip(got._fields, got, ref):
        _close(name, g.numpy(), r)


@pytest.mark.parametrize("skin", SKIN, ids=lambda s: f"cs{s[0]:d}wl{s[1]:d}")
@pytest.mark.parametrize("zt,niter", HEIGHTS_NITER)
def test_turb_ecmwf_matches_jax(zt, niter, skin):
    use_cs, use_wl = skin
    f, state = _inputs(int(zt) * 10 + niter)
    kw = dict(niter=niter, use_cs=use_cs, use_wl=use_wl, rdt=1800.0,
              gdept=1.5)
    opt = ("Qsw", "rad_lw", "slp")
    ref, ref_state = jecmwf.turb_ecmwf(
        zt, 10.0, *(jnp.asarray(f[n]) for n in _NAMES),
        **{n: jnp.asarray(f[n]) for n in opt}, skin_state=state, **kw)
    got, got_state = tecmwf.turb_ecmwf(
        zt, 10.0, *(torch.as_tensor(f[n]) for n in _NAMES),
        **{n: torch.as_tensor(f[n]) for n in opt},
        skin_state=skin_state_from_numpy(state, device="cpu"), **kw)
    _compare(got, ref)
    for name, g, r in zip(got_state._fields, got_state, ref_state):
        _close("dT_wl" if name == "dT_wl" else name, g.numpy(), r)


@pytest.mark.parametrize("algo", ["ncar", "andreas"])
@pytest.mark.parametrize("zt,niter", HEIGHTS_NITER)
def test_turb_ncar_andreas_match_jax(algo, zt, niter):
    f, _ = _inputs(100 + int(zt) * 10 + niter)
    jturb = {"ncar": jncar.turb_ncar, "andreas": jandreas.turb_andreas}[algo]
    tturb = {"ncar": tncar.turb_ncar, "andreas": tandreas.turb_andreas}[algo]
    ref = jturb(zt, 10.0, *(jnp.asarray(f[n]) for n in _NAMES), niter=niter)
    got = tturb(zt, 10.0, *(torch.as_tensor(f[n]) for n in _NAMES),
                niter=niter)
    _compare(got, ref)


def test_andreas_stable_guard_is_exercised():
    """The inputs reach both sides of Andreas' RiB < 0.15 select: calm,
    stable points take u* = sqrt(Cx_min) * U."""
    f, _ = _inputs(7)
    got = tandreas.turb_andreas(2.0, 10.0,
                                *(torch.as_tensor(f[n]) for n in _NAMES))
    ratio = (got.u_star / got.Ubzu).numpy()
    assert np.any(np.isclose(ratio, 0.01, rtol=1e-12))
    assert np.any(ratio > 0.02)


U_N10 = np.concatenate([[0.0, 0.05, 0.1, 0.5, 1.0, 10.0, 18.0, 32.999, 33.0,
                         40.0], np.linspace(0.1, 45.0, 300)])


@pytest.mark.parametrize("niter", [1, 5])
@pytest.mark.parametrize("algo", list(OCEAN_ALGOS))
def test_turb_neutral_10m_matches_jax(algo, niter):
    got = t_n10(algo, torch.as_tensor(U_N10), niter=niter)
    ref = j_n10(algo, jnp.asarray(U_N10), niter=niter)
    for name, g, r in zip(("CdN10", "ChN10", "CeN10", "z0"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12,
                                   err_msg=name)


def test_turb_neutral_10m_unknown_algo():
    with pytest.raises(ValueError, match="unknown algorithm"):
        t_n10("nope", torch.ones(3, dtype=torch.float64))


def test_registry_matches_jax():
    from aerobulk_tpu.algos import OCEAN_ALGOS as J
    assert list(OCEAN_ALGOS) == list(J)
    for name, (fn, skin, solar) in OCEAN_ALGOS.items():
        assert (skin, solar) == J[name][1:]
        assert fn.__name__ == J[name][0].__name__


def test_reference_is_reproducible_here():
    """The grounds for granting no Ce exception: aerobulk_tpu's eager and
    jit turb_ecmwf / turb_ncar / turb_andreas agree at rtol 1e-12 on the
    inputs of this file."""
    f, state = _inputs(25)
    args = [jnp.asarray(f[n]) for n in _NAMES]
    opt = {n: jnp.asarray(f[n]) for n in ("Qsw", "rad_lw", "slp")}
    for fn, kw in ((jecmwf.turb_ecmwf, dict(use_cs=True, use_wl=True,
                                            skin_state=state, **opt)),
                   (jncar.turb_ncar, {}), (jandreas.turb_andreas, {})):
        eager = fn(2.0, 10.0, *args, **kw)
        jit = jax.jit(functools.partial(fn, 2.0, 10.0, **kw))(*args)
        if fn is jecmwf.turb_ecmwf:      # (FluxResult, SkinState)
            eager, jit = eager[0], jit[0]
        for name, e, j in zip(eager._fields, eager, jit):
            _close(name, np.asarray(e), np.asarray(j))


# --- flux_step: all five algorithms, three humidity kinds ---------------------

SHAPE = (6, 32)
_CROSSING = ("QH", "Tau_x", "Tau_y", "QL", "Evap")
_OUT = ("QL", "QH", "Tau", "Tau_x", "Tau_y", "Evap", "T_s", "rho_a")


def _forcing(humidity, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    sst = 280.0 + 22.0 * rng.random(shape)
    t = sst + rng.normal(0.0, 2.0, shape)
    hum = {"sh": 0.003 + 0.015 * rng.random(shape),
           "rh": 40.0 + 60.0 * rng.random(shape),
           "dp": t - 1.0 - 8.0 * rng.random(shape)}[humidity]
    return dict(sst=sst, t_zt=t, hum_zt=hum, U_zu=rng.normal(0, 7, shape),
                V_zu=rng.normal(0, 7, shape),
                slp=97000.0 + 6000.0 * rng.random(shape),
                rad_sw=800.0 * rng.random(shape),
                rad_lw=250.0 + 150.0 * rng.random(shape))


_STEP = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def _assert_outputs(got, ref, diag=True):
    for name in _OUT:
        r = np.asarray(getattr(ref, name))
        atol = 1e-12 * np.max(np.abs(r)) if name in _CROSSING else 0.0
        np.testing.assert_allclose(getattr(got, name).numpy(), r,
                                   rtol=1e-12, atol=atol, err_msg=name)
    if diag:
        for name, g, r in zip(got.diag._fields, got.diag, ref.diag):
            _close(name, g.numpy(), r)


@pytest.mark.parametrize("humidity", ["sh", "rh", "dp"])
@pytest.mark.parametrize("algo,use_skin", [
    ("coare3p0", False), ("coare3p6", False), ("ecmwf", False),
    ("ncar", False), ("andreas", False), ("ecmwf", True)])
def test_flux_step_matches_jax(algo, use_skin, humidity):
    f = _forcing(humidity, seed=list(OCEAN_ALGOS).index(algo))
    kw = dict(algo=algo, zt=2.0, zu=10.0, niter=5, use_skin=use_skin,
              humidity=humidity)
    rad = ("rad_sw", "rad_lw")
    ref, ref_state = japi.flux_step(japi.AeroBulkConfig(**kw),
                                    *(jnp.asarray(f[n]) for n in _STEP),
                                    **{n: jnp.asarray(f[n]) for n in rad})
    got, got_state = tapi.flux_step(tapi.AeroBulkConfig(**kw),
                                    *(torch.as_tensor(f[n]) for n in _STEP),
                                    **{n: torch.as_tensor(f[n]) for n in rad})
    _assert_outputs(got, ref)
    for name, g, r in zip(got_state._fields, got_state, ref_state):
        _close("dT_wl", g.numpy(), r)


def _ecmwf_skin_series_vs_looped_jax(backend):
    """6 hourly records of ECMWF + cool skin + warm layer, the state carried
    by the port's run_series(backend=...) and by a loop over aerobulk_tpu's
    flux_step: the outputs of every record and the final state."""
    nt, shape = 6, (4, 32)
    rng = np.random.default_rng(9)
    base = _forcing("sh", seed=9, shape=shape)
    sun = np.clip(np.cos((np.arange(nt) - 3.0) * np.pi / 8.0), 0.0, None)
    gust = 1.0 + 0.1 * np.sin(np.arange(nt))
    f = {k: np.stack([v * (gust[k2] if k in ("U_zu", "V_zu") else 1.0)
                      for k2 in range(nt)])
         for k, v in base.items() if k != "rad_sw"}
    f["rad_sw"] = sun[:, None, None] * 900.0 * rng.random((nt, *shape))
    cfg = dict(algo="ecmwf", zt=2.0, zu=10.0, niter=5, use_skin=True)
    jcfg = japi.AeroBulkConfig(**cfg)
    state = japi.init_skin_state(jcfg, shape)
    refs = []
    for k in range(nt):
        out, state = japi.flux_step(
            jcfg, *(jnp.asarray(f[n][k]) for n in _STEP),
            rad_sw=jnp.asarray(f["rad_sw"][k]),
            rad_lw=jnp.asarray(f["rad_lw"][k]), skin_state=state)
        refs.append(out)
    got, got_state = tapi.run_series(
        tapi.AeroBulkConfig(**cfg),
        {k: torch.as_tensor(v) for k, v in f.items()}, backend=backend)
    assert float(np.max(np.asarray(state.dT_wl))) > 0.0
    for k in range(nt):
        for name in ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s"):
            r = np.asarray(getattr(refs[k], name))
            atol = 1e-12 * np.max(np.abs(r)) if name in _CROSSING else 0.0
            np.testing.assert_allclose(getattr(got, name)[k].numpy(), r,
                                       rtol=1e-12, atol=atol,
                                       err_msg=f"{name}[{k}]")
    for name, g, r in zip(got_state._fields, got_state, state):
        _close("dT_wl", g.numpy(), r)


def test_ecmwf_skin_series_matches_looped_jax():
    _ecmwf_skin_series_vs_looped_jax("eager")


def test_fused_backend_runs_ecmwf_skin():
    """run_series(backend="fused") takes ECMWF + skin (BASELINE config 4):
    on CPU tensors each record is the kernel's plain version, held to the
    looped JAX flux_step as the eager series is."""
    _ecmwf_skin_series_vs_looped_jax("fused")


def test_ecmwf_skin_fused_step_matches_pallas_interpret():
    """One ECMWF + skin step of the port's fused_flux_step (the plain
    version, on CPU) against aerobulk_tpu's Pallas kernel in interpret
    mode, as tests/test_pallas_kernel.py runs it: that test's own rtol
    5e-7 / atol 1e-9 (the interpreted kernel uses the polynomial arctan
    and cbrt)."""
    from aerobulk_tpu.kernels import fused_flux_step as j_fused
    from aerobulk_tpu_torch.kernels import fused as tfused
    kw = dict(algo="ecmwf", niter=4, use_skin=True)
    jcfg = japi.AeroBulkConfig(**kw)
    shape = (8, 128)
    f = _forcing("sh", seed=12, shape=shape)
    rng = np.random.default_rng(12)
    state = jsk.SkinState(dT_wl=jnp.asarray(0.5 * rng.random(shape)),
                          Hz_wl=jnp.full(shape, 3.0),
                          Qnt_ac=jnp.zeros(shape), Tau_ac=jnp.zeros(shape))
    names = _STEP + ("rad_sw", "rad_lw")
    ref, ref_state = j_fused(jcfg, *(jnp.asarray(f[n]) for n in names),
                             skin_state=state, block=(8, 128),
                             interpret=True)
    got, got_state = tfused.fused_flux_step(
        tapi.AeroBulkConfig(**kw), *(torch.as_tensor(f[n]) for n in names),
        skin_state=skin_state_from_numpy(state, device="cpu"))
    for name, g, r in zip(("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
                          + got_state._fields, got + got_state,
                          ref + ref_state):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=5e-7,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("a,b", list(itertools.combinations(
    ["coare3p0", "coare3p6", "ecmwf", "ncar", "andreas"], 2)))
def test_algorithms_differ(a, b):
    """No algorithm falls back to another: each pair gives other fluxes."""
    f = {k: torch.as_tensor(v) for k, v in _forcing("sh", seed=3).items()}
    qa, _ = tapi.flux_step(tapi.AeroBulkConfig(algo=a), *(f[n] for n in _STEP))
    qb, _ = tapi.flux_step(tapi.AeroBulkConfig(algo=b), *(f[n] for n in _STEP))
    assert not torch.allclose(qa.QH, qb.QH, rtol=1e-6)


# ---------------------------------------------------------------------------
# F3: NCAR's stability switch at near-neutral points (chip_smoke.py phase 9)
# ---------------------------------------------------------------------------

# (sst, t_zt, hum_zt, U_zu, V_zu, slp) at the first two fp32 NCAR QH
# points of phase 9 that differ between the stateless kernel and its plain
# version by more than 10% of the field's median, (record, lat, lon) =
# (6, 177, 109) and (9, 26, 321) of bench.py's month (seed 7)
_F3_POINTS = {
    "6-177-109": (292.44400576273665, 293.58847481501493,
                  0.010558385384162306, -1.8463868669164278,
                  13.420069280459913, 98588.6863069002),
    "9-26-321": (296.4882534652238, 297.6909791793109,
                 0.011535504630517257, -1.1652031335628894,
                 -1.0917483208047412, 98900.16608598627),
}


def _ncar_zetas(thermo, turb, asarray, vals):
    """zeta_u = zu / L after each of the 5 iterations of one package's
    turb_ncar (zt = 2, zu = 10) at one point, its inputs computed by the
    same package's thermo as flux_step computes them."""
    sst, t, q, u, v, slp = (asarray([x]) for x in vals)
    wnd = (u * u + v * v) ** 0.5
    ssq = 0.98 * thermo.q_sat(sst, slp)
    theta = thermo.theta_from_z_p0_t_q(2.0, slp, t, q)
    return [float(10.0 / np.asarray(turb(2.0, 10.0, sst, theta, ssq, q, wnd,
                                         niter=k).L)[0])
            for k in range(1, 6)]


@pytest.mark.parametrize("point", sorted(_F3_POINTS))
def test_ncar_stability_flip_is_conditioning(point):
    """F3's root cause: at these near-neutral points NCAR's loop crosses
    zeta = 0 from one iteration to the next, and at one iteration the
    buoyancy flux is below what fp32 resolves, so fp32 roundings (the
    eager order on the CPU, the card's plain version, the kernel's FMA
    contraction) may land on either side of the switch of the neutral
    Stanton number (18 or 32.7).  fp64 in both packages lands on one side
    at every iteration; fp32 either lands on the other (9-26-321, iteration
    4) or carries an error as large as zeta itself (6-177-109, iteration
    1), so another fp32 rounding flips it, as the kernel does on the card."""
    from aerobulk_tpu import thermo as jthermo
    from aerobulk_tpu_torch import thermo as tthermo
    vals = _F3_POINTS[point]
    z64 = _ncar_zetas(tthermo, tncar.turb_ncar,
                      lambda a: torch.tensor(a, dtype=torch.float64), vals)
    z32 = _ncar_zetas(tthermo, tncar.turb_ncar,
                      lambda a: torch.tensor(a, dtype=torch.float32), vals)
    zj = _ncar_zetas(jthermo, jncar.turb_ncar,
                     lambda a: jnp.asarray(a, jnp.float64), vals)
    assert np.sign(z64).tolist() == np.sign(zj).tolist()
    np.testing.assert_allclose(z64, zj, rtol=1e-9)
    # the loop oscillates across zeta = 0
    assert (np.diff(np.sign(z64)) != 0).any()
    if point == "9-26-321":
        assert abs(z64[3]) < 1e-4 and z32[3] * z64[3] < 0
    else:
        assert 0 < z64[0] < 2e-7
        assert abs(z32[0] - z64[0]) > 0.2 * abs(z64[0])
