"""Gradients of aerobulk_tpu_torch against aerobulk_tpu, fp64 on the CPU.

The port's gradients come from torch autograd through the eager step; the
reference's from ``jax.vjp`` of the same step, run without ``jax.jit``
(compiling the skin backward is what makes tests/test_grad.py's jitted
tests slow).  Inputs are drawn with numpy from a seed and given to both.

Tolerances, each stated where it is used:
  * one step, all 13 input gradients for seeded cotangents on the 10
    outputs: rtol 1e-10, atol 1e-12 * max|ref| of the field (the two
    reverse passes sum the same terms in another order; measured ~1e-13);
  * knife points, clamps and helpers at their ties: equal to JAX's
    gradient wherever both are finite (rtol 1e-6 in fp32, 1e-12 in fp64),
    finite wherever JAX's is.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu import skin as jsk
from aerobulk_tpu import stability as jsb
from aerobulk_tpu import thermo as jth
from aerobulk_tpu.kernels.fused import _jit_equiv
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import skin as tsk
from aerobulk_tpu_torch import stability as tsb
from aerobulk_tpu_torch import thermo as tth
from aerobulk_tpu_torch.kernels import fused as tfused

REPO = Path(__file__).resolve().parent.parent
SHAPE = (4, 32)
INPUTS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
          "rad_lw", "lon")
STATE = ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
OUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")


def _close_grads(got, ref, names, rtol=1e-10):
    for name, g, r in zip(names, got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.asarray(g), r, rtol=rtol,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)


# ---------------------------------------------------------------------------
# one step: all 13 input gradients
# ---------------------------------------------------------------------------

def _step_case(case, seed=7):
    """Inputs, state and isecday_utc of one step.  ``case`` names the exact
    zero or tie the step meets."""
    rng = np.random.default_rng(seed)
    sst = 285.0 + 15.0 * rng.random(SHAPE)
    x = dict(sst=sst, t_zt=sst + rng.normal(0.0, 2.0, SHAPE),
             hum_zt=0.004 + 0.012 * rng.random(SHAPE),
             U_zu=rng.normal(0.0, 6.0, SHAPE),
             V_zu=rng.normal(0.0, 6.0, SHAPE),
             slp=98000.0 + 4000.0 * rng.random(SHAPE),
             rad_sw=500.0 * rng.random(SHAPE),
             rad_lw=250.0 + 150.0 * rng.random(SHAPE),
             lon=360.0 * rng.random(SHAPE))
    # a fresh state: Hz_wl == HWL_MAX exactly, the tie of wl_coare's clamp
    st = dict(dT_wl=np.zeros(SHAPE), Hz_wl=np.full(SHAPE, tsk.HWL_MAX),
              Qnt_ac=np.zeros(SHAPE), Tau_ac=np.zeros(SHAPE))
    if case in ("built", "dawn"):
        st = dict(dT_wl=0.8 * rng.random(SHAPE),
                  Hz_wl=0.5 + 19.0 * rng.random(SHAPE),
                  Qnt_ac=1e5 + 4e5 * rng.random(SHAPE),
                  Tau_ac=200.0 * rng.random(SHAPE))
    if case == "calm_v":
        x["V_zu"] = np.zeros(SHAPE)
    elif case == "t_eq_sst":
        x["t_zt"] = x["sst"].copy()
    elif case == "night":
        x["rad_sw"] = np.zeros(SHAPE)
    elif case == "dawn":
        # local solar time 4.5-6.5 h at 12 UTC: the warm layer is reset
        x["lon"] = -115.0 + 30.0 * rng.random(SHAPE)
    cts = [rng.standard_normal(SHAPE) for _ in range(10)]
    return x, st, 43200, cts


def _jax_step_vjp(jcfg, x, st, isd, cts):
    def f(*a):
        return _jit_equiv(jcfg, (*a[:9], isd, jsk.SkinState(*a[9:])))
    args = [jnp.asarray(x[n]) for n in INPUTS] + \
        [jnp.asarray(st[n]) for n in STATE]
    _, vjp = jax.vjp(f, *args)
    ct = (tuple(map(jnp.asarray, cts[:6])),
          jsk.SkinState(*map(jnp.asarray, cts[6:])))
    return vjp(ct)


def _torch_step_grads(cfg, x, st, isd, cts):
    leaves = [torch.tensor(x[n], requires_grad=True) for n in INPUTS] + \
        [torch.tensor(st[n], requires_grad=True) for n in STATE]
    outs, state = tfused.fused_flux_step_plain(
        cfg, *leaves[:8], lon=leaves[8], isecday_utc=isd,
        skin_state=tsk.SkinState(*leaves[9:]))
    return torch.autograd.grad((*outs, *state), leaves,
                               [torch.as_tensor(c) for c in cts],
                               allow_unused=True, materialize_grads=True)


@pytest.mark.parametrize("case", ["fresh", "built", "calm_v", "t_eq_sst",
                                  "night", "dawn"])
def test_step_gradients_match_jax(case):
    """The repair of the clamp ties: with a fresh state every point meets
    ``MAX(MIN(Hz_wl, HWL_MAX), 0.1)`` at Hz_wl == HWL_MAX, where JAX
    splits the gradient 0.5/0.5 and ``torch.clamp`` passed all of it."""
    kw = dict(algo="coare3p6", niter=5, use_skin=True)
    x, st, isd, cts = _step_case(case)
    ref = _jax_step_vjp(japi.AeroBulkConfig(**kw), x, st, isd, cts)
    got = _torch_step_grads(tapi.AeroBulkConfig(**kw), x, st, isd, cts)
    _close_grads([g.numpy() for g in got], ref, INPUTS + STATE)
    if case == "dawn":
        # the reset throws the old state away: no gradient reaches it
        assert not got[9].any() and not got[11].any()


@pytest.mark.parametrize("case", ["fresh", "built", "calm_v", "t_eq_sst",
                                  "night"])
def test_ecmwf_step_gradients_match_jax(case):
    """The 13 gradients of one ECMWF + skin step (BASELINE config 4, the
    body of kernel 2's ECMWF variant) against jax.vjp of aerobulk_tpu's
    _jit_equiv, at rtol 1e-10 and atol 1e-12 * max|ref|.  A fresh ECMWF
    state has dT_wl = 0 everywhere, so wl_ecmwf's MAX(dT_wl / tcorr, 0)
    and its loop's MAX(., 0) sit on a tie, which JAX splits 0.5/0.5; the
    gradient in lon is 0 (no solar clock), in Hz_wl it is not."""
    kw = dict(algo="ecmwf", niter=5, use_skin=True)
    x, _, isd, cts = _step_case(case, seed=13)
    rng = np.random.default_rng(14)
    dT = 0.8 * rng.random(SHAPE) * (rng.random(SHAPE) > 0.3)
    st = dict(dT_wl=dT if case == "built" else np.zeros(SHAPE),
              Hz_wl=np.full(SHAPE, tsk.RD0_ECMWF), Qnt_ac=np.zeros(SHAPE),
              Tau_ac=np.zeros(SHAPE))
    ref = _jax_step_vjp(japi.AeroBulkConfig(**kw), x, st, isd, cts)
    got = _torch_step_grads(tapi.AeroBulkConfig(**kw), x, st, isd, cts)
    _close_grads([g.numpy() for g in got], ref, INPUTS + STATE)
    assert not got[8].any() and got[10].any()


@pytest.mark.parametrize("algo,use_skin", [("ecmwf", True), ("ncar", False),
                                           ("andreas", False)])
def test_other_algos_step_gradients_match_jax(algo, use_skin):
    """torch.autograd.grad of one eager flux_step against jax.vjp of
    aerobulk_tpu's, for the seeded cotangents on the six outputs (and the
    ECMWF state): rtol 1e-10, atol 1e-12 * max|ref| (this file's
    docstring).  ECMWF starts from a state with a layer at part of the
    grid, so the warm layer's gradient is not all zero."""
    x, _, _, cts = _step_case("built", seed=11)
    rng = np.random.default_rng(12)
    st = dict(dT_wl=0.8 * rng.random(SHAPE) * (rng.random(SHAPE) > 0.3),
              Hz_wl=np.full(SHAPE, 3.0), Qnt_ac=np.zeros(SHAPE),
              Tau_ac=np.zeros(SHAPE))
    kw = dict(algo=algo, niter=5, use_skin=use_skin)
    n_in = 8 + (4 if use_skin else 0)
    n_out = 6 + (4 if use_skin else 0)
    jcfg = japi.AeroBulkConfig(**kw)

    def f(*a):
        out, new = japi.flux_step(
            jcfg, *a[:6], rad_sw=a[6], rad_lw=a[7],
            skin_state=jsk.SkinState(*a[8:]) if use_skin else None)
        return tuple(getattr(out, n) for n in OUTS) + \
            (tuple(new) if use_skin else ())

    arrays = [x[n] for n in INPUTS[:8]] + [st[n] for n in STATE]
    _, vjp = jax.vjp(f, *map(jnp.asarray, arrays[:n_in]))
    ref = vjp(tuple(map(jnp.asarray, cts[:n_out])))

    leaves = [torch.tensor(a, requires_grad=True) for a in arrays[:n_in]]
    out, new = tapi.flux_step(
        tapi.AeroBulkConfig(**kw), *leaves[:6], rad_sw=leaves[6],
        rad_lw=leaves[7],
        skin_state=tsk.SkinState(*leaves[8:]) if use_skin else None)
    outs = [getattr(out, n) for n in OUTS] + (list(new) if use_skin else [])
    got = torch.autograd.grad(outs, leaves,
                              [torch.as_tensor(c) for c in cts[:n_out]],
                              allow_unused=True, materialize_grads=True)
    _close_grads([g.numpy() for g in got], ref,
                 (INPUTS[:8] + STATE)[:n_in])
    if use_skin:
        assert np.any(got[8].numpy() != 0.0)


# ---------------------------------------------------------------------------
# the helpers at their ties, against jax.grad
# ---------------------------------------------------------------------------

_TIES = {
    "maxc": (lambda x: jnp.maximum(x, 2.0), lambda x: tth.maxc(x, 2.0),
             [2.0, 1.0, 3.0]),
    "minc": (lambda x: jnp.minimum(x, 2.0), lambda x: tth.minc(x, 2.0),
             [2.0, 1.0, 3.0]),
    "max_min_nest": (lambda x: jnp.maximum(jnp.minimum(x, 20.0), 0.1),
                     lambda x: tth.maxc(tth.minc(x, 20.0), 0.1),
                     [20.0, 0.1, 5.0]),
    "absj": (jnp.abs, lambda x: tth.absj(x), [0.0, -0.0, -1.5, 2.0]),
    "fsign_pos": (lambda x: jth.fsign(x, 1.0 + 0.0 * x),
                  lambda x: tth.fsign(x, torch.ones_like(x)),
                  [0.0, -0.0, -1.5, 2.0]),
    "fsign_neg": (lambda x: jth.fsign(x, -1.0 + 0.0 * x),
                  lambda x: tth.fsign(x, -torch.ones_like(x)),
                  [0.0, -0.0, -1.5, 2.0]),
    "clip_mag": (lambda x: jth.clip_mag(x, 2.0),
                 lambda x: tth.clip_mag(x, 2.0),
                 [0.0, -0.0, 2.0, -2.0, 3.0]),
    "nonzero_delta": (lambda x: jth.nonzero_delta(x, 1e-3),
                      lambda x: tth.nonzero_delta(x, 1e-3),
                      [0.0, -0.0, 1e-3, -1e-3, 0.5]),
}


@pytest.mark.parametrize("name", sorted(_TIES))
def test_helper_gradient_at_tie_matches_jax(name):
    jf, tf, pts = _TIES[name]
    x = np.asarray(pts)
    val, ref = jax.vmap(jax.value_and_grad(jf))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got_val = tf(xt)
    (got,) = torch.autograd.grad(got_val.sum(), xt)
    # the forward keeps the sign of zero as the reference's does
    np.testing.assert_array_equal(np.signbit(got_val.detach().numpy()),
                                  np.signbit(np.asarray(val)))
    np.testing.assert_array_equal(got_val.detach().numpy(), np.asarray(val))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", sorted(_TIES))
def test_helper_jvp_at_tie_matches_jax(name):
    """Forward mode at the same points: torch.func.jvp against jax.jvp for
    seeded tangents, bit for bit (|x|' = 1 at +0 and -0, SIGN's derivative
    in its first argument, a tie's tangent split 0.5/0.5)."""
    jf, tf, pts = _TIES[name]
    x = np.asarray(pts)
    t = np.random.default_rng(3).standard_normal(x.shape)
    _, ref = jax.jvp(jf, (jnp.asarray(x),), (jnp.asarray(t),))
    _, got = torch.func.jvp(tf, (torch.tensor(x),), (torch.tensor(t),))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_helper_vmap_of_grad_matches_jax():
    """vmap(grad(.)) through absj, fsign and clip_mag (they carry a vmap
    rule): the same per-point derivatives as jax.vmap(jax.grad(.))."""
    x = np.array([0.0, -0.0, -1.5, 2.0, 3.0])
    jf = lambda v: jth.clip_mag(v, 2.0) + jnp.abs(v) * jth.fsign(
        v, -1.0 + 0.0 * v)
    tf = lambda v: tth.clip_mag(v, 2.0) + tth.absj(v) * tth.fsign(
        v, -torch.ones_like(v))
    ref = jax.vmap(jax.grad(jf))(jnp.asarray(x))
    got = torch.func.vmap(torch.func.grad(tf))(torch.tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_flux_step_hessian_matches_jax():
    """torch.func.hessian of sum(QH) in sst through the eager step (COARE
    3.6, no skin, niter=3, 5 points) against jax.hessian of aerobulk_tpu's:
    rtol 1e-10 and atol 1e-12 * max|ref|, as for one step's gradients (the
    two second-order passes sum the same terms in another order)."""
    rng = np.random.default_rng(0)
    shape = (5,)
    sst = 285.0 + 15.0 * rng.random(shape)
    rest = (sst + rng.normal(0.0, 2.0, shape),
            0.004 + 0.012 * rng.random(shape), rng.normal(0.0, 6.0, shape),
            rng.normal(0.0, 6.0, shape), 98000.0 + 4000.0 * rng.random(shape))
    kw = dict(algo="coare3p6", niter=3)
    jcfg, cfg = japi.AeroBulkConfig(**kw), tapi.AeroBulkConfig(**kw)
    ref = jax.hessian(lambda s: japi.flux_step(
        jcfg, s, *map(jnp.asarray, rest))[0].QH.sum())(jnp.asarray(sst))
    got = torch.func.hessian(lambda s: tapi.flux_step(
        cfg, s, *map(torch.as_tensor, rest))[0].QH.sum())(torch.tensor(sst))
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-12 * np.max(np.abs(ref)))
    assert np.any(ref != 0.0)


def test_jvp_after_hessian_in_one_process():
    """A hessian, then a jvp, in one fresh process: the constants that
    maxc/minc make inside a transform do not outlive it (a cached one
    failed every later jvp with an internal assert)."""
    code = (
        "import torch\n"
        "from torch.func import hessian, jvp\n"
        "from aerobulk_tpu_torch import api, thermo\n"
        "a = torch.tensor([0.5, 1.0], dtype=torch.float64)\n"
        "h = hessian(lambda v: (thermo.maxc(v, 0.777) ** 2).sum())(a)\n"
        "_, t = jvp(lambda v: thermo.maxc(v, 0.777), (a,),\n"
        "           (torch.ones_like(a),))\n"
        "assert t.tolist() == [0.0, 1.0], t\n"
        "cfg = api.AeroBulkConfig(algo='coare3p6', niter=2)\n"
        "T = lambda v: torch.full((3,), v, dtype=torch.float64)\n"
        "rest = (T(288.0), T(0.01), T(5.0), T(-2.0), T(1.0e5))\n"
        "qh = lambda s: api.flux_step(cfg, s, *rest)[0].QH\n"
        "s = torch.tensor([290.0, 291.0, 292.0], dtype=torch.float64)\n"
        "hessian(lambda v: qh(v).sum())(s)\n"
        "_, t = jvp(qh, (s,), (torch.ones_like(s),))\n"
        "g = torch.func.grad(lambda v: qh(v).sum())(s)\n"
        "assert torch.allclose(t, g, rtol=1e-12, atol=0), (t, g)\n"
        "print('ok')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


@pytest.mark.parametrize("requires_grad", [False, True])
def test_helpers_forward_is_abs_and_copysign(requires_grad):
    """absj and fsign give torch.abs's and torch.copysign's bits, the sign
    of zero and NaN included, whether or not a gradient is recorded."""
    a = torch.tensor([0.0, -0.0, 1.5, -2.0, float("nan"), float("inf")],
                     dtype=torch.float64, requires_grad=requires_grad)
    b = torch.tensor([-1.0, 1.0, -0.0, 0.0, -3.0, -1.0], dtype=torch.float64)
    for got, want in ((tth.fsign(a, b), torch.copysign(torch.abs(a), b)),
                      (tth.absj(a), torch.abs(a))):
        assert got.requires_grad == requires_grad
        got, want = got.detach().numpy(), want.detach().numpy()
        np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# knife points and clamps of tests/test_grad.py
# ---------------------------------------------------------------------------

def _finite_and_equal(got, ref, dtype, atol_frac=None):
    """Finite where ``ref`` is; equal where both are, at rtol 1e-6 (fp32)
    or 1e-12 (fp64) and an absolute floor of ``atol_frac`` (default: the
    rtol) times the largest |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    fin = np.isfinite(ref)
    assert np.isfinite(got[fin]).all(), (got, ref)
    rtol = 1e-6 if dtype == "float32" else 1e-12
    both = fin & np.isfinite(got)
    atol = (atol_frac or rtol) * np.max(np.abs(ref[both]))
    np.testing.assert_allclose(got[both], ref[both], rtol=rtol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("fn,knives", [
    ("psi_m_coare", (1.0 / 15.0, 1.0 / 10.15)),
    ("psi_h_coare", (1.0 / 15.0, 1.0 / 34.15, -1.5)),
    # the knives of tests/test_grad.py::test_psi_gradients_finite_at_branch_
    # knives for the NCAR, ECMWF, Andreas and Grachev-07 families
    ("psi_m_ncar", (1.0 / 16.0,)),
    ("psi_h_ncar", (1.0 / 16.0,)),
    ("psi_m_ecmwf", (1.0 / 16.0,)),
    ("psi_h_ecmwf", (1.0 / 16.0, -1.5)),
    ("psi_m_andreas", (1.0 / 16.0, -1.0)),
    ("psi_h_andreas", (1.0 / 16.0,)),
    ("psi_m_grachev07", (1.0 / 16.0, -1.0, -1.3)),
    ("psi_h_grachev07", (1.0 / 16.0,)),
])
def test_psi_gradients_at_knives(fn, knives, dtype):
    z = np.asarray(list(knives) + [-2.0, -1e-3, 0.0, 1e-3, 2.0], dtype)
    _, ref = jax.vmap(jax.value_and_grad(getattr(jsb, fn)))(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    (got,) = torch.autograd.grad(getattr(tsb, fn)(zt).sum(), zt)
    assert np.isfinite(np.asarray(ref)).all()
    _finite_and_equal(got.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_alpha_sw_gradient_at_clamp(dtype):
    sst = np.asarray([260.0, 269.95, 269.96, 291.6], dtype)
    _, ref = jax.vmap(jax.value_and_grad(jth.alpha_sw))(jnp.asarray(sst))
    st = torch.tensor(sst, requires_grad=True)
    val = tth.alpha_sw(st)
    (got,) = torch.autograd.grad(val.sum(), st)
    assert float(val[0].detach()) == 0.0 and float(got[0]) == 0.0
    assert float(got[-1]) > 0.0
    _finite_and_equal(got.numpy(), ref, dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cool_skin_gradient_at_ustar_floor(dtype):
    """The ustar floor (1e-4) of the cool skin, with strong cooling.  Just
    above the floor the backward pass sums terms of order usw**-4 that
    cancel to ~1e-9 of their size, so the two reverse passes agree only
    to an absolute floor: 1e-10 (fp64) and 2e-3 (fp32) of the largest
    gradient."""
    from aerobulk_tpu import constants as jc
    n = 64
    a = dict(Qsw=np.full(n, (1.0 - jc.roce_alb0) * 222.9, dtype),
             Qnsol=np.linspace(-400.0, -1.0, n).astype(dtype),
             ustar=np.concatenate([np.geomspace(1e-6, 0.5, n - 1),
                                   [1e-4]]).astype(dtype),
             sst=np.full(n, 291.6, dtype), Qlat=np.full(n, -50.0, dtype))
    order = ("Qsw", "Qnsol", "ustar", "sst", "Qlat")
    ref = jax.grad(lambda u, s: jnp.sum(jsk.cs_coare(
        a["Qsw"], a["Qnsol"], u, s, a["Qlat"])), argnums=(0, 1))(
            jnp.asarray(a["ustar"]), jnp.asarray(a["sst"]))
    t = {k: torch.tensor(a[k], requires_grad=k in ("ustar", "sst"))
         for k in order}
    got = torch.autograd.grad(tsk.cs_coare(*(t[k] for k in order)).sum(),
                              (t["ustar"], t["sst"]))
    for g, r in zip(got, ref):
        _finite_and_equal(g.numpy(), r, dtype,
                          atol_frac=2e-3 if dtype == "float32" else 1e-10)


def test_flux_gradient_matches_finite_difference():
    """d QL / d SST of one COARE 3.6 + skin step against a central
    difference (tests/test_grad.py: rtol 2e-4)."""
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    full = lambda v: torch.full((1,), v, dtype=torch.float64)

    def ql_of_sst(sst):
        out, _ = tapi.flux_step(cfg, sst, full(293.15), full(0.012),
                                full(6.0), full(0.0), full(101000.0),
                                rad_sw=full(200.0), rad_lw=full(380.0),
                                isecday_utc=43200)
        return out.QL[0]

    sst = full(295.15).requires_grad_()
    (g,) = torch.autograd.grad(ql_of_sst(sst), sst)
    eps = 1e-4
    fd = (ql_of_sst(full(295.15 + eps)) - ql_of_sst(full(295.15 - eps))) \
        / (2 * eps)
    assert np.isfinite(float(g)) and float(g) < 0.0
    np.testing.assert_allclose(float(g), float(fd), rtol=2e-4)


# ---------------------------------------------------------------------------
# the differentiable fused step on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grad_backend", ["kernel", "eager"])
def test_fused_step_gradient_on_cpu_is_the_eager_gradient(grad_backend):
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    x, st, isd, cts = _step_case("built", seed=3)
    ref = _torch_step_grads(cfg, x, st, isd, cts)
    leaves = [torch.tensor(x[n], requires_grad=True) for n in INPUTS] + \
        [torch.tensor(st[n], requires_grad=True) for n in STATE]
    launches = (tfused.LAUNCHES, tfused.GRAD_LAUNCHES)
    outs, state = tfused.fused_flux_step(
        cfg, *leaves[:8], lon=leaves[8], isecday_utc=isd,
        skin_state=tsk.SkinState(*leaves[9:]), grad_backend=grad_backend)
    got = torch.autograd.grad((*outs, *state), leaves,
                              [torch.as_tensor(c) for c in cts],
                              allow_unused=True, materialize_grads=True)
    assert (tfused.LAUNCHES, tfused.GRAD_LAUNCHES) == launches
    for name, g, r in zip(INPUTS + STATE, got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, msg=name)


@pytest.mark.parametrize("grad_backend,match", [("remat", "not ported"),
                                                ("pallas", "unknown")])
def test_fused_step_refuses_grad_backends(grad_backend, match):
    cfg = tapi.AeroBulkConfig(use_skin=True)
    x, st, isd, _ = _step_case("fresh")
    with pytest.raises(ValueError, match=match):
        tfused.fused_flux_step(cfg, *(torch.as_tensor(x[n])
                                      for n in INPUTS[:8]),
                               lon=torch.as_tensor(x["lon"]),
                               grad_backend=grad_backend)


def test_vjp_plain_is_autograd_of_the_eager_step():
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    x, st, isd, cts = _step_case("fresh", seed=9)
    ref = _torch_step_grads(cfg, x, st, isd, cts)
    got = tfused.fused_flux_step_vjp_plain(
        cfg, [torch.as_tensor(x[n]) for n in INPUTS],
        tsk.SkinState(*(torch.as_tensor(st[n]) for n in STATE)),
        [torch.as_tensor(c) for c in cts], isd)
    assert len(got) == 13
    for name, g, r in zip(INPUTS + STATE, got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0, msg=name)


# ---------------------------------------------------------------------------
# sea ice and mixed ocean+ice cells (tests/test_grad.py:306-343 checks
# finiteness; here the gradients are held to jax.vjp)
# ---------------------------------------------------------------------------

_ICE_IN = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
_MIXED_IN = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
_ICE_OUT = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")


def _ice_case(seed=13, n=64):
    """The input band of tests/test_grad.py's ice sweep, with the clamp
    ties: the wind speed exactly at wspd_thrshld_ice (0.2 m/s) at points
    0-3, the air temperature equal to the ice temperature at points 4-7."""
    rng = np.random.default_rng(seed)
    Ts = rng.uniform(230.0, 273.15, n)
    t = Ts + rng.uniform(-6.0, 6.0, n)
    U = rng.uniform(0.3, 25.0, n)
    V = rng.normal(0.0, 2.0, n)
    U[:4], V[:4] = 0.2, 0.0
    t[4:8] = Ts[4:8]
    return dict(Ts_i=Ts, sst=rng.uniform(271.2, 302.0, n), t_zt=t,
                hum_zt=rng.uniform(0.0001, 0.004, n), U_zu=U, V_zu=V,
                slp=np.full(n, 101000.0), frice=rng.uniform(0.0, 1.0, n))


@pytest.mark.parametrize("algo", ["ice_nemo", "ice_easy", "ice_an05",
                                  "ice_lu12", "ice_lg15", "ice_lg15_io",
                                  "ice_best"])
def test_ice_step_gradients_match_jax(algo):
    """torch.autograd.grad of the eager flux_step_ice against jax.vjp of
    aerobulk_tpu's, seeded cotangents on the six outputs, gradients of all
    seven inputs (Ts_i first: the ice thermodynamics' dQ/dTs): rtol 1e-10,
    atol 1e-12 * max|ref| (this file's docstring)."""
    x = _ice_case()
    rng = np.random.default_rng(14)
    cts = [rng.standard_normal(x["Ts_i"].shape) for _ in _ICE_OUT]

    def f(*a):
        out, _ = japi.flux_step_ice(algo, 2.0, 10.0, *a[:6], frice=a[6])
        return tuple(getattr(out, n) for n in _ICE_OUT)

    _, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in _ICE_IN))
    ref = vjp(tuple(map(jnp.asarray, cts)))

    leaves = [torch.tensor(x[n], requires_grad=True) for n in _ICE_IN]
    out, _ = tapi.flux_step_ice(algo, 2.0, 10.0, *leaves[:6],
                                frice=leaves[6])
    got = torch.autograd.grad([getattr(out, n) for n in _ICE_OUT], leaves,
                              [torch.as_tensor(c) for c in cts],
                              allow_unused=True, materialize_grads=True)
    for r in ref:
        assert np.isfinite(np.asarray(r)).all()
    _close_grads([g.numpy() for g in got], ref, _ICE_IN)
    assert np.any(got[0].numpy() != 0.0)


@pytest.mark.parametrize("simultaneous", [False, True])
def test_mixed_step_gradients_match_jax(simultaneous):
    """The same for flux_step_mixed's net (LG15 ice + ECMWF leads, and the
    LG15_IO solve), gradients of all eight inputs (sst: the leads'
    dQ/dSST)."""
    x = _ice_case(seed=15)
    x["t_zt"] = x["t_zt"] + 20.0 * (1 - x["frice"])
    rng = np.random.default_rng(16)
    names = ("QL", "QH", "Tau", "Evap", "T_s")
    cts = [rng.standard_normal(x["sst"].shape) for _ in names]

    def f(*a):
        net, _, _ = japi.flux_step_mixed(2.0, 10.0, *a,
                                         simultaneous=simultaneous)
        return tuple(getattr(net, n) for n in names)

    _, vjp = jax.vjp(f, *(jnp.asarray(x[n]) for n in _MIXED_IN))
    ref = vjp(tuple(map(jnp.asarray, cts)))

    leaves = [torch.tensor(x[n], requires_grad=True) for n in _MIXED_IN]
    net, _, _ = tapi.flux_step_mixed(2.0, 10.0, *leaves,
                                     simultaneous=simultaneous)
    got = torch.autograd.grad([getattr(net, n) for n in names], leaves,
                              [torch.as_tensor(c) for c in cts],
                              allow_unused=True, materialize_grads=True)
    for r in ref:
        assert np.isfinite(np.asarray(r)).all()
    _close_grads([g.numpy() for g in got], ref, _MIXED_IN)
    assert np.any(got[1].numpy() != 0.0)


def test_ice_kernel_wrappers_refuse_gradients_before_launching():
    """The CUDA wrappers of the ice and mixed kernels have no backward pass:
    an input that requires a gradient is refused before anything runs.  A
    meta tensor takes the non-CPU path of the wrapper, as a CUDA tensor
    does, without a card."""
    x = [torch.empty(4, 8, device="meta", dtype=torch.float64)
         for _ in _MIXED_IN]
    x[1].requires_grad_()
    with pytest.raises(RuntimeError, match="api.flux_step_mixed"):
        tfused.fused_mixed_step(2.0, 10.0, *x)
    x[0].requires_grad_()
    with pytest.raises(RuntimeError, match="api.flux_step_ice"):
        tfused.fused_ice_step("ice_lg15", 2.0, 10.0, x[0], *x[2:7],
                              frice=x[7])
    with torch.no_grad(), pytest.raises(ValueError, match="no kernel"):
        tfused.fused_ice_step("ice_lg15", 2.0, 10.0, x[0], *x[2:7],
                              frice=x[7])


# ---------------------------------------------------------------------------
# chip_smoke.py's fp32 gradient tail (phases 6 and 16; ROADMAP.md section 3,
# F8): grad_parity's fields and gates against an fp64 yardstick, and the
# witness of a VJP
# ---------------------------------------------------------------------------

_TAIL_N = 10000
_PLANTED = (11, 2222, 5555, 7777, 9999)


def _planted_tail():
    """Two gradients over 10,000 points, heavy-tailed (lognormal, sigma 3)
    in fp64, 1e3 at five points; the fp32 kernel and the plain fp32 VJP
    both 10x off at those points (5e-4 significant: above 1e-4 alone,
    within twice the plain's) and within 1e-6 elsewhere."""
    rng = np.random.default_rng(11)
    yard = [torch.from_numpy(rng.lognormal(0.0, 3.0, _TAIL_N)
                             * rng.choice([-1.0, 1.0], _TAIL_N))
            for _ in range(2)]
    for y in yard:
        y[list(_PLANTED)] = 1e3
    off = [y * (1.0 + 1e-6 * torch.from_numpy(rng.standard_normal(_TAIL_N)))
           for y in yard]
    for g in off:
        g[list(_PLANTED)] *= 10.0
    return yard, [g.float() for g in off], [g.float() for g in off]


def _planted_witness(yard, got, kernel_moves):
    """A witness of the planted points: the plain VJP one ulp away lands
    on the fp64 value (it moves past the threshold); the kernel's does too
    where ``kernel_moves``, else it stays where it was."""
    def witness(kind, idx):
        src = got if kind == "kernel" and not kernel_moves else yard
        w32 = [{n: g[idx] for n, g in zip(("a", "b"), src)}] * 2
        w64 = [{n: y[idx] for n, y in zip(("a", "b"), yard)}] * 3
        return w32, w64
    return witness


@pytest.mark.parametrize("kernel_moves", [True, False],
                         ids=["witnessed", "unwitnessed"])
def test_grad_parity_fp64_tail_gate(kernel_moves):
    import chip_smoke
    yard, got, plain = _planted_tail()
    kw = dict(yard=yard, witness=_planted_witness(yard, got, kernel_moves),
              listed=3)
    if not kernel_moves:
        with pytest.raises(RuntimeError, match="unwitnessed"):
            chip_smoke.grad_parity(got, plain, ("a", "b"), torch.float32,
                                   **kw)
        return
    res = chip_smoke.grad_parity(got, plain, ("a", "b"), torch.float32, **kw)
    for name in ("a", "b"):
        r = res["fields"][name]
        assert r["sig_frac"] == r["plain_sig_frac"] == 5e-4
        assert r["sig_points"] == 5 and r["witnessed_sig_points"] == 5
        assert r["unwitnessed_sig_frac"] == r["plain_unwitnessed_sig_frac"] \
            == 0.0
        assert r["max_rel_vs_fp64"] == pytest.approx(9.0, rel=1e-5)
        assert r["max_abs_vs_fp64"] == r["plain_max_abs_vs_fp64"]
        assert r["median_rel"] == 0.0          # kernel == plain here
    worst = res["worst_points"]
    assert len(worst) == 3 and all(j in _PLANTED for _, j, _, _ in worst)
    assert all(sig == ["a", "b"] and w is True for _, _, sig, w in worst)


def test_grad_parity_fp64_tail_against_plain():
    """The significant fraction alone: 5e-4 passes beside a plain VJP that
    shows as much, and fails beside a clean plain VJP (and no witness)."""
    import chip_smoke
    yard, got, plain = _planted_tail()
    chip_smoke.grad_parity(got, plain, ("a", "b"), torch.float32, yard=yard,
                           witness=_planted_witness(yard, got, True))
    clean = [y.float() for y in yard]
    with pytest.raises(RuntimeError, match="significant against fp64"):
        chip_smoke.grad_parity(got, clean, ("a", "b"), torch.float32,
                               yard=yard, gate=True,
                               witness=_planted_witness(yard, got, True))
    # ungated and unwitnessed (phase 7's series, whose sst gradient has a
    # record axis the state's gradients lack), the fractions are reported
    series = [torch.stack([g, g]) for g in (got[0], clean[0], yard[0])]
    res = chip_smoke.grad_parity([series[0], got[1]], [series[1], clean[1]],
                                 ("a", "b"), torch.float32,
                                 yard=[series[2], yard[1]], gate=False)
    assert res["fields"]["a"]["sig_frac"] == 5e-4
    assert res["fields"]["a"]["sig_points"] == 10
    assert res["fields"]["b"]["plain_sig_frac"] == 0.0
    assert "unwitnessed_sig_frac" not in res["fields"]["a"]


def test_witness_of_a_vjp():
    """``lin_witness`` of ``vjp_at`` (the plain step's autograd on the CPU)
    with ``each``: each of the 9 forcing fields one ulp down and up alone
    in fp32 (18 evaluations), and in fp64 the fp32 inputs upcast and the
    same 18 moves (19); the state and cotangents held.  Each evaluation is
    the VJP at those inputs, point by point."""
    import chip_smoke
    x, st, isd, cts = _step_case("fresh", seed=3)
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    forcing = {n: torch.tensor(x[n], dtype=torch.float32) for n in INPUTS}
    held = {**{n: torch.tensor(st[n], dtype=torch.float32) for n in STATE},
            **{n: torch.tensor(c, dtype=torch.float32)
               for n, c in zip(chip_smoke.COTANGENTS, cts)}}
    idx = torch.tensor([0, 5, 77])
    w32, w64 = chip_smoke.lin_witness(chip_smoke.vjp_at(cfg, isd, False),
                                      forcing, idx, chip_smoke.GRADS, held,
                                      each=True)
    assert len(w32) == 18 and len(w64) == 19
    assert all(v.shape == (3,) for w in w32 + w64 for v in w.values())
    vjp = chip_smoke.vjp_at(cfg, isd, False)
    pts = lambda d, dt: {n: v.reshape(-1)[idx].to(dt) for n, v in d.items()}
    # fp64 at the fp32 inputs upcast
    ref = vjp({**pts(forcing, torch.float64), **pts(held, torch.float64)})
    for n in chip_smoke.GRADS:
        assert torch.equal(w64[0][n], getattr(ref, n))
    # fp32 with t_zt (the second field) one ulp up alone
    moved = pts(forcing, torch.float32)
    moved["t_zt"] = torch.nextafter(moved["t_zt"],
                                    torch.full_like(moved["t_zt"], np.inf))
    ref = vjp({**moved, **pts(held, torch.float32)})
    for n in chip_smoke.GRADS:
        assert torch.equal(w32[3][n], getattr(ref, n))
    # together (phase 22's witness): the two moves of every field at once
    w32, w64 = chip_smoke.lin_witness(vjp, forcing, idx, chip_smoke.GRADS,
                                      held)
    assert len(w32) == 2 and len(w64) == 3
