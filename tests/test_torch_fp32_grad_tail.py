"""The fp32 gradient tail of one skin step: a property of the reference's
fp32 ``jax.vjp`` that the port shares (ROADMAP.md section 3, F8), and the
rule and witness chip_smoke.py's phases 6 and 16 hold kernel 2's fp32
gradient to.  COARE 3.6 + skin here; ECMWF + skin in
tests/test_torch_fp32_grad_tail_ecmwf.py.

The points: 4,000 of bench.py's stateful forcing (``measure.grid_forcing``
on 40 x 100, seed 42) and 2,000 near-neutral, light-wind points made from
the first 2,000 of them (t_zt = sst +- geomspace(1e-4, 1, 1000) K, U_zu
in linspace(0.3, 3) permuted by ``default_rng(3)``, V_zu = 0); a fresh
state, isecday_utc 43200, cotangents from ``default_rng(7)``; all rounded
to fp32, and the fp64 gradients taken at those fp32 values upcast, so the
inputs' own rounding is not counted as error.

The reference's fp32 ``jax.vjp`` of ``aerobulk_tpu.kernels.fused.
_jit_equiv`` runs op by op, as tests/test_torch_grad.py runs it (compiling
its skin backward takes minutes), against its own fp64; the port's fp32
autograd (``fused_flux_step_vjp_plain``) against its own fp64.  Under the
gradient's rule (``measure.grad_sig``: |g32 - g64| > 0.1 max(|g64|, the
median nonzero |g64|)) both leave the same points, gradient by gradient:
the near-neutral point at 0.017 K and 1 m/s, where fp32's QH is 0 (fp64's
0.22 W/m^2): its t_zu - T_s is exactly 0, ``nonzero_delta`` floors it at
1e-9 and Ch = (u*/U) t* / dt carries d(1/dt), while 1/L agrees with fp64.
chip_smoke.py's ``fp32_check`` witnesses it: the gradient moves past the
threshold when t_zt or sst alone moves one ulp.  ``measure.field_scale``'s
rule, the forward kernels', calls 0.1-18% of these points significant
where the error is fp32's rounding at gradients thousands of times their
median.

Tolerance of the fp64 gradients against JAX's: tests/test_torch_grad.py's
(rtol 1e-10, atol 1e-12 x max|ref| per gradient).
"""

import types

import numpy as np
import pytest
import torch

import chip_smoke
from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import measure
from test_torch_grad import INPUTS, STATE, _jax_step_vjp, _torch_step_grads

ISD = 43200
GRID = (40, 100)
NSWEEP = 2000


def tail_points():
    """The 6,000 points as fp32 numpy arrays: (inputs, fresh state,
    cotangents)."""
    grid = measure.grid_forcing(GRID, "cpu", torch.float64)
    x = {n: g.numpy().ravel() for n, g in zip(INPUTS, grid)}
    sweep = {n: v[:NSWEEP].copy() for n, v in x.items()}
    dt = np.geomspace(1e-4, 1.0, NSWEEP // 2)
    sweep["t_zt"] = sweep["sst"] + np.concatenate([dt, -dt])
    sweep["U_zu"] = np.random.default_rng(3).permutation(
        np.linspace(0.3, 3.0, NSWEEP))
    sweep["V_zu"] = np.zeros(NSWEEP)
    x = {n: np.concatenate([x[n], sweep[n]]).astype(np.float32)
         for n in INPUTS}
    n = x["sst"].size
    rng = np.random.default_rng(7)
    cts = [rng.standard_normal(n).astype(np.float32) for _ in range(10)]
    return x, n, cts


def tail_case(algo):
    """The gradients of both packages in fp32 and fp64 (at the fp32 values
    upcast), by name: {"port32", "port64", "jax32", "jax64"}, and what the
    witness needs."""
    x, n, cts = tail_points()
    state = tapi.init_skin_state(
        tapi.AeroBulkConfig(algo=algo, niter=5, use_skin=True), (n,),
        torch.float32, "cpu")
    st = {k: v.numpy() for k, v in zip(STATE, state)}
    kw = dict(algo=algo, zt=2.0, zu=10.0, niter=5, use_skin=True)
    cfg = tapi.AeroBulkConfig(**kw)
    jcfg = japi.AeroBulkConfig(**kw)
    up = lambda d: {k: v.astype(np.float64) for k, v in d.items()}
    cts64 = [c.astype(np.float64) for c in cts]
    names = INPUTS + STATE
    grads = {
        "port32": _torch_step_grads(cfg, x, st, ISD, cts),
        "port64": _torch_step_grads(cfg, up(x), up(st), ISD, cts64),
        "jax32": _jax_step_vjp(jcfg, x, st, ISD, cts),
        "jax64": _jax_step_vjp(jcfg, up(x), up(st), ISD, cts64)}
    grads = {k: {nm: torch.as_tensor(np.array(g)) for nm, g in
                 zip(names, gs)} for k, gs in grads.items()}
    forcing = {k: torch.from_numpy(v) for k, v in x.items()}
    held = {**{k: torch.from_numpy(v) for k, v in st.items()},
            **{k: torch.from_numpy(c) for k, c in
               zip(chip_smoke.COTANGENTS, cts)}}
    return cfg, grads, forcing, held


def sig_sets(g32, g64):
    """The significant points under ``measure.grad_sig`` of each gradient
    that is not 0 everywhere, as sets of flat indices."""
    return {n: set(torch.nonzero(measure.grad_sig(g32[n], g64[n])[0])
                   .reshape(-1).tolist())
            for n in g64 if bool(g64[n].any())}


def witness_report(cfg, grads, forcing, held, verdicts=None):
    """chip_smoke.py's fp32_check of the port's fp32 gradient against its
    fp64 under the gradient's rule, its points witnessed by lin_witness of
    the VJP (vjp_at: the plain step on the CPU), no gate applied."""
    g32, g64 = grads["port32"], grads["port64"]
    live = [n for n in g64 if bool(g64[n].any())]
    ns = lambda g: types.SimpleNamespace(**g)
    return chip_smoke.fp32_check(
        "vjp", ns(g32), ns(g64), lambda idx: chip_smoke.lin_witness(
            chip_smoke.vjp_at(cfg, ISD, False), forcing, idx,
            chip_smoke.GRADS, held, each=True), live, "grad", {}, verdicts)


def check_fp64_is_the_references(grads):
    for name, r in grads["jax64"].items():
        r = r.numpy()
        np.testing.assert_allclose(grads["port64"][name].numpy(), r,
                                   rtol=1e-10,
                                   atol=1e-12 * np.max(np.abs(r)),
                                   err_msg=name)


@pytest.fixture(scope="module")
def coare():
    return tail_case("coare3p6")


def test_fp64_gradients_are_the_references(coare):
    check_fp64_is_the_references(coare[1])


def test_fp32_tail_is_the_references(coare):
    """The port's fp32 significant points are JAX's fp32's, gradient by
    gradient, and there are some: the reference's own tail."""
    cfg, grads, forcing, held = coare
    port = sig_sets(grads["port32"], grads["port64"])
    ref = sig_sets(grads["jax32"], grads["jax64"])
    print(f"\nsignificant points, port: {port}; JAX: {ref}")
    assert port == ref
    assert set().union(*ref.values())


def test_fp32_tail_is_witnessed(coare):
    """Every significant point of the port's fp32 gradient moves past the
    threshold within one ulp of the inputs (phases 6 and 16's witness)."""
    cfg, grads, forcing, held = coare
    sig = set().union(*sig_sets(grads["port32"], grads["port64"]).values())
    verdicts = dict.fromkeys(sig)
    report = witness_report(cfg, grads, forcing, held, verdicts)
    print(f"\nwitness: {verdicts}")
    for name, r in report.items():
        assert r["unwitnessed_sig_frac"] == 0.0, (name, r)
        assert r["witnessed_sig_points"] == r["sig_points"]
    assert verdicts and all(verdicts.values())


def test_forward_rule_counts_rounding(coare):
    """``measure.field_scale``'s rule reads fp32 rounding at the
    heavy-tailed points as significant: above 1e-2 of the points in some
    gradient, where the gradient's rule leaves one point."""
    _, grads, _, _ = coare
    frac = {}
    for name, g64 in grads["port64"].items():
        if not g64.any():
            continue
        _, thr, _ = measure.field_scale(g64)
        frac[name] = float(((grads["port32"][name].double() - g64).abs()
                            > thr).double().mean())
    print(f"\nfield_scale's significant fraction: {frac}")
    assert max(frac.values()) > 1e-2
