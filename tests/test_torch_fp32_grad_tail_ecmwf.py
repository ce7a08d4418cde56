"""The fp32 gradient tail of one ECMWF + skin step (BASELINE config 4, the
body of kernel 2's ECMWF build) against the reference's: the points,
rules and witness of tests/test_torch_fp32_grad_tail.py (ROADMAP.md
section 3, F8).

On these points the reference's fp32 ``jax.vjp`` leaves one grid point
under the gradient's rule (``measure.grad_sig``), a point of QH near 0
(-0.066 W/m^2) where a one-ulp move of t_zt or sst alone takes the fp32
gradient back to fp64's; the port's fp32 leaves no point that JAX's does
not, and
chip_smoke.py's ``fp32_check`` witnesses each of its points.  Here
``measure.field_scale``'s rule reads 5e-4 at most, above the forward
kernels' 1e-4 gate: it counts points whose fp32 error is under 1% of
their own gradient (0.75% at most), gradients far above the median, where
the tail point is 300 times off.
"""

import pytest
import torch

from aerobulk_tpu_torch import measure
from test_torch_fp32_grad_tail import (check_fp64_is_the_references,
                                       sig_sets, tail_case, witness_report)


@pytest.fixture(scope="module")
def ecmwf():
    return tail_case("ecmwf")


def test_fp64_gradients_are_the_references(ecmwf):
    check_fp64_is_the_references(ecmwf[1])


def test_fp32_tail_is_the_references(ecmwf):
    """The port's fp32 significant points are among JAX's fp32's, gradient
    by gradient, and JAX's are not empty; each point only the port has is
    witnessed."""
    cfg, grads, forcing, held = ecmwf
    port = sig_sets(grads["port32"], grads["port64"])
    ref = sig_sets(grads["jax32"], grads["jax64"])
    print(f"\nsignificant points, port: {port}; JAX: {ref}")
    assert set().union(*ref.values())
    extra = set().union(*(port[n] - ref[n] for n in port))
    verdicts = dict.fromkeys(extra)
    witness_report(cfg, grads, forcing, held, verdicts)
    assert all(verdicts.values()), verdicts
    assert sum(map(len, port.values())) <= sum(map(len, ref.values()))


def test_fp32_tail_is_witnessed(ecmwf):
    cfg, grads, forcing, held = ecmwf
    sig = set().union(*sig_sets(grads["port32"], grads["port64"]).values())
    verdicts = dict.fromkeys(sig)
    report = witness_report(cfg, grads, forcing, held, verdicts)
    print(f"\nwitness: {verdicts}")
    for name, r in report.items():
        assert r["unwitnessed_sig_frac"] == 0.0, (name, r)
    assert verdicts and all(verdicts.values())


def test_forward_rule_counts_rounding(ecmwf):
    """``measure.field_scale``'s rule counts more points than the
    gradient's, above the forward gate of 1e-4, and the points only it
    counts are within 1% of their own gradient."""
    _, grads, _, _ = ecmwf
    frac, extra = {}, 0
    for name, g64 in grads["port64"].items():
        if not g64.any():
            continue
        g32 = grads["port32"][name].double()
        _, thr, _ = measure.field_scale(g64)
        forward = (g32 - g64).abs() > thr
        only = forward & ~measure.grad_sig(g32, g64)[0]
        frac[name] = float(forward.double().mean())
        extra += int(only.sum())
        assert bool(((g32 - g64).abs()[only]
                     <= 1e-2 * g64.abs()[only]).all()), name
    print(f"\nfield_scale's significant fraction: {frac}")
    assert max(frac.values()) > 1e-4 and extra > 0
