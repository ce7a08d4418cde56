"""aerobulk_tpu_torch.roofline against aerobulk_tpu.roofline, fp64 on the
CPU: the primitive chain's plain version against the JAX chain built from
aerobulk_tpu.roofline._OPS as measure_primitive_throughput builds it, the
serial-issue floor, the CPU path of the throughput measurement, the
census at niter=20, and the plain versions of the forms kernels 1, 3, 4
and 5 run.  The tabulated census is held to the JAX graph entry by entry
in tests/test_torch_kernels.py, the port's traced one in
tests/test_torch_census.py; the kernel (primitive_chain.cu,
primitive_chain_forward.cu) by the tests marked ``cuda`` there.

Tolerance: rtol 1e-13 for the chains (the same op sequence in the same
order; only libm-level rounding differs, and the maps contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import roofline as jr
from aerobulk_tpu_torch import roofline as tr
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import roofline as tchain


def _jax_chain(x, op, K, P):
    """aerobulk_tpu's chain (roofline.py:176-184) outside a Pallas kernel,
    where math_compat.arctan is jnp.arctan."""
    f = jr._OPS[op] if op != "atan" else jr._atan_op
    lanes = [x + 0.01 * k for k in range(P)]
    for _ in range(K):
        lanes = [f(v) for v in lanes]
    acc = lanes[0]
    for v in lanes[1:]:
        acc = acc + v
    return acc


def test_classes_are_the_reference_classes():
    assert tuple(jr._OPS) == tchain.CLASSES == tuple(tchain._OPS)


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("op", tchain.CLASSES)
def test_plain_chain_matches_jax(op, P):
    x = np.random.default_rng(0).random((64, 64))
    ref = np.asarray(_jax_chain(jnp.asarray(x), op, 8, P))
    got = tr.primitive_chain_plain(torch.as_tensor(x), op, 8, P).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=0)


def test_speed_of_light_matches_jax():
    rates = {"exp": 3.1e12, "log": 1.9e12, "pow": 6.0e11, "sqrt": 3.4e12,
             "div": 2.8e12, "atan": 1.3e12, "cheap": 2.9e13}
    for key, counts in tr.CENSUS.items():
        assert tr.speed_of_light(counts, rates) == \
            jr.speed_of_light(counts, rates), key
    partial = {"cheap": 1e13, "exp": 0.0}
    counts = tr.CENSUS["skin_ecmwf"]
    assert tr.speed_of_light(counts, partial) == \
        jr.speed_of_light(counts, partial)


def test_measure_primitive_throughput_on_cpu():
    """device="cpu" times the plain chain on the host clock, as the JAX
    function times its jit path: the same keys, each rate finite and
    positive."""
    rates = tr.measure_primitive_throughput(shape=(64, 64), K=4,
                                            device="cpu")
    assert tuple(rates) == tuple(jr._OPS)
    assert all(np.isfinite(v) and v > 0 for v in rates.values())
    one = tr.measure_primitive_throughput(shape=(8, 8), K=2, P=1,
                                          dtype=torch.float64, repeats=1,
                                          device="cpu", ops=("cheap",))
    assert set(one) == {"cheap"}


def test_flux_step_counts_reads_the_census():
    """flux_step_counts traces the port's own step at any setting: at
    niter=5 its six transcendental classes are the tabulated CENSUS's (the
    JAX graph's), and at niter=20 they equal aerobulk_tpu.roofline's trace
    of the same setting (tests/test_torch_census.py holds every entry and
    the cheap class)."""
    trans = ("exp", "log", "pow", "sqrt", "div", "atan")
    for algo, skin in (("ecmwf", True), ("ncar", False)):
        got = tr.flux_step_counts(algo=algo, niter=5, use_skin=skin)
        ref = tr.CENSUS[f"skin_{algo}" if skin else algo]
        assert {c: got[c] for c in trans} == {c: ref[c] for c in trans}
    got = tr.flux_step_counts(algo="ecmwf", niter=20)
    ref = jr.flux_step_counts(algo="ecmwf", niter=20)
    assert {c: got[c] for c in trans} == {c: ref[c] for c in trans}
    with pytest.raises(ValueError, match="unknown algorithm"):
        tr.flux_step_counts(algo="foo", use_skin=False)


#: each form's definition in numpy: the function of its class
_FORM_DEFS = {"pow_pos": lambda x: (np.abs(x) + 1.1) ** 0.72,
              "div_approx": lambda x: 1.7 / (np.abs(x) + 1.2),
              "sqrt_approx": lambda x: np.sqrt(np.abs(x) + 1.1)}


@pytest.mark.parametrize("P", [1, 4])
@pytest.mark.parametrize("form", tchain.FORMS)
def test_plain_forms_match_their_definitions(form, P):
    """The plain versions of kernel 6's forms (pow_pos as exp2(0.72
    log2(.)), div_approx, sqrt_approx) are their classes' functions: fp64
    against numpy's chain of the definition at rtol 1e-13, and each form
    prices the class it stands for."""
    x = np.random.default_rng(3).random((64, 64))
    f = _FORM_DEFS[form]
    lanes = [x + 0.01 * k for k in range(P)]
    for _ in range(8):
        lanes = [f(v) for v in lanes]
    got = tr.primitive_chain_plain(torch.as_tensor(x), form, 8, P).numpy()
    np.testing.assert_allclose(got, sum(lanes), rtol=1e-13, atol=0)
    assert tchain.FORM_CLASS[form] in tchain.CLASSES
    assert tchain.plain_rtol(torch.float32, 64, P, form) == \
        tchain.FORM_ULPS[form] * (64 + P) * 2.0 ** -23
    assert tchain.instantiated(form, P, 64, torch.float64) == \
        (form == "pow_pos")


def test_chip_smoke_prices_each_build_at_its_forms():
    """Phase 18 prices a census at the forms its kernel's build runs: every
    power at pow_pos; division and square root at div_approx and
    sqrt_approx for the fp32 builds of the sources that take
    FORWARD_FLAGS (kernels 1-5, the gradient kernels too), IEEE for a
    source built without them and for fp64.  Its ceiling is the largest
    time of each transcendental class alone and of every op at twice the
    FMA ceiling, and the serial-issue floor never exceeds it."""
    import chip_smoke
    f32, f64 = torch.float32, torch.float64
    best = {}
    for dt, scale in ((f32, 1.0), (f64, 0.25)):
        for i, op in enumerate(tchain.CLASSES + tchain.FORMS):
            best[(dt, op)] = scale * (3e12 + 1e11 * i)
    for source in ("fused_step.cu", "fused_grad.cu", "fused_grad_ecmwf.cu",
                   "bulk_step.cu", "ice_step.cu", *_build.MIXED_SOURCES):
        r, forms = chip_smoke.kernel_rates(best, f32, source)
        assert forms == {"pow": "pow_pos", "div": "div_approx",
                         "sqrt": "sqrt_approx"}
        assert (r["pow"], r["div"], r["sqrt"], r["exp"]) == (
            best[(f32, "pow_pos")], best[(f32, "div_approx")],
            best[(f32, "sqrt_approx")], best[(f32, "exp")])
    for dt, source in ((f32, "primitive_chain.cu"), (f64, "fused_step.cu"),
                       (f64, "fused_grad.cu"), (f64, "primitive_chain.cu")):
        r, forms = chip_smoke.kernel_rates(best, dt, source)
        assert forms == {"pow": "pow_pos"}
        assert (r["div"], r["sqrt"]) == (best[(dt, "div")],
                                         best[(dt, "sqrt")])
    counts = tr.CENSUS["skin_coare3p6"]
    r, _ = chip_smoke.kernel_rates(best, f32, "fused_step.cu")
    top, by, terms = chip_smoke.ceiling(counts, r, 3e13)
    assert by == "fma_issue" and top == 2 * 3e13 / sum(counts.values())
    assert terms["div"] == counts["div"] / r["div"]
    top, by, _ = chip_smoke.ceiling(counts, r, 3e16)
    assert by == max(chip_smoke.TRANSCENDENTAL,
                     key=lambda c: counts[c] / r[c])
    assert tr.speed_of_light(counts, r)["points_per_s_bound"] <= top
