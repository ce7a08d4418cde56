"""aerobulk_tpu_torch.roofline against aerobulk_tpu.roofline, fp64 on the
CPU: the primitive chain's plain version against the JAX chain built from
aerobulk_tpu.roofline._OPS as measure_primitive_throughput builds it, the
serial-issue bound, the CPU path of the throughput measurement, and the
census lookup.  The census itself is held to the JAX graph entry by entry
in tests/test_torch_kernels.py; the kernel (primitive_chain.cu) by the
tests marked ``cuda`` there.

Tolerance: rtol 1e-13 for the chains (the same op sequence in the same
order; only libm-level rounding differs, and the maps contract).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import roofline as jr
from aerobulk_tpu_torch import roofline as tr
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
    assert tr.flux_step_counts("ecmwf", 5, True) == tr.CENSUS["skin_ecmwf"]
    assert sum(tr.flux_step_counts("ecmwf", 5, True).values()) == 6547
    assert tr.flux_step_counts(algo="ncar", use_skin=False) == \
        tr.CENSUS["ncar"]
    for kw in (dict(algo="ecmwf", niter=20), dict(algo="ncar"),
               dict(algo="foo", use_skin=False)):
        with pytest.raises(ValueError, match="aerobulk_tpu.roofline"):
            tr.flux_step_counts(**kw)
