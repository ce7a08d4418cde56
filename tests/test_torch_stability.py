"""aerobulk_tpu_torch.stability and .closures against their aerobulk_tpu
twins, fp64 on the CPU.

Tolerance: rtol 1e-12 (docs/PARITY.md §1), plus atol = 1e-12 * max|ref|
for psi, which crosses zero at zeta = 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import closures as jcl
from aerobulk_tpu import stability as jst
from aerobulk_tpu_torch import closures as tcl
from aerobulk_tpu_torch import stability as tst

# the knife points of the COARE psi (|1 - a*zeta| = 0 inside a masked
# branch), zeta = 0 of both signs, large |zeta|, and a spread in between
ZETA = np.concatenate([
    [1 / 15, 1 / 10.15, 1 / 34.15, -1 / 15, 0.0, -0.0, 50.0, -50.0,
     1.0e3, -1.0e3, 1.0e-12, -1.0e-12],
    np.random.default_rng(3).normal(0.0, 2.0, 200),
])


def _close(got, ref, crosses_zero=False):
    ref = np.asarray(ref)
    atol = 1e-12 * np.max(np.abs(ref)) if crosses_zero else 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("name", ["psi_m_coare", "psi_h_coare"])
def test_psi_matches_jax(name):
    got = getattr(tst, name)(torch.as_tensor(ZETA))
    ref = getattr(jst, name)(jnp.asarray(ZETA))
    assert np.all(np.isfinite(got.numpy()))
    _close(got, ref, crosses_zero=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["psi_m_coare", "psi_h_coare"])
def test_psi_dtype_preserved(name, dtype):
    assert getattr(tst, name)(torch.as_tensor(ZETA, dtype=dtype)).dtype == dtype


def test_pos_or_one_matches_jax():
    a = np.array([-1.0, -0.0, 0.0, 1e-300, 2.5])
    np.testing.assert_array_equal(
        tst._pos_or_one(torch.as_tensor(a)).numpy(),
        np.asarray(jst._pos_or_one(jnp.asarray(a))))


WIND = np.concatenate([[0.0, 9.999, 10.0, 18.0, 17.999, 50.0],
                       np.linspace(0.0, 30.0, 301)])


@pytest.mark.parametrize("name", ["charn_coare3p0", "charn_coare3p6"])
def test_charnock_matches_jax(name):
    _close(getattr(tcl, name)(torch.as_tensor(WIND)),
           getattr(jcl, name)(jnp.asarray(WIND)))


@pytest.mark.parametrize("zt", [2.0, 10.0])
def test_first_guess_coare_matches_jax(zt):
    rng = np.random.default_rng(7)
    n = 256
    sst = 271.0 + 30.0 * rng.random(n)
    t_zt = sst + rng.normal(0.0, 3.0, n)
    ssq = 0.004 + 0.02 * rng.random(n)
    q_zt = 0.002 + 0.015 * rng.random(n)
    U = 0.3 + 20.0 * rng.random(n)
    charn = np.array(jcl.charn_coare3p6(jnp.asarray(U)))
    args = (sst, t_zt, ssq, q_zt, U, charn)
    ref = jcl.first_guess_coare(zt, 10.0, *map(jnp.asarray, args))
    got = tcl.first_guess_coare(zt, 10.0, *map(torch.as_tensor, args))
    assert got._fields == ref._fields
    for name, g, r in zip(got._fields, got, ref):
        # ts/qs change sign with the air-sea difference
        _close(g, r, crosses_zero=name in ("ts", "qs"))
