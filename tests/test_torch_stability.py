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


# --- the psi families of NCAR, ECMWF, Andreas and Grachev-07 ----------------

# the regime edges and knives of each family: zeta = 0, the |1 - 16 zeta| = 0
# knife, ECMWF's caps at -50 and 5, Andreas' cap at 15 and its stable-branch
# log zeros (-3 +- sqrt(5))/2, Grachev's zeta = -1 and -1.3 poles of the
# masked branch, and a spread crossing them
ZETA_EDGES = np.concatenate([
    [0.0, -0.0, 1 / 16, -1 / 16, 1e-12, -1e-12, 5.0, 5.0 + 1e-9, -50.0,
     -50.0 - 1e-9, 15.0, 15.0 + 1e-9, (-3 + np.sqrt(5.0)) / 2, -1.0, -1.3,
     -1.5, 10.0, -10.0, 100.0, -100.0],
    np.linspace(-60.0, 20.0, 801),
    np.random.default_rng(4).normal(0.0, 3.0, 300),
])
_PSI_NEW = ["psi_m_ncar", "psi_h_ncar", "psi_m_ecmwf", "psi_h_ecmwf",
            "psi_m_andreas", "psi_h_andreas", "psi_m_grachev07",
            "psi_h_grachev07"]


@pytest.mark.parametrize("name", _PSI_NEW)
def test_new_psi_match_jax(name):
    """rtol 1e-12 with atol = 1e-12 * max|ref|: every psi crosses zero at
    zeta = 0 (docstring of this file)."""
    got = getattr(tst, name)(torch.as_tensor(ZETA_EDGES))
    ref = np.asarray(getattr(jst, name)(jnp.asarray(ZETA_EDGES)))
    assert np.all(np.isfinite(got.numpy()))
    np.testing.assert_array_equal(np.isfinite(got.numpy()), np.isfinite(ref))
    _close(got, ref, crosses_zero=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", _PSI_NEW)
def test_new_psi_dtype_preserved(name, dtype):
    z = torch.as_tensor(ZETA_EDGES, dtype=dtype)
    assert getattr(tst, name)(z).dtype == dtype


def test_ge_one_and_cap_match_jax():
    a = np.array([-1.0, -0.0, 0.0, 0.999, 1.0, 1.0 + 1e-15, 7.5])
    np.testing.assert_array_equal(tst._ge_one(torch.as_tensor(a)).numpy(),
                                  np.asarray(jst._ge_one(jnp.asarray(a))))
    z = np.array([-1e3, -50.0, -49.9, 0.0, 4.9, 5.0, 7.0])
    np.testing.assert_array_equal(
        tst._cap_zeta_ecmwf(torch.as_tensor(z)).numpy(),
        np.asarray(jst._cap_zeta_ecmwf(jnp.asarray(z))))


def test_psi_h_andreas_denominator_point():
    """At zeta = -(3 + sqrt(5))/2 (zz + sqrt(5) = 0 exactly in floating
    point), aerobulk_tpu's psi_h_andreas is NaN in the forward pass; the
    port guards the denominator too and gives the unstable branch there.
    Everywhere else, the nearest neighbours of that point included, both
    agree at rtol 1e-12."""
    z0 = -(3.0 + np.sqrt(5.0)) / 2.0
    assert 2.0 * z0 + 3.0 + np.sqrt(5.0) == 0.0
    ref = np.asarray(jst.psi_h_andreas(jnp.asarray([z0])))
    assert np.isnan(ref).all()
    got = tst.psi_h_andreas(torch.as_tensor([z0])).numpy()
    assert np.isfinite(got).all()
    unst = np.asarray(jst.psi_h_ncar(jnp.asarray([z0])))   # same unstable form
    np.testing.assert_allclose(got, unst, rtol=1e-12)
    near = np.array([np.nextafter(z0, -np.inf), np.nextafter(z0, np.inf),
                     z0 - 1e-6, z0 + 1e-6])
    _close(tst.psi_h_andreas(torch.as_tensor(near)),
           jst.psi_h_andreas(jnp.asarray(near)), crosses_zero=True)


WIND_NCAR = np.concatenate([[0.5, 1.0, 32.999, 33.0, 33.001, 50.0],
                            np.linspace(0.5, 40.0, 400)])


@pytest.mark.parametrize("name", ["cd_n10_ncar", "ce_n10_ncar",
                                  "u_star_andreas"])
def test_ncar_andreas_closures_match_jax(name):
    _close(getattr(tcl, name)(torch.as_tensor(WIND_NCAR)),
           getattr(jcl, name)(jnp.asarray(WIND_NCAR)))


@pytest.mark.parametrize("stab", [0.0, 1.0])
def test_ch_n10_ncar_matches_jax(stab):
    s = np.sqrt(np.asarray(jcl.cd_n10_ncar(jnp.asarray(WIND_NCAR))))
    st = np.full_like(s, stab)
    _close(tcl.ch_n10_ncar(torch.as_tensor(s), torch.as_tensor(st)),
           jcl.ch_n10_ncar(jnp.asarray(s), jnp.asarray(st)))
