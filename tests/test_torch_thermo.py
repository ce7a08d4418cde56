"""aerobulk_tpu_torch.thermo and .math_compat against their aerobulk_tpu
twins, in fp64 on the CPU, on the same numpy inputs.

Tolerance: rtol 1e-12, the bar aerobulk_tpu meets against the scalar
oracles (docs/PARITY.md §1); both sides evaluate the same expressions in
the same order, so only libm-level rounding differs.  Outputs that cross
zero get atol = 1e-12 * max|ref| as well, since a relative bar is
meaningless at a zero crossing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import math_compat as jmc
from aerobulk_tpu import thermo as jth
from aerobulk_tpu_torch import math_compat as tmc
from aerobulk_tpu_torch import thermo as tth

N = 257


def _u(rng, lo, hi):
    return lo + (hi - lo) * rng.random(N)


def _sst(rng):
    # includes cold water below 269.95 K, where alpha_sw clamps to 0
    return np.concatenate([_u(rng, 265.0, 305.0)[:-3],
                           [268.0, 269.95, 270.1]])


def _signed(rng, scale):
    x = rng.normal(0.0, scale, N)
    x[:4] = [0.0, -0.0, 1e-13, -1e-13]
    return x


def _coefs(rng):
    alpha = jth.alpha_sw(jnp.asarray(_sst(rng)))
    return jth.skin_layer_coefs(alpha, jnp.asarray(_u(rng, 0.0, 1.0)),
                                Qlat=jnp.asarray(rng.normal(-80, 60, N)))


# name -> (inputs(rng), crosses_zero).  Python floats pass through as
# static heights; arrays go to both packages.
CASES = {
    "fsign": (lambda r: (r.normal(0, 3, N), _signed(r, 3.0)), True),
    "step": (lambda r: (_signed(r, 2.0),), False),
    "clip_mag": (lambda r: (r.normal(0, 300, N), 200.0), True),
    "nonzero_delta": (lambda r: (_signed(r, 1e-8), 1.0e-9), True),
    "pow23_pos": (lambda r: (_signed(r, 2.0),), False),
    "pot_temp": (lambda r: (_u(r, 250, 310), _u(r, 95000, 102000),
                            _u(r, 98000, 103000)), False),
    "virt_temp": (lambda r: (_u(r, 250, 310), _u(r, 0, 0.02)), False),
    "pz_from_p0_tz_qz": (lambda r: (2.0, _u(r, 98000, 103000),
                                    _u(r, 250, 310), _u(r, 0, 0.02)), False),
    "theta_from_z_p0_t_q": (lambda r: (10.0, _u(r, 98000, 103000),
                                       _u(r, 250, 310), _u(r, 0, 0.02)),
                            False),
    "visc_air": (lambda r: (_u(r, 230, 320),), False),
    "l_vap": (lambda r: (_sst(r),), False),
    "cp_air": (lambda r: (_u(r, 0, 0.03),), False),
    "one_on_l": (lambda r: (_u(r, 270, 305), _u(r, 0.001, 0.02),
                            _u(r, 0.0, 0.8), r.normal(0, 0.3, N),
                            r.normal(0, 3e-4, N)), True),
    "ri_bulk": (lambda r: (10.0, _sst(r), _u(r, 270, 305), _u(r, 0.002, 0.02),
                           _u(r, 0.001, 0.02), _u(r, 0.5, 25)), True),
    "_exp10": (lambda r: (r.normal(0, 3, N),), False),
    "e_sat": (lambda r: (_u(r, 170, 320),), False),
    "q_sat": (lambda r: (_u(r, 200, 320), _u(r, 90000, 105000)), False),
    "q_air_rh": (lambda r: (_u(r, 0, 100), _u(r, 250, 310),
                            _u(r, 90000, 105000)), False),
    "q_air_dp": (lambda r: (_u(r, 200, 305), _u(r, 90000, 105000)), False),
    "bulk_formula": (lambda r: (10.0, _sst(r), _u(r, 0.005, 0.03),
                                _u(r, 270, 305), _u(r, 0.001, 0.02),
                                _u(r, 8e-4, 2e-3), _u(r, 8e-4, 2e-3),
                                _u(r, 8e-4, 2e-3), _u(r, 0, 25), _u(r, 0.2, 25),
                                _u(r, 98000, 103000)), True),
    "qlw_net": (lambda r: (_u(r, 150, 450), _sst(r)), True),
    "update_qnsol_tau": (lambda r: (10.0, _sst(r), _u(r, 0.005, 0.03),
                                    _u(r, 270, 305), _u(r, 0.001, 0.02),
                                    _u(r, 0.01, 0.8), r.normal(0, 0.3, N),
                                    r.normal(0, 3e-4, N), _u(r, 0, 25),
                                    _u(r, 0.2, 25), _u(r, 98000, 103000),
                                    _u(r, 150, 450)), True),
    "alpha_sw": (lambda r: (_sst(r),), False),
    "skin_layer_coefs": (lambda r: (jth.alpha_sw(jnp.asarray(_sst(r))),
                                    _u(r, 0.0, 1.0), r.normal(-80, 60, N)),
                         True),
    # zQd of both signs: the cooling branch (y <= 0) and the heating one
    "delta_skin_layer_from_coefs": (lambda r: (_coefs(r), r.normal(0, 300, N)),
                                    False),
}


def _to_jax(x):
    if isinstance(x, tuple):
        return tuple(_to_jax(v) for v in x)
    return x if isinstance(x, float) else jnp.asarray(x)


def _to_torch(x, dtype=torch.float64):
    if isinstance(x, tuple):
        return tuple(_to_torch(v, dtype) for v in x)
    if isinstance(x, float):
        return x
    return torch.as_tensor(np.array(x), dtype=dtype)


def _outputs(res):
    return res if isinstance(res, tuple) else (res,)


def _compare(got, ref, crosses_zero):
    for g, r in zip(_outputs(got), _outputs(ref)):
        r = np.asarray(r)
        atol = 1e-12 * np.max(np.abs(r)) if crosses_zero else 0.0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    make, crosses_zero = CASES[name]
    args = make(np.random.default_rng(sorted(CASES).index(name)))
    ref = getattr(jth, name)(*_to_jax(args))
    got = getattr(tth, name)(*_to_torch(args))
    assert len(_outputs(got)) == len(_outputs(ref))
    _compare(got, ref, crosses_zero)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", sorted(CASES))
def test_dtype_preserved(name, dtype):
    args = CASES[name][0](np.random.default_rng(0))
    for out in _outputs(getattr(tth, name)(*_to_torch(args, dtype))):
        assert out.dtype == dtype


def test_alpha_sw_cold_clamp():
    sst = np.array([260.0, 269.0, 269.9, 270.0, 275.0])
    got = tth.alpha_sw(torch.as_tensor(sst)).numpy()
    assert np.all(got[:3] == 0.0) and np.all(got[3:] > 0.0)


def test_fsign_keeps_negative_zero_sign():
    got = tth.fsign(torch.tensor([2.0, 2.0]), torch.tensor([0.0, -0.0]))
    np.testing.assert_array_equal(got.numpy(), [2.0, -2.0])


def test_inv_cbrt_1p_matches_jax():
    s = np.concatenate([[0.0, 1e-300, 1e-8], np.logspace(-6, 12, 200)])
    ref = np.asarray(jmc.inv_cbrt_1p(jnp.asarray(s)))
    np.testing.assert_allclose(tmc.inv_cbrt_1p(torch.as_tensor(s)).numpy(),
                               ref, rtol=1e-12)


def test_arctan_matches_jax():
    x = np.linspace(-40.0, 40.0, 4001)
    np.testing.assert_allclose(tmc.arctan(torch.as_tensor(x)).numpy(),
                               np.asarray(jmc.arctan(jnp.asarray(x))),
                               rtol=1e-12, atol=1e-15)


# --- roughness, neutral wind and the LKB table ------------------------------

def _rough(seed=11):
    rng = np.random.default_rng(seed)
    return dict(Cd=1e-4 + 3e-3 * rng.random(N), psi=rng.normal(0.0, 2.0, N),
                us=0.01 + 0.8 * rng.random(N), uzu=0.3 + 20.0 * rng.random(N),
                z0=1e-6 + 2e-3 * rng.random(N))


@pytest.mark.parametrize("zu", [2.0, 10.0, 28.0])
@pytest.mark.parametrize("name,args", [
    ("z0_from_cd", ("Cd",)), ("z0_from_cd", ("Cd", "psi")),
    ("z0_from_ustar", ("us", "uzu")), ("cd_from_z0", ("z0",)),
    ("cd_from_z0", ("z0", "psi")), ("un10_from_ustar", ("uzu", "us", "psi")),
    ("un10_from_cdn", ("uzu", "Cd", "psi")),
    ("un10_from_cd", ("uzu", "Cd", "psi")),
])
def test_roughness_conversions_match_jax(name, args, zu):
    """rtol 1e-12 (this file's docstring); un10_from_ustar crosses zero
    where u* is large against the wind, so it also gets the atol."""
    f = _rough()
    got = getattr(tth, name)(zu, *(torch.as_tensor(f[a]) for a in args))
    ref = np.asarray(getattr(jth, name)(zu, *(jnp.asarray(f[a]) for a in args)))
    atol = 1e-12 * np.max(np.abs(ref)) if name == "un10_from_ustar" else 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=atol)


# every LKB bin edge exactly, its neighbours, 0, negative, the 1000 cut, NaN
_EDGES = np.array([0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0])
RER = np.concatenate([
    _EDGES, np.nextafter(_EDGES, np.inf), np.nextafter(_EDGES, -np.inf),
    [-1.0, -0.0, 5e3, 1e-300],
    np.exp(np.random.default_rng(12).uniform(-6.0, 7.5, 400)),
])


@pytest.mark.parametrize("iflag", [1, 2])
def test_z0tq_lkb_matches_jax(iflag):
    """The bucketize bins against aerobulk_tpu's searchsorted branch (the
    JAX CPU path), at rtol 1e-12."""
    z0 = 1e-5 + 1e-3 * np.random.default_rng(iflag).random(RER.size)
    got = tth.z0tq_lkb(iflag, torch.as_tensor(RER), torch.as_tensor(z0))
    ref = np.asarray(jth.z0tq_lkb(iflag, jnp.asarray(RER), jnp.asarray(z0)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12)
    nan = tth.z0tq_lkb(iflag, torch.tensor([float("nan")], dtype=torch.float64),
                       torch.tensor([1e-4], dtype=torch.float64))
    assert nan.item() == np.asarray(
        jth.z0tq_lkb(iflag, jnp.asarray([np.nan]), jnp.asarray([1e-4])))[0]
