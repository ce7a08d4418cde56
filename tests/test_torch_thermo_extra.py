"""The public ``thermo`` functions that no flux step reaches, in
aerobulk_tpu_torch against aerobulk_tpu, fp64 on the CPU: ``abs_temp``,
``t_from_z_p0_theta_q``, ``rho_air``, ``gamma_moist``, ``e_air``,
``rh_air``, ``rho_air_adv``, ``q_sat_crude``, ``dry_static_energy``,
``variance``, ``vmean`` and ``delta_skin_layer``, and the two signatures
that were incomplete: ``ri_bulk(..., Ta_layer, qa_layer)`` and
``pz_from_p0_tz_qz(..., l_ice)``.

Tolerance: rtol 1e-12 against the JAX function on seeded inputs (atol
1e-12 * max|ref| where the output crosses zero), as
tests/test_torch_thermo.py; then the properties tests/test_thermo.py holds
the reference to, on the port.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerobulk_tpu import constants as c
from aerobulk_tpu import thermo as jth
from aerobulk_tpu_torch import thermo as tth

N = 257


def _u(rng, lo, hi):
    return lo + (hi - lo) * rng.random(N)


def _coefs_args(r):
    return (jth.alpha_sw(jnp.asarray(_u(r, 268.0, 305.0))),
            r.normal(0.0, 300.0, N), _u(r, 0.0, 1.0))


# name -> (inputs(rng), keyword arguments, crosses_zero)
CASES = {
    "abs_temp": (lambda r: (_u(r, 250, 310), _u(r, 95000, 102000),
                            _u(r, 98000, 103000)), {}, False),
    "abs_temp_patm": (lambda r: (_u(r, 250, 310), _u(r, 95000, 102000)),
                      {}, False),
    "t_from_z_p0_theta_q": (lambda r: (10.0, _u(r, 98000, 103000),
                                       _u(r, 250, 310), _u(r, 0, 0.02)),
                            {}, False),
    "rho_air": (lambda r: (np.concatenate([_u(r, 250, 310)[:-1], [1000.0]]),
                           _u(r, 0, 0.02),
                           np.concatenate([_u(r, 98000, 103000)[:-1],
                                           [1000.0]])), {}, False),
    "gamma_moist": (lambda r: (np.concatenate([_u(r, 200, 310)[:-2],
                                               [150.0, 180.0]]),
                               np.concatenate([_u(r, 0, 0.02)[:-2],
                                               [0.0, 1e-6]])), {}, False),
    "e_air": (lambda r: (_u(r, 0, 0.02), _u(r, 90000, 105000)), {}, False),
    "e_air_niter3": (lambda r: (_u(r, 0, 0.02), _u(r, 90000, 105000)),
                     {"niter": 3}, False),
    "rh_air": (lambda r: (_u(r, 0.001, 0.02), _u(r, 270, 310),
                          _u(r, 90000, 105000)), {}, False),
    "rho_air_adv": (lambda r: (_u(r, 250, 310), _u(r, 0, 0.02),
                               _u(r, 90000, 105000)), {}, False),
    "q_sat_crude": (lambda r: (_u(r, 270, 310), _u(r, 1.0, 1.4)), {}, False),
    "dry_static_energy": (lambda r: (10.0, _u(r, 250, 310), _u(r, 0, 0.02)),
                          {}, False),
    "variance": (lambda r: (r.normal(2.0, 1.5, 1000),), {}, False),
    "vmean": (lambda r: (r.normal(2.0, 1.5, 1000),), {}, False),
    "delta_skin_layer": (_coefs_args, {}, False),
    "delta_skin_layer_qlat": (lambda r: _coefs_args(r)
                              + (r.normal(-80.0, 60.0, N),), {}, False),
    "ri_bulk_layer": (lambda r: (10.0, _u(r, 270, 305), _u(r, 270, 305),
                                 _u(r, 0.002, 0.02), _u(r, 0.001, 0.02),
                                 _u(r, 0.5, 25), _u(r, 265, 305),
                                 _u(r, 0.001, 0.02)), {}, True),
    "ri_bulk_one_layer_field": (lambda r: (10.0, _u(r, 270, 305),
                                           _u(r, 270, 305), _u(r, 0.002, 0.02),
                                           _u(r, 0.001, 0.02), _u(r, 0.5, 25),
                                           _u(r, 265, 305)), {}, True),
    "pz_from_p0_tz_qz_ice": (lambda r: (2.0, _u(r, 98000, 103000),
                                        _u(r, 230, 273), _u(r, 0, 0.003)),
                             {"l_ice": True}, False),
    "pz_from_p0_tz_qz_water": (lambda r: (2.0, _u(r, 98000, 103000),
                                          _u(r, 250, 310), _u(r, 0, 0.02)),
                               {"l_ice": False}, False),
}


def _function(name):
    for stem in ("abs_temp", "e_air", "delta_skin_layer", "ri_bulk",
                 "pz_from_p0_tz_qz"):
        if name.startswith(stem + "_"):
            return stem
    return name


def _to_jax(x):
    return x if isinstance(x, float) else jnp.asarray(x)


def _to_torch(x):
    return x if isinstance(x, float) else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", sorted(CASES))
def test_matches_jax(name):
    make, kw, crosses_zero = CASES[name]
    args = make(np.random.default_rng(sorted(CASES).index(name) + 100))
    fn = _function(name)
    ref = np.asarray(getattr(jth, fn)(*map(_to_jax, args), **kw))
    got = getattr(tth, fn)(*map(_to_torch, args), **kw)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float64
    atol = 1e-12 * np.max(np.abs(ref)) if crosses_zero else 0.0
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-12, atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("name", ["abs_temp", "t_from_z_p0_theta_q",
                                  "rho_air", "gamma_moist", "e_air", "rh_air",
                                  "rho_air_adv", "q_sat_crude",
                                  "dry_static_energy", "delta_skin_layer"])
def test_dtype_preserved(name, dtype):
    make, kw, _ = CASES[name]
    args = make(np.random.default_rng(0))
    got = getattr(tth, name)(*(a if isinstance(a, float) else
                               torch.as_tensor(np.asarray(a), dtype=dtype)
                               for a in args), **kw)
    assert got.dtype == dtype


def test_the_port_has_every_public_thermo_function():
    assert set(jth.__all__) <= set(tth.__all__)
    for name in tth.__all__:
        assert callable(getattr(tth, name)), name


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


# the properties of tests/test_thermo.py, on the port

def test_theta_abs_roundtrip():
    slp = _t(np.full(5, 101000.0))
    Ta = _t(np.linspace(260.0, 310.0, 5))
    q = _t(np.full(5, 0.01))
    for z in (2.0, 10.0, 30.0):
        theta = tth.theta_from_z_p0_t_q(z, slp, Ta, q)
        Ta_back = tth.t_from_z_p0_theta_q(z, slp, theta, q)
        np.testing.assert_allclose(Ta_back.numpy(), Ta.numpy(), rtol=1e-6)


def test_q_air_rh_roundtrip():
    slp = _t(np.full(4, 101000.0))
    Ta = _t(np.linspace(280.0, 300.0, 4))
    q = _t(np.full(4, 0.008))
    rh = tth.rh_air(q, Ta, slp)
    np.testing.assert_allclose(tth.q_air_rh(rh, Ta, slp).numpy(), q.numpy(),
                               rtol=1e-6)


def test_rho_air_bounds():
    rho = tth.rho_air(_t([288.0]), _t([0.01]), _t([101000.0]))
    assert 1.1 < float(rho[0]) < 1.3
    rho = tth.rho_air(_t([1000.0]), _t([0.0]), _t([1000.0]))
    assert float(rho[0]) == 0.8


def test_gamma_moist_range():
    g = tth.gamma_moist(_t([290.0]), _t([0.01]))
    assert 0.003 < float(g[0]) < 0.007


def test_rho_air_adv_close_to_simple():
    Ta, qa = _t([288.0, 300.0]), _t([0.008, 0.018])
    slp = _t([101000.0, 100000.0])
    np.testing.assert_allclose(tth.rho_air_adv(Ta, qa, slp).numpy(),
                               tth.rho_air(Ta, qa, slp).numpy(), rtol=2e-3)


def test_q_sat_crude_vs_exact():
    ts = _t([285.0, 295.0, 305.0])
    slp = _t(np.full(3, 101000.0))
    rho = tth.rho_air(ts, _t(np.zeros(3)), slp)
    np.testing.assert_allclose(tth.q_sat_crude(ts, rho).numpy(),
                               tth.q_sat(ts, slp).numpy(), rtol=0.06)


def test_dry_static_energy():
    s = tth.dry_static_energy(10.0, _t([290.0]), _t([0.01]))
    expected = 9.8 * 10.0 + (1005.0 + 1860.0 * 0.01) * 290.0
    np.testing.assert_allclose(float(s[0]), expected, rtol=1e-12)


def test_variance_vmean():
    x = np.random.default_rng(3).normal(2.0, 1.5, 1000)
    np.testing.assert_allclose(float(tth.vmean(x)), x.mean(), rtol=1e-12)
    np.testing.assert_allclose(float(tth.variance(x)),
                               np.sqrt(((x - x.mean()) ** 2).mean()),
                               rtol=1e-12)


def test_ri_bulk_layer_takes_both_layer_fields_or_neither():
    """The layer's temperature replaces the default only with its humidity."""
    r = np.random.default_rng(4)
    args = [10.0] + [_t(a) for a in (_u(r, 270, 305), _u(r, 270, 305),
                                     _u(r, 0.002, 0.02), _u(r, 0.001, 0.02),
                                     _u(r, 0.5, 25))]
    Ta = _t(_u(r, 265, 305))
    assert torch.equal(tth.ri_bulk(*args, Ta_layer=Ta), tth.ri_bulk(*args))
    tv = tth.virt_temp(Ta, args[4])
    sstv = tth.virt_temp(args[1], args[3])
    ref = c.grav * (tth.virt_temp(args[2], args[4]) - sstv) * 10.0 / (
        tv * args[5] * args[5])
    np.testing.assert_allclose(
        tth.ri_bulk(*args, Ta_layer=Ta, qa_layer=args[4]).numpy(),
        ref.numpy(), rtol=1e-14)


def test_pz_over_ice_uses_the_ice_saturation():
    """Below freezing, e_sat over ice is lower, so the moist air is lighter
    in water and the pressure at height differs from the water branch."""
    slp, Ta, q = _t([101000.0]), _t([250.0]), _t([5e-4])
    p_ice = tth.pz_from_p0_tz_qz(10.0, slp, Ta, q, l_ice=True)
    p_w = tth.pz_from_p0_tz_qz(10.0, slp, Ta, q)
    assert float(p_ice) != float(p_w)
    assert torch.equal(p_w, tth.pz_from_p0_tz_qz(10.0, slp, Ta, q,
                                                 l_ice=False))
