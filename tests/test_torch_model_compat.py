"""aerobulk_tpu_torch.aerobulk_model, the counterpart of the reference's
AEROBULK_MODEL: every case of tests/test_model_compat.py on the port with
``device="cpu"`` and numpy inputs (as users of the Fortran entry point
pass them), the same calls against aerobulk_tpu.aerobulk_model at rtol
1e-12 (fp64), the registry's lifecycle, and the default device: the CUDA
device, so without a GPU a call that names none raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerobulk_tpu
from aerobulk_tpu_torch import aerobulk_model
from aerobulk_tpu_torch import api as tapi

CPU = dict(device="cpu")


def _inputs():
    return dict(
        sst=np.array([295.15, 295.15]),
        t_zt=np.array([293.15, 298.15]),
        hum_zt=np.array([0.012, 0.012]),
        U_zu=np.array([5.0, 5.0]),
        V_zu=np.array([0.0, 0.0]),
        slp=np.array([101000.0, 101000.0]))


def test_aerobulk_model_golden():
    """tests/test_model_compat.py's golden COARE 3.0 values (rtol 1e-5),
    and the JAX entry point's at rtol 1e-12."""
    kw = dict(Niter=50, l_use_skin=True, rad_sw=np.zeros(2),
              rad_lw=np.full((2,), 350.0))
    QL, QH, Tx, Ty, E, Ts = aerobulk_model(1, 1, "coare3p0", 2.0, 10.0,
                                           **_inputs(), **kw, **CPU)
    assert QL.device.type == "cpu" and QL.dtype == torch.float64
    np.testing.assert_allclose(QH.numpy(), [-15.155299, 17.835405],
                               rtol=1e-5)
    np.testing.assert_allclose(QL.numpy(), [-81.389019, -50.815788],
                               rtol=1e-5)
    np.testing.assert_allclose(Ts.numpy() - 273.15, [21.721964, 21.757541],
                               atol=2e-5)
    ref = aerobulk_tpu.aerobulk_model(1, 1, "coare3p0", 2.0, 10.0,
                                      **_inputs(), **kw)
    for g, r in zip((QL, QH, Tx, Ty, E, Ts), ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                   atol=1e-12 * np.max(np.abs(r)))


def test_aerobulk_model_state_lifecycle():
    """jt=1..Nt carries warm-layer state; a fresh jt=1 resets it; the entry
    is dropped after jt == Nt."""
    kw = dict(Niter=10, l_use_skin=True, rad_sw=np.full((2,), 700.0),
              rad_lw=np.full((2,), 420.0), isecday_utc=12 * 3600, **CPU)
    inputs = _inputs()
    *_, ts1 = aerobulk_model(1, 2, "coare3p6", 2.0, 10.0, **inputs, **kw)
    assert ("coare3p6", (2,), 0) in tapi._MODEL_STATE
    *_, ts2 = aerobulk_model(2, 2, "coare3p6", 2.0, 10.0, **inputs, **kw)
    assert ("coare3p6", (2,), 0) not in tapi._MODEL_STATE
    *_, ts1b = aerobulk_model(1, 1, "coare3p6", 2.0, 10.0, **inputs, **kw)
    np.testing.assert_allclose(ts1.numpy(), ts1b.numpy())
    assert float(ts2[0]) > float(ts1[0])   # warm layer accumulated
    assert not tapi._MODEL_STATE


def test_aerobulk_model_series_matches_jax_and_the_eager_chain():
    """Three warm-layer records through the entry point equal the JAX
    entry point's (rtol 1e-12) and the port's run_series(backend="eager")
    on the same records bitwise."""
    rng = np.random.default_rng(8)
    nt, n = 3, 5
    rec = [dict(sst=290.0 + 8.0 * rng.random(n),
                t_zt=288.0 + 8.0 * rng.random(n),
                hum_zt=0.006 + 0.008 * rng.random(n),
                U_zu=rng.normal(0.0, 6.0, n), V_zu=rng.normal(0.0, 6.0, n),
                slp=99000.0 + 3000.0 * rng.random(n),
                rad_sw=800.0 * rng.random(n),
                rad_lw=300.0 + 100.0 * rng.random(n)) for _ in range(nt)]
    kw = dict(Niter=5, l_use_skin=True, isecday_utc=30000)
    got = [aerobulk_model(jt, nt, "coare3p6", 2.0, 10.0, **r, **kw, **CPU)
           for jt, r in enumerate(rec, 1)]
    ref = [aerobulk_tpu.aerobulk_model(jt, nt, "coare3p6", 2.0, 10.0,
                                       **{k: jnp.asarray(v)
                                          for k, v in r.items()}, **kw)
           for jt, r in enumerate(rec, 1)]
    for g_rec, r_rec in zip(got, ref):
        for g, r in zip(g_rec, r_rec):
            r = np.asarray(r)
            np.testing.assert_allclose(g.numpy(), r, rtol=1e-12,
                                       atol=1e-12 * np.max(np.abs(r)))
    cfg = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    forcing = {k: torch.as_tensor(np.stack([r[k] for r in rec]))
               for k in rec[0]}
    out, _ = tapi.run_series(cfg, forcing, isecday_utc=[30000] * nt,
                             skin_state=tapi.init_skin_state(
                                 cfg, (n,), torch.float64, "cpu"))
    for jt, g_rec in enumerate(got):
        for g, r in zip(g_rec, (out.QL, out.QH, out.Tau_x, out.Tau_y,
                                out.Evap, out.T_s)):
            assert torch.equal(g, r[jt])
    assert not tapi._MODEL_STATE


def test_aerobulk_model_detects_humidity():
    inputs = _inputs()
    inputs["hum_zt"] = np.array([75.0, 75.0])   # [%]
    QL, QH, *_ = aerobulk_model(1, 1, "ncar", 2.0, 10.0, **inputs, Niter=10,
                                **CPU)
    assert np.all(np.isfinite(QL.numpy()))
    ref = aerobulk_tpu.aerobulk_model(1, 1, "ncar", 2.0, 10.0, **inputs,
                                      Niter=10)
    np.testing.assert_allclose(QL.numpy(), np.asarray(ref[0]), rtol=1e-12)

    inputs["hum_zt"] = np.array([1.0e5, 1.0e5])   # nonsense range aborts
    with pytest.raises(ValueError):
        aerobulk_model(1, 1, "ncar", 2.0, 10.0, **inputs, Niter=10, **CPU)


def test_aerobulk_model_humidity_detected_once():
    """The humidity kind is detected at jt == 1 and carried, as the
    reference stores ctype_humidity at init (mod_aerobulk.f90:127)."""
    inputs = _inputs()
    inputs["hum_zt"] = np.array([75.0, 80.0])       # detected as RH [%]
    aerobulk_model(1, 3, "ncar", 2.0, 10.0, **inputs, Niter=10, **CPU)
    inputs["hum_zt"] = np.array([0.05, 0.06])       # drifts into the sh range
    QL2, *_ = aerobulk_model(2, 3, "ncar", 2.0, 10.0, **inputs, Niter=10,
                             **CPU)
    cfg_rh = tapi.AeroBulkConfig(algo="ncar", zt=2.0, zu=10.0, niter=10,
                                 humidity="rh")
    out_rh, _ = tapi.flux_step(cfg_rh, *(torch.as_tensor(inputs[k]) for k in
                                         ("sst", "t_zt", "hum_zt", "U_zu",
                                          "V_zu", "slp")))
    np.testing.assert_allclose(QL2.numpy(), out_rh.QL.numpy(), rtol=1e-12)
    aerobulk_model(3, 3, "ncar", 2.0, 10.0, **inputs, Niter=10, **CPU)
    assert not tapi._MODEL_STATE


def test_aerobulk_model_series_id_isolates_state():
    kw = dict(Niter=10, l_use_skin=True, rad_sw=np.full((2,), 700.0),
              rad_lw=np.full((2,), 420.0), isecday_utc=12 * 3600, **CPU)
    inputs = _inputs()
    *_, a1 = aerobulk_model(1, 3, "coare3p6", 2.0, 10.0, **inputs, **kw,
                            series_id="A")
    *_, b1 = aerobulk_model(1, 3, "coare3p6", 2.0, 10.0, **inputs, **kw,
                            series_id="B")
    *_, a2 = aerobulk_model(2, 3, "coare3p6", 2.0, 10.0, **inputs, **kw,
                            series_id="A")
    np.testing.assert_allclose(b1.numpy(), a1.numpy())
    assert float(a2[0]) > float(a1[0])
    aerobulk_model(3, 3, "coare3p6", 2.0, 10.0, **inputs, **kw,
                   series_id="A")
    aerobulk_model(3, 3, "coare3p6", 2.0, 10.0, **inputs, **kw,
                   series_id="B")
    assert not tapi._MODEL_STATE


def test_aerobulk_model_checks_flux_sanity_every_call():
    """A record with a non-finite flux aborts, as the reference's
    BULK_FORMULA_VCTR does, also after jt == 1 (validation runs only at
    jt == 1)."""
    inputs = _inputs()
    aerobulk_model(1, 2, "ncar", 2.0, 10.0, **inputs, Niter=5, **CPU)
    inputs["U_zu"] = np.array([5.0, np.nan])
    with pytest.raises(ValueError, match="flux sanity"):
        aerobulk_model(2, 2, "ncar", 2.0, 10.0, **inputs, Niter=5, **CPU)
    tapi._MODEL_STATE.clear()


def test_aerobulk_model_keeps_the_references_solar_clock_default():
    """``isecday_utc`` defaults to 12 (seconds), the reference's
    library-level value (mod_aerobulk_compute.f90:136)."""
    kw = dict(Niter=5, l_use_skin=True, rad_sw=np.full((2,), 700.0),
              rad_lw=np.full((2,), 420.0), **CPU)
    a = aerobulk_model(1, 1, "coare3p6", 2.0, 10.0, **_inputs(), **kw)
    b = aerobulk_model(1, 1, "coare3p6", 2.0, 10.0, **_inputs(), **kw,
                       isecday_utc=12)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_aerobulk_model_builds_on_the_cuda_device_by_default():
    if torch.cuda.is_available():
        QL, *_ = aerobulk_model(1, 1, "ncar", 2.0, 10.0, **_inputs())
        assert QL.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aerobulk_model(1, 1, "ncar", 2.0, 10.0, **_inputs())
    assert not tapi._MODEL_STATE


def test_the_port_exports_every_name_of_the_reference():
    """aerobulk_tpu_torch exports every name of aerobulk_tpu.__all__, the
    submodules as modules of the port and the version string."""
    import types

    import aerobulk_tpu_torch as abt
    assert set(aerobulk_tpu.__all__) <= set(abt.__all__)
    for name in abt.__all__:
        obj = getattr(abt, name)
        if isinstance(obj, types.ModuleType):
            assert obj.__name__ == f"aerobulk_tpu_torch.{name}"
    assert abt.__version__ == aerobulk_tpu.__version__
    assert abt.OCEAN_ALGOS.keys() == aerobulk_tpu.OCEAN_ALGOS.keys()
