"""fp32 regime flips of the COARE warm layer at scale: a property of the
reference's fp32 path that the port shares (ROADMAP.md section 3, F5).

chip_smoke.py phase 20(c) runs the weather machine's month over 721x1440
points and holds kernel 1 fp32 to kernel 1 fp64 at 1e-4 significant points
per record.  COARE's dT_wl leaves that gate at a few records: where a
point's warm-layer accumulator sits within fp32's rounding of zero at the
morning's first step, fp32 and fp64 take different branches and their
warm layers differ until the next reset.  This file shows, on the CPU at
4,000 points of the reference's own weather machine
(tests/test_long_series.py::_weather_forcing, seed 405, 192 records), that
the JAX package's fp32 ``run_series`` does the same against its fp64, and
so does the port's eager fp32 against its fp64, while the port's fp64
equals the JAX package's (no significant point in any record or field).
The fluxes stay inside the reference's flip budget (QL or QH apart by more
than 0.5 W/m^2 at under 5e-3 of the point-records,
tests/test_long_series.py:280-286).
"""

import jax.numpy as jnp
import numpy as np
import torch

from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi
from test_long_series import _weather_forcing

NT, NPTS = 192, 4000


def _sig_by_record(a, b):
    """The significant fraction of each record of ``a`` against ``b``:
    points apart by more than 10% of b's median magnitude over its
    nonzero points (chip_smoke.py's rule)."""
    out = []
    for x, y in zip(a, b):
        nz = np.abs(y[y != 0])
        med = np.median(nz) if nz.size else 0.0
        out.append(np.mean(np.abs(x - y) > (0.1 * med if med > 1e-20
                                            else 1e-6)))
    return np.array(out)


def test_fp32_warm_layer_flips_are_the_references():
    f, isd, lon = _weather_forcing(NT, NPTS, seed=405)
    jcfg = japi.AeroBulkConfig(algo="coare3p6", use_skin=True)
    tcfg = tapi.AeroBulkConfig(algo="coare3p6", use_skin=True)

    def jrun(dt):
        o, _ = japi.run_series(
            jcfg, {k: jnp.asarray(v, dt) for k, v in f.items()},
            isecday_utc=jnp.asarray(isd), lon=jnp.asarray(lon, dt),
            skin_state=japi.init_skin_state(jcfg, (NPTS,), dt))
        return {n: np.asarray(x, np.float64) for n, x in
                (("dT_wl", o.diag.dT_wl), ("QL", o.QL), ("QH", o.QH))}

    def trun(dt):
        o, _ = tapi.run_series(
            tcfg, {k: torch.as_tensor(v, dtype=dt) for k, v in f.items()},
            isecday_utc=isd, lon=torch.as_tensor(lon, dtype=dt),
            skin_state=tapi.init_skin_state(tcfg, (NPTS,), dt, "cpu"))
        return {n: x.double().numpy() for n, x in
                (("dT_wl", o.diag.dT_wl), ("QL", o.QL), ("QH", o.QH))}

    j64, j32 = jrun(jnp.float64), jrun(jnp.float32)
    t64, t32 = trun(torch.float64), trun(torch.float32)
    jax_sig = _sig_by_record(j32["dT_wl"], j64["dT_wl"])
    port_sig = _sig_by_record(t32["dT_wl"], t64["dT_wl"])
    print(f"\ndT_wl significant fraction, fp32 against fp64: JAX worst "
          f"{jax_sig.max():.3g} (record {jax_sig.argmax()}, "
          f"{(jax_sig > 1e-4).sum()} records over 1e-4); port worst "
          f"{port_sig.max():.3g} (record {port_sig.argmax()}, "
          f"{(port_sig > 1e-4).sum()} records over 1e-4)")
    # the reference's own fp32 leaves the per-record gate, and so does the
    # port's; neither by more than a few points in a thousand
    assert jax_sig.max() > 1e-4 and port_sig.max() > 1e-4
    assert jax_sig.max() < 1e-2 and port_sig.max() < 1e-2
    for run32, run64 in ((j32, j64), (t32, t64)):
        flip = np.maximum(np.abs(run32["QL"] - run64["QL"]),
                          np.abs(run32["QH"] - run64["QH"])) > 0.5
        assert flip.mean() < 5e-3
    # the port's fp64 is the reference's: no significant point anywhere
    for n in t64:
        assert _sig_by_record(t64[n], j64[n]).max() == 0.0, n
