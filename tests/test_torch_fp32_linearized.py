"""fp32 linearizations beyond fp32's resolution: a property of the
reference's fp32 ``jax.jvp`` that the port shares (ROADMAP.md section 3,
F6), and the gate chip_smoke.py's phase 22 holds the port's fp32
linearization to.

On 200,000 points of phase 22's forcing (bench.py's stateful forcing, seed
42), COARE 3.6 + skin, a fresh skin state: the JAX package's fp32
``flux_step_linearized`` leaves the fp32 significant-fraction gate (1e-4
of the points apart from fp64 by more than 10% of the median magnitude)
in d/d(rad_sw) and d/d(t_zt), and the port's fp32 does so by as much.
The points are where the derivative moves by more than that threshold
when the inputs move within fp32's resolution: near-neutral points, where
the gustiness term's (-zi/(kappa L))^(2/3) has an infinite slope at
1/L = 0 and fp32's 1/L lands on the other side of it or far nearer, and
light-wind points, whose derivatives are hundreds of times the median.
chip_smoke.py's ``fp32_check`` counts such a point as witnessed when the
fp32 derivative one ulp away, or the fp64 one at the fp32 inputs or one
ulp away, moves past the threshold; the rest stay under 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from aerobulk_tpu import api as japi
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import measure

SHAPE = (200, 1000)
NAMES = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw",
         "lon")


def _forcing(dtype):
    return dict(zip(NAMES, measure.grid_forcing(SHAPE, "cpu", dtype)))


def _port_lin(cfg, wrt):
    def lin(g):
        return tapi.flux_step_linearized(
            cfg, *(g[n] for n in NAMES[:6]), rad_sw=g["rad_sw"],
            rad_lw=g["rad_lw"], lon=g["lon"], isecday_utc=43200, wrt=wrt,
            skin_state=tapi.init_skin_state(cfg, g["sst"].shape,
                                            g["sst"].dtype, "cpu"))[1]
    return lin


def _jax_lin(wrt, dtype):
    cfg = japi.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                              use_skin=True)
    f = {n: jnp.asarray(x.numpy(), dtype)
         for n, x in _forcing(torch.float64).items()}
    return japi.flux_step_linearized(
        cfg, *(f[n] for n in NAMES[:6]), rad_sw=f["rad_sw"],
        rad_lw=f["rad_lw"], lon=f["lon"], isecday_utc=43200, wrt=wrt,
        skin_state=japi.init_skin_state(cfg, SHAPE, dtype))[1]


def _sig_frac(a, b):
    """chip_smoke.py's significance rule (``diff_stats``)."""
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b).ravel()
    med = np.median(np.abs(b[b != 0]))
    return float(np.mean(np.abs(a - b) > 0.1 * med))


@pytest.mark.parametrize("wrt", ["rad_sw", "t_zt"])
def test_fp32_linearization_leaves_the_gate_as_the_references(wrt):
    cfg = tapi.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=5,
                              use_skin=True)
    lin = _port_lin(cfg, wrt)
    f32 = _forcing(torch.float32)
    t32, t64 = lin(f32), lin(_forcing(torch.float64))
    j32, j64 = _jax_lin(wrt, jnp.float32), _jax_lin(wrt, jnp.float64)
    jax_sig = {o: _sig_frac(getattr(j32, o), getattr(j64, o))
               for o in chip_smoke.LIN_OUTPUTS}
    port_sig = {o: _sig_frac(getattr(t32, o).numpy(), getattr(t64, o).numpy())
                for o in chip_smoke.LIN_OUTPUTS}
    print(f"\nd/d{wrt} significant fraction, fp32 against fp64: JAX "
          f"{jax_sig}; port {port_sig}")
    # the reference's own fp32 leaves the gate, and the port's by as much
    assert max(jax_sig.values()) > 1e-4
    for o in chip_smoke.LIN_OUTPUTS:
        assert port_sig[o] <= 2.0 * max(jax_sig[o], 2.5e-5), o
    # the port's fp64 derivative is the reference's
    for o in chip_smoke.LIN_OUTPUTS:
        np.testing.assert_allclose(getattr(t64, o).numpy(),
                                   np.asarray(getattr(j64, o)), rtol=1e-9,
                                   atol=1e-9 * float(np.abs(
                                       np.asarray(getattr(j64, o))).max()))
    # phase 22's gate: the significant points fp32 can resolve, under 1e-4
    report = chip_smoke.fp32_check(
        wrt, t32, t64, lambda idx: chip_smoke.lin_witness(lin, f32, idx))
    for o, r in report.items():
        assert r["sig_frac"] == pytest.approx(port_sig[o])
        assert r["unwitnessed_sig_frac"] <= 1e-4
        assert r["witnessed_sig_points"] > 0 or r["sig_points"] == 0
