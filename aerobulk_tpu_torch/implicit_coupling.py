"""Implicit air-sea coupling with linearized bulk fluxes.

The use case behind :func:`aerobulk_tpu_torch.flux_step_linearized`: a
coupled model stepping a thin ocean mixed layer with a coupling interval
longer than the layer's flux-feedback timescale must treat the turbulent
fluxes implicitly, ``Q(T+) ~ Q(T) + (dQ/dT) (T+ - T)``, or the explicit
update amplifies (``|1 + dt lambda| > 1`` with ``lambda = (dQ/dT) /
(rho cp h) < 0``).  The exact per-point dQ/dT through the whole COARE solve
(transfer coefficients, stability functions, gustiness) is one forward-mode
pass, ``torch.func.jvp``.

The demo: a 0.2 m slab (a diurnal warm layer) under fixed forcing, coupled
every 12 h.  Explicit coupling oscillates and diverges; implicit coupling
converges to the equilibrium that a resolved (1 h) explicit integration
reaches.  The counterpart of the JAX package's
``examples/implicit_coupling.py``, in fp64.

Usage:
    python3 -m aerobulk_tpu_torch.implicit_coupling [--days D]
        [--device cuda|cpu]

Runs on the CUDA device unless given ``--device cpu``; without a GPU it
raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import constants as c
from .api import AeroBulkConfig, flux_step, flux_step_linearized
from .skin import default_device

# slab + forcing (one point; everything broadcasts to grids unchanged)
H_SLAB = 0.2                         # m: diurnal-warm-layer depth
CAP = c.rho0_w * c.rCp0_w * H_SLAB   # J/m^2/K heat capacity
T_AIR, Q_AIR, WIND = 288.15, 0.008, 7.0
SLP, RAD_LW, QSOL = 101000.0, 340.0, 120.0   # absorbed solar [W/m^2]
EMIS, SIGMA = c.emiss_w, c.stefan
CFG = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=False)


def forcing(device):
    """The fixed air-side forcing (t_zt, hum_zt, U_zu, V_zu, slp), one point,
    fp64 on ``device``."""
    return tuple(torch.full((1,), x, dtype=torch.float64, device=device)
                 for x in (T_AIR, Q_AIR, WIND, 0.0, SLP))


def q_net(T, args):
    """Net surface heat flux [W/m^2] into the slab at SST ``T``: turbulent
    through the full bulk solve, net longwave and absorbed solar."""
    out, _ = flux_step(CFG, T, *args)
    lw = EMIS * (RAD_LW - SIGMA * T ** 4)
    return out.QL + out.QH + lw + QSOL


def step_explicit(T, dt, args):
    return T + dt * q_net(T, args) / CAP


def step_implicit(T, dt, args):
    """Backward Euler on the linearized flux: ``T+ = T + dt (Q(T) + Q'(T)
    (T+ - T)) / C`` in closed form, with Q' exact through the bulk solve
    (one jvp, ``wrt="sst"``) plus the analytic -4 eps sigma T^3 of the
    longwave term."""
    out, d_out, _ = flux_step_linearized(CFG, T, *args, wrt="sst")
    lw = EMIS * (RAD_LW - SIGMA * T ** 4)
    q = out.QL + out.QH + lw + QSOL
    dq = d_out.QL + d_out.QH - 4.0 * EMIS * SIGMA * T ** 3
    return T + dt * q / (CAP - dt * dq)


def integrate(stepper, T0, dt, t_end, args):
    """The SST trajectory from ``T0`` in steps of ``dt`` seconds to
    ``t_end``, as a numpy array (one host read per step)."""
    T = torch.full((1,), T0, dtype=torch.float64, device=args[0].device)
    traj = [float(T[0])]
    for _ in range(int(round(t_end / dt))):
        T = stepper(T, dt, args)
        traj.append(float(T[0]))
    return np.array(traj)


def main(days=30.0, device=None):
    """Run the demo over ``days`` and check it: the implicit 12 h run ends
    within 0.05 K of the resolved equilibrium, and the explicit 12 h run
    strays further than the implicit one.  Returns the three trajectories
    (resolved, explicit, implicit)."""
    device = default_device(device)
    args = forcing(device)
    T0, DT, T_END = 295.15, 43200.0, days * 86400.0   # 12 h coupling

    # feedback timescale from the exact derivative at T0
    _, d0, _ = flux_step_linearized(
        CFG, torch.full((1,), T0, dtype=torch.float64, device=device), *args,
        wrt="sst")
    lam = (float(d0.QL[0] + d0.QH[0]) - 4 * EMIS * SIGMA * T0 ** 3) / CAP
    print(f"dQ/dT at T0 = {lam * CAP:+.1f} W/m^2/K  ->  explicit stability "
          f"limit 2/|lambda| = {2 / abs(lam) / 3600:.1f} h; coupling step "
          f"= {DT / 3600:.0f} h")

    ref = integrate(step_explicit, T0, 3600.0, T_END, args)   # resolved
    exp = integrate(step_explicit, T0, DT, T_END, args)
    imp = integrate(step_implicit, T0, DT, T_END, args)

    overshoot = max(0.0, (ref[-1] - imp).max() if imp[0] > ref[-1]
                    else (imp - ref[-1]).max())
    print(f"equilibrium (resolved explicit, dt=1h): {ref[-1]:.4f} K")
    print(f"explicit  dt=12h: final {exp[-1]:.4f} K,  max |T| excursion "
          f"{np.abs(exp - ref[-1]).max():.2f} K")
    print(f"implicit  dt=12h: final {imp[-1]:.4f} K,  max overshoot past "
          f"equilibrium {overshoot:.4f} K")

    assert abs(imp[-1] - ref[-1]) < 0.05, "implicit should hit equilibrium"
    assert np.abs(exp - ref[-1]).max() > np.abs(imp - ref[-1]).max(), \
        "explicit should be the unstable one"
    print("OK: implicit coupling stable and accurate at 12 h; explicit is not")
    return ref, exp, imp


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--days", type=float, default=30.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.days, args.device)


if __name__ == "__main__":
    _cli()
