"""Gradient-based calibration of the Charnock law through the bulk solve.

The COARE 3.6 Charnock parameter is a fitted linear law of wind speed,
alpha(U) = 0.0017 U - 0.005 capped to [0, 0.028] (Edson et al. 2013
Eq. 13, mod_blk_coare3p6.f90:417-441).  Field campaigns re-fit those two
coefficients against eddy-covariance fluxes.  Every step of the port's
COARE solve is differentiable, the fixed-point iteration included, so the
fit is autograd plus ``torch.optim.Adam`` through the full solve (5 bulk
iterations, gustiness, roughness closures, bulk formula).

This module synthesizes a flux "campaign" from the standard law and
recovers (slope, offset) from a wrong starting point.  The counterpart of
the JAX package's ``examples/calibrate_charnock.py`` (optax there), fp64.

Usage:
    python3 -m aerobulk_tpu_torch.calibrate_charnock [--steps N]
        [--device cuda|cpu]

Runs on the CUDA device unless given ``--device cpu``; without a GPU it
raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import constants as c
from . import thermo
from .algos.coare import turb_coare3p6
from .skin import default_device

ZT, ZU = 2.0, 10.0
TRUE_SLOPE, TRUE_OFFSET = 0.0017, -0.005   # Edson-2013 Eq. 13


def make_campaign(n=512, seed=0, device=None):
    """Synthetic observation set spanning the open-ocean regime, fp64 on
    ``device``: dict of sst, theta_zt, q_zt, U, slp."""
    device = default_device(device)
    rng = np.random.default_rng(seed)
    sst = rng.uniform(278.0, 303.0, n)
    t_zt = sst + rng.uniform(-3.0, 2.0, n)          # unstable and stable
    slp = rng.uniform(98000.0, 103000.0, n)
    U = rng.uniform(3.0, 18.0, n)                   # unclipped alpha range
    t_zt, slp = (torch.as_tensor(x, device=device) for x in (t_zt, slp))
    return dict(sst=torch.as_tensor(sst, device=device),
                theta_zt=thermo.pot_temp(t_zt, slp),
                q_zt=0.7 * thermo.q_sat(t_zt, slp),
                U=torch.as_tensor(U, device=device), slp=slp)


def fluxes(obs, charn_fn=None):
    """(Tau, QH, QL) from the full COARE 3.6 solve, bulk-SST mode, with the
    Charnock law ``charn_fn`` (default: the version's own)."""
    q_s = c.rdct_qsat_salt * thermo.q_sat(obs["sst"], obs["slp"])
    res, _ = turb_coare3p6(ZT, ZU, obs["sst"], obs["theta_zt"], q_s,
                           obs["q_zt"], obs["U"], niter=5, charn_fn=charn_fn)
    Tau, QH, QL, _, _ = thermo.bulk_formula(
        ZU, res.T_s, res.q_s, res.t_zu, res.q_zu,
        res.Cd, res.Ch, res.Ce, obs["U"], res.Ubzu, obs["slp"])
    return Tau, QH, QL


def linear_law(a, b):
    """The Charnock law ``clip(a U + b, 0, 0.028)`` (a, b tensors or
    floats)."""
    return lambda w: thermo.minc(thermo.maxc(a * w + b, 0.0), 0.028)


def calibrate(obs, target, steps=400, lr=0.5, verbose=True):
    """Recover (slope, offset) of the Charnock law by Adam on the
    flux-mismatch loss, from alpha = 0.001 U."""
    tau_o, qh_o, ql_o = target
    scales = [torch.std(x, correction=0) for x in target]

    def loss(params):
        # params are in units of 1e-3 so Adam's step size is sane
        tau, qh, ql = fluxes(obs, charn_fn=linear_law(params[0] * 1e-3,
                                                      params[1] * 1e-3))
        return ((tau - tau_o) ** 2 / scales[0] ** 2
                + (qh - qh_o) ** 2 / scales[1] ** 2
                + (ql - ql_o) ** 2 / scales[2] ** 2).mean()

    params = torch.tensor([1.0, 0.0], dtype=obs["U"].dtype,
                          device=obs["U"].device, requires_grad=True)
    opt = torch.optim.Adam([params], lr=lr)
    for i in range(steps):
        opt.zero_grad()
        val = loss(params)
        val.backward()
        opt.step()
        if verbose and (i % 50 == 0 or i == steps - 1):
            p = params.detach()
            print(f"  step {i:4d}  loss {float(val):.3e}  "
                  f"slope {float(p[0]) * 1e-3:+.6f}  "
                  f"offset {float(p[1]) * 1e-3:+.6f}")
    p = params.detach()
    return float(p[0]) * 1e-3, float(p[1]) * 1e-3


def main(steps=400, device=None):
    obs = make_campaign(device=device)
    print("Generating synthetic campaign from the standard COARE 3.6 "
          f"Charnock law (slope {TRUE_SLOPE}, offset {TRUE_OFFSET})...")
    target = tuple(x.detach() for x in fluxes(obs))   # built-in law = truth
    print("Calibrating from (0.001, 0.0) through the full bulk solve:")
    slope, offset = calibrate(obs, target, steps=steps)
    print(f"\nrecovered slope  = {slope:+.6f}   (true {TRUE_SLOPE:+.6f})")
    print(f"recovered offset = {offset:+.6f}   (true {TRUE_OFFSET:+.6f})")
    print(f"slope error {100 * abs(slope - TRUE_SLOPE) / TRUE_SLOPE:.2f}%")
    return slope, offset


def _cli():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args()
    main(args.steps, args.device)


if __name__ == "__main__":
    _cli()
