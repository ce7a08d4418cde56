"""The plain reference of the batched flux-product cell: COARE 3.0's
stateless step (no cool skin, no warm layer), in plain PyTorch.

A frozen copy of the eager step of ``aerobulk_tpu_torch`` (``api.flux_step``
of a ``use_skin=False`` COARE 3.0 config and the modules under it), cut to
what the benchmark's configuration runs: specific humidity in, the six
outputs the stateless kernel returns.  It imports nothing of the program
and runs in any floating dtype: float64 for the reference, bfloat16 for the
control that must fail the check.  The pieces COARE 3.0 shares with COARE
3.6 (thermodynamics over water, the COARE stability functions, the first
guess, BULK_FORMULA) are ``aerobulk.py``'s.

It follows ``TURB_COARE3P0`` (``src/mod_blk_coare3p0.f90``, Fairall et al.
2003): the first guess of ``mod_common_coare.f90`` with COARE 3.0's
Charnock law of the wind, then ``niter`` Monin-Obukhov passes, each with
the gustiness of beta = 1.25 and zi0 = 600 m, the Charnock law of the
10-m neutral wind (0.011 below 10 m/s, linear to 0.018 at 18 m/s,
``:420-447``), z0 = charn u*^2 / g + 0.11 nu / u* (``:271``) and the
scalar roughness z0t = min(1.1e-4, 5.5e-5 (nu / (z0 u*))^0.6)
(``:275-276``), the air's viscosity taken at t_zt (``:237``); then
BULK_FORMULA (``mod_phymbl.f90``) and the stress split.

Departures from the Fortran, each the program's and the JAX package's:

* no input is masked: ``AEROBULK_INIT`` masks points out of its validity
  ranges, and here every point is solved;
* z0 and z0t are clamped to [1e-9, 1] after their laws, and 1/L to
  +-200, as the program clamps them everywhere (FPE guards);
* constant divisions by k and g are multiplications by 1/k and 1/g, and
  the gustiness's 2/3 power is taken of the clamped positive part;
* the stress is split along the wind with a guard: Tau_x = Tau U / |U|
  where |U| > 1e-3, else 0;
* T_s is the SST itself: without the skin schemes the surface is the
  bulk water.
"""

from __future__ import annotations

import math

import torch

from .aerobulk import (GRAV, RDCT_QSAT_SALT, VKARMN, absj, bulk_formula,
                       clip_mag, first_guess_coare, maxc, minc, nonzero_delta,
                       one_on_l, pow23_pos, psi_h_coare, psi_m_coare, q_sat,
                       step, theta_from_z_p0_t_q, visc_air)

# --- COARE 3.0's own constants (mod_blk_coare3p0.f90:46-48) ---------------
BETA0 = 1.25                 # gustiness parameter
M_ZI0_OV_K = -600.0 / VKARMN  # -zi0 / k, zi0 the ABL scale height [m]
ZETA_ABS_MAX = 50.0
Z0T_COEF, Z0T_POW, Z0T_MAX = 5.5e-5, 0.6, 1.1e-4
_INV_K = 1.0 / VKARMN
_INV_G = 1.0 / GRAV


def charn_coare3p0(wnd):
    """COARE 3.0's Charnock parameter of the wind: 0.011 below 10 m/s,
    linear to 0.018 at 18 m/s and above (mod_blk_coare3p0.f90:420-447)."""
    gt10 = step(wnd - 10.0)
    gt18 = step(wnd - 18.0)
    return ((1.0 - gt10) * 0.011
            + gt10 * ((1.0 - gt18) * (0.011 + (0.018 - 0.011)
                                      * (wnd - 10.0) / (18.0 - 10.0))
                      + gt18 * 0.018))


def turb_coare3p0(zt, zu, t_s, t_zt, q_s, q_zt, u_zu, niter):
    """COARE 3.0 without skin: (cd, ch, ce, t_zu, q_zu, ub)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log_10, log_zt, log_zu = math.log(10.0), math.log(zt), math.log(zu)
    us, ts, qs, t_zu, q_zu, ub, z0 = first_guess_coare(
        zt, zu, t_s, t_zt, q_s, q_zt, u_zu, charn_coare3p0(u_zu))
    log_z0 = torch.log(z0)
    nu_a = visc_air(t_zt)
    dt = nonzero_delta(t_zu - t_s, 1.0e-9)
    dq = nonzero_delta(q_zu - q_s, 1.0e-12)
    for _ in range(niter):
        us2 = us * us
        one_on_L = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), 200.0)
        gust2 = BETA0 * BETA0 * us2 * pow23_pos(one_on_L * M_ZI0_OV_K)
        ub = maxc(torch.sqrt(u_zu * u_zu + gust2), 0.2)
        zeta_u = clip_mag(zu * one_on_L, ZETA_ABS_MAX)
        if not zt_eq_zu:
            zeta_t = clip_mag(zt * one_on_L, ZETA_ABS_MAX)
        charn = charn_coare3p0(us * _INV_K * (log_10 - log_z0))
        z0 = charn * us2 * _INV_G + 0.11 * nu_a / us
        z0 = minc(maxc(absj(z0), 1.0e-9), 1.0)
        log_z0 = torch.log(z0)
        z0t = minc(Z0T_COEF * (nu_a / (z0 * us)) ** Z0T_POW, Z0T_MAX)
        z0t = minc(maxc(absj(z0t), 1.0e-9), 1.0)
        log_z0t = torch.log(z0t)
        psi_h_u = psi_h_coare(zeta_u)
        fac = VKARMN / (log_zu - log_z0t - psi_h_u)
        ts = dt * fac
        qs = dq * fac
        us = maxc(ub * VKARMN / (log_zu - log_z0 - psi_m_coare(zeta_u)),
                  1.0e-9)
        if not zt_eq_zu:
            prf = log_zt - log_zu + psi_h_u - psi_h_coare(zeta_t)
            t_zu = t_zt - ts * _INV_K * prf
            q_zu = q_zt - qs * _INV_K * prf
            dt = nonzero_delta(t_zu - t_s, 1.0e-9)
            dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    r = us / ub
    cd = maxc(r * r, 0.1e-3)
    ch = maxc(r * ts / dt, 0.1e-3)
    ce = maxc(r * qs / dq, 0.1e-3)
    return cd, ch, ce, t_zu, q_zu, ub


#: the six outputs of a step, in the stateless kernel's order
OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
#: the forcing fields of a record, in the step's order
FORCING = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def flux_step(cfg, sst, t_zt, hum_zt, u_zu, v_zu, slp):
    """The outputs of :data:`OUTPUTS` of ``cfg`` (a mapping with algo, zt,
    zu, niter, use_skin; COARE 3.0 without skin, specific humidity) at
    every point, any shape: the records of a series are independent, so a
    series is one call over all of them."""
    if cfg["algo"] != "coare3p0" or cfg["use_skin"]:
        raise ValueError(f"reference: no stateless step for {cfg['algo']!r}"
                         f" with use_skin={cfg['use_skin']!r}")
    zt, zu, niter = float(cfg["zt"]), float(cfg["zu"]), int(cfg["niter"])
    wnd = torch.sqrt(u_zu * u_zu + v_zu * v_zu)
    ssq = RDCT_QSAT_SALT * q_sat(sst, slp)
    theta_zt = theta_from_z_p0_t_q(zt, slp, t_zt, hum_zt)
    cd, ch, ce, t_zu, q_zu, ub = turb_coare3p0(zt, zu, sst, theta_zt, ssq,
                                               hum_zt, wnd, niter)
    tau, qh, ql, evap = bulk_formula(zu, sst, ssq, t_zu, q_zu, cd, ch, ce,
                                     wnd, ub, slp)
    inv_w = torch.where(wnd > 1.0e-3, 1.0 / maxc(wnd, 1.0e-3), 0.0)
    return ql, qh, tau * inv_w * u_zu, tau * inv_w * v_zu, evap, sst
