"""EASY sea-ice bulk algorithm (``TURB_ICE_EASY``,
mod_blk_ice_easy.f90:36-209): user-given constant neutral coefficients,
stability-adjusted via a Large & Yeager-form iteration with Jordan-99 psi."""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..stability import psi_h_ice, psi_m_ice
from ..thermo import (clip_mag, maxc, minc, one_on_l, un10_from_cd,
                      z0_from_cd)


def turb_ice_easy(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu,
                  CdN=1.4e-3, ChN=1.4e-3, CeN=1.4e-3, niter=5):
    """Stability-adjust constant neutral ice coefficients.

    ``CdN/ChN/CeN`` are scalar neutral coefficients (Python floats, as in
    the reference where they are scalar INTENT(in) arguments)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    sqrt_CdN = math.sqrt(CdN)
    log1 = math.log(zt / zu)
    log2 = math.log(zu / 10.0)

    Ub = maxc(U_zu, c.wspd_thrshld_ice)
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)

    Cd = torch.full_like(Ub, CdN)
    Ch = torch.full_like(Ub, ChN)
    Ce = torch.full_like(Ub, CeN)

    us = ts = qs = zeta_u = None
    for _ in range(niter):
        dt = t_zu - Ts_i          # NB: no nonzero floor inside the loop
        dq = q_zu - qs_i

        r = torch.sqrt(Cd)
        us = r * Ub
        inv_r = 1.0 / maxc(r, 1.0e-15)
        ts = Ch * dt * inv_r
        qs = Ce * dq * inv_r

        ool = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), 200.0)
        zeta_u = clip_mag(zu * ool, 50.0)

        t0 = 1.0 + sqrt_CdN / c.vkarmn * (log2 - psi_m_ice(zeta_u))
        Cd = minc(maxc(CdN / (t0 * t0), c.Cx_min), 1.9e-3)

        t0 = (log2 - psi_h_ice(zeta_u)) / c.vkarmn / sqrt_CdN
        t1 = torch.sqrt(Cd) / sqrt_CdN
        Ch = minc(maxc(ChN * t1 / (1.0 + ChN * t0), c.Cx_min), 1.9e-3)
        Ce = minc(maxc(CeN * t1 / (1.0 + CeN * t0), c.Cx_min), 1.9e-3)

        if not zt_eq_zu:
            zeta_t = clip_mag(zt * ool, 50.0)
            prf = psi_h_ice(zeta_u) - psi_h_ice(zeta_t) + log1
            t_zu = t_zt - ts / c.vkarmn * prf
            q_zu = maxc(q_zt - qs / c.vkarmn * prf, 0.0)

    psi_m_u = psi_m_ice(zeta_u)
    zeros = torch.zeros_like(Ub)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=Ts_i, q_s=qs_i,
        CdN=torch.full_like(Ub, CdN), ChN=torch.full_like(Ub, ChN),
        CeN=torch.full_like(Ub, CeN),
        z0=z0_from_cd(zu, Cd, psi=psi_m_u), u_star=us,
        L=1.0 / one_on_l(t_zu, q_zu, us, ts, qs),
        UN10=un10_from_cd(zu, Ub, Cd, psi_m_u),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
