"""ECMWF / IFS (Cy31r1 / Cy40r1) bulk algorithm on tensors.

``TURB_ECMWF`` (mod_blk_ecmwf.f90:63-383).  Unlike COARE, the IFS scheme
iterates on ``Ri_bulk -> 1/L = Ri * Fm^2 / Fh / zu`` (Eq. 3.23, IFS doc
Cy40r1) instead of updating u* directly, keeps separate roughness lengths
z0 / z0t / z0q, and includes psi(z0/L) terms in its profile functions.
The counterpart of ``aerobulk_tpu.algos.ecmwf``, cool skin and warm layer
included.
"""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..closures import first_guess_coare
from ..skin import cs_ecmwf, init_skin_state_ecmwf, wl_ecmwf
from ..stability import psi_h_ecmwf, psi_m_ecmwf
from ..thermo import (absj, clip_mag, maxc, minc, nonzero_delta, one_on_l,
                      pow23_pos, q_sat, ri_bulk, update_qnsol_tau, visc_air)
from .base import FluxResult

CHARN0_ECMWF = 0.018   # IFS Charnock constant     (mod_blk_ecmwf.f90:51)
_ZI0 = 1000.0          # ABL scale height          (mod_blk_ecmwf.f90:53)
_BETA0 = 1.0           # gustiness parameter       (mod_blk_ecmwf.f90:54)
_ALPHA_M = 0.11        # smooth-surface z0 term    (mod_blk_ecmwf.f90:55)
_ALPHA_H = 0.40        # z0t term                  (mod_blk_ecmwf.f90:56)
_ALPHA_Q = 0.62        # z0q term                  (mod_blk_ecmwf.f90:57)
# constant divides folded into multiplies, as in aerobulk_tpu
_M_ZI0_OV_K = -_ZI0 / c.vkarmn
_INV_K = 1.0 / c.vkarmn
_CHARN0_OV_G = CHARN0_ECMWF / c.grav


def turb_ecmwf(zt, zu, T_s, t_zt, q_s, q_zt, U_zu, niter=5,
               use_cs=False, use_wl=False, Qsw=None, rad_lw=None, slp=None,
               skin_state=None, rdt=3600.0, gdept=1.0):
    """Run one ECMWF bulk-transfer solve.  Same contract as
    :func:`aerobulk_tpu_torch.algos.coare.turb_coare` but the warm layer
    needs no solar-time inputs (the prognostic Zeng & Beljaars scheme
    commits on every iteration).  Returns ``(FluxResult, SkinState)``."""
    zt_eq_zu = abs(zu - zt) < 0.01
    m_ztzu = 0.0 if zt_eq_zu else 1.0

    log_10 = math.log(10.0)
    log_zu = math.log(zu)
    log_ztu = math.log(zt / zu)

    if (use_cs or use_wl) and (Qsw is None or rad_lw is None or slp is None):
        raise ValueError("turb_ecmwf: Qsw, rad_lw & slp required for skin")

    if skin_state is None:
        skin_state = init_skin_state_ecmwf(T_s.shape, T_s.dtype, T_s.device)
    state = skin_state

    xSST = T_s
    dT_cs = torch.zeros_like(T_s)
    if use_cs or use_wl:
        if use_cs:
            T_s = T_s - 0.25
        q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

    fg = first_guess_coare(zt, zu, T_s, t_zt, q_s, q_zt, U_zu,
                           torch.full_like(T_s, CHARN0_ECMWF))
    us, ts, qs = fg.us, fg.ts, fg.qs
    t_zu, q_zu, Ub = fg.t_zu, fg.q_zu, fg.Ubzu
    z0 = fg.z0
    log_z0 = torch.log(z0)
    nu_a = visc_air(t_zt)   # NB: at zt in this scheme (mod_blk_ecmwf.f90:238)

    dt = nonzero_delta(t_zu - T_s, 1.0e-9)
    dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    one_on_L = one_on_l(t_zu, q_zu, us, ts, qs)
    zeta_u = zu * one_on_L

    z0t = 1.0 / (0.1 * torch.exp(c.vkarmn / (0.00115 / (c.vkarmn
                                                        / (log_10 - log_z0)))))
    z0t = minc(maxc(absj(z0t), 1.0e-9), 1.0)
    log_z0t = torch.log(z0t)

    # profile functions: u* = Ub * vkarmn / Fm, etc.
    Fm = (log_zu - log_z0 - psi_m_ecmwf(zeta_u)
          + psi_m_ecmwf(z0 * one_on_L))
    psi_h_u = psi_h_ecmwf(zeta_u)
    Fh = log_zu - log_z0t - psi_h_u + psi_h_ecmwf(z0t * one_on_L)

    log_z0q = psi_h_z0q = None
    for _ in range(niter):
        Rib = ri_bulk(zu, T_s, t_zu, q_s, q_zu, Ub)

        # IFS Eq. 3.23: invert Ri_bulk for 1/L
        one_on_L = clip_mag(Rib * Fm * Fm / Fh * (1.0 / zu), 200.0)

        zeta_u = zu * one_on_L
        psi_m_u = psi_m_ecmwf(zeta_u)
        psi_h_u = psi_h_ecmwf(zeta_u)
        zeta_t = zt * one_on_L
        psi_h_t = psi_h_ecmwf(zeta_t)

        Fm = log_zu - log_z0 - psi_m_u + psi_m_ecmwf(z0 * one_on_L)

        us = Ub * c.vkarmn / Fm
        us2 = us * us
        nu_on_us = nu_a / us
        z0 = minc(absj(_ALPHA_M * nu_on_us + us2 * _CHARN0_OV_G), 0.001)
        z0t = minc(absj(_ALPHA_H * nu_on_us), 0.001)
        z0q = minc(absj(_ALPHA_Q * nu_on_us), 0.001)
        log_z0 = torch.log(z0)
        log_z0t = torch.log(z0t)
        log_z0q = torch.log(z0q)

        psi_m_z0 = psi_m_ecmwf(z0 * one_on_L)
        psi_h_z0t = psi_h_ecmwf(z0t * one_on_L)
        psi_h_z0q = psi_h_ecmwf(z0q * one_on_L)

        # gustiness (IFS Cy31r1 Eq. 3.17/3.18 + 3.8)
        gust2 = (_BETA0 * _BETA0 * us2
                 * pow23_pos(one_on_L * _M_ZI0_OV_K))
        Ub = maxc(torch.sqrt(U_zu * U_zu + gust2), 0.2)

        # scalar profiles & height adjustment
        dpsi_t = psi_h_u - psi_h_z0t
        ts = dt * c.vkarmn / (log_zu - log_z0t - dpsi_t)
        t_zu = t_zt - m_ztzu * ts * _INV_K * (
            log_ztu + dpsi_t - psi_h_t + psi_h_z0t)

        dpsi_q = psi_h_u - psi_h_z0q
        qs = dq * c.vkarmn / (log_zu - log_z0q - dpsi_q)
        q_zu = maxc(
            q_zt - m_ztzu * qs * _INV_K * (
                log_ztu + dpsi_q - psi_h_t + psi_h_z0q), 0.0)

        Fm = log_zu - log_z0 - psi_m_u + psi_m_z0
        Fh = log_zu - log_z0t - psi_h_u + psi_h_z0t

        if use_cs:
            Qns, _Tau, _ = update_qnsol_tau(
                zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu, Ub, slp, rad_lw)
            dT_cs = cs_ecmwf(Qsw, Qns, us, xSST)
            T_s = xSST + dT_cs
            if use_wl:
                T_s = T_s + state.dT_wl
            q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

        if use_wl:
            Qns, _Tau, _ = update_qnsol_tau(
                zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu, Ub, slp, rad_lw)
            state = wl_ecmwf(Qsw, Qns, us, xSST, state, rdt=rdt, gdept=gdept)
            T_s = xSST + state.dT_wl
            if use_cs:
                T_s = T_s + dT_cs
            q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

        dt = nonzero_delta(t_zu - T_s, 1.0e-9)
        dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    Fq = log_zu - log_z0q - psi_h_u + psi_h_z0q
    Cd = maxc(c.vkarmn2 / (Fm * Fm), c.Cx_min)
    Ch = maxc(c.vkarmn2 / (Fm * Fh), c.Cx_min)
    Ce = maxc(c.vkarmn2 / (Fm * Fq), c.Cx_min)

    inv_log = 1.0 / (log_zu - log_z0)
    CdN = maxc(c.vkarmn2 * inv_log * inv_log, c.Cx_min)
    CxN = maxc(c.vkarmn2 * inv_log / (log_zu - log_z0t), c.Cx_min)

    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=T_s, q_s=q_s,
        CdN=CdN, ChN=CxN, CeN=CxN, z0=z0, u_star=us,
        L=1.0 / one_on_L, UN10=us * _INV_K * (log_10 - log_z0),
        dT_cs=dT_cs, dT_wl=state.dT_wl, Hz_wl=state.Hz_wl), state
