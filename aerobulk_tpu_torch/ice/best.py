"""ECHAM6-flavoured Lüpkes-2015 sea-ice bulk algorithm "BEST"
(``TURB_ICE_BEST``, mod_blk_ice_best.f90:46-293): the Cx_Lupkes2015
closure (A-weighted skin+form neutral coefficients with Louis-79
stability, ECHAM6 constants) in a Large & Yeager-style iteration with
Jordan-99 psi functions."""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..stability import psi_h_ice, psi_m_ice
from ..thermo import (clip_mag, f_h_louis, f_m_louis, maxc, one_on_l,
                      ri_bulk, z0_from_cd)

# ECHAM6 constants (mod_blk_ice_best.f90:30-41)
_Z0_SKIN_ICE = 0.69e-3   # Eq. 43 [m]
_Z0_FORM_ICE = 0.57e-3   # Eq. 42 [m]
_Z0_ICE = 1.00e-3        # Eq. 15 [m]
_ZCE10 = 2.80e-3         # Eq. 41
_ZBETA = 1.1             # Eq. 41
_Z1_ALPHA = 1.0 / 0.2    # Eq. 51
_Z1_ALPHAF = _Z1_ALPHA   # Eq. 56


def cx_lupkes2015(zu, t_zu, q_zu, Ui_zu, Ts_i, qs_i):
    """100%-ice Lüpkes-2015/ECHAM6 transfer coefficients
    (mod_blk_ice_best.f90:209-293).  Returns (Cd, Ch).

    NB: the reference hardcodes ice fraction zfi=1 and open-water fraction
    zfo=0, which makes its form-drag term vanish (the "WHAT????" comment
    at mod_blk_ice_best.f90:276) — reproduced faithfully, in Python floats
    as in the reference package."""
    cdn_form_tmp = _ZCE10 * (math.log(10.0 / _Z0_FORM_ICE + 1.0)
                             / math.log(zu / _Z0_FORM_ICE + 1.0)) ** 2  # Eq.46
    cdn_skin_ice = (c.vkarmn / math.log(zu / _Z0_SKIN_ICE + 1.0)) ** 2  # Eq.7
    cdn_ice = cdn_skin_ice

    chn_skin_ice = c.vkarmn2 / (math.log(zu / _Z0_ICE + 1.0)
                                * math.log(zu * _Z1_ALPHA / _Z0_SKIN_ICE
                                           + 1.0))       # Eq. 50 + 52

    zfi, zfo = 1.0, 0.0
    wndspd = maxc(Ui_zu, 0.5)
    rib = ri_bulk(zu, Ts_i, t_zu, qs_i, q_zu, wndspd)

    cdn_form_ice = cdn_form_tmp * zfi * zfo ** _ZBETA    # == 0 (see docstring)
    chn_form_ice = cdn_form_ice / (1.0 + math.log(_Z1_ALPHAF) / c.vkarmn
                                   * math.sqrt(cdn_form_ice))

    fmi = f_m_louis(zu, rib, cdn_ice, _Z0_SKIN_ICE)
    fhi = f_h_louis(zu, rib, cdn_ice, _Z0_SKIN_ICE)

    inv_fi = 1.0 / max(1.0e-6, zfi)
    Cd = cdn_skin_ice * fmi + cdn_form_ice * (fmi * zfi) * inv_fi
    Ch = chn_skin_ice * fhi + chn_form_ice * (fhi * zfi) * inv_fi
    return Cd, Ch


def turb_ice_best(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, niter=5):
    """ECHAM6/Lüpkes-2015 ice transfer coefficients."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log_zu10 = math.log(zu / 10.0)

    Ub = maxc(U_zu, c.wspd_thrshld_ice)
    t_zu = t_zt
    q_zu = q_zt

    Cd, Ch = cx_lupkes2015(zu, t_zu, q_zu, Ub, Ts_i, qs_i)
    Ce = Ch
    sqrt_Cd = torch.sqrt(Cd)
    sqrt_Cdn10 = sqrt_Cd

    zeta_u = None
    for _ in range(niter):
        dt = t_zu - Ts_i
        dq = q_zu - qs_i

        us = sqrt_Cd * Ub
        ts = Ch / sqrt_Cd * dt
        qs = Ce / sqrt_Cd * dq

        ool = one_on_l(t_zu, q_zu, us, ts, qs)
        zeta_u = clip_mag(zu * ool, 10.0)

        if not zt_eq_zu:
            zeta_t = clip_mag(zt * ool, 10.0)
            prf = math.log(zt / zu) + psi_h_ice(zeta_u) - psi_h_ice(zeta_t)
            t_zu = t_zt - ts / c.vkarmn * prf
            q_zu = maxc(q_zt - qs / c.vkarmn * prf, 0.0)

        psi_m_u = psi_m_ice(zeta_u)
        un10 = maxc(
            Ub / (1.0 + sqrt_Cdn10 / c.vkarmn * (log_zu10 - psi_m_u)),
            c.wspd_thrshld_ice)

        Cd, Cx_n10 = cx_lupkes2015(zu, t_zu, q_zu, un10, Ts_i, qs_i)
        sqrt_Cdn10 = torch.sqrt(Cd)

        t1 = 1.0 + sqrt_Cdn10 / c.vkarmn * (log_zu10 - psi_m_u)
        Cd = Cd / (t1 * t1)
        sqrt_Cd = torch.sqrt(Cd)

        t0 = (log_zu10 - psi_h_ice(zeta_u)) / c.vkarmn / sqrt_Cdn10
        t2 = sqrt_Cd / sqrt_Cdn10
        Ch = Cx_n10 * t2 / (1.0 + Cx_n10 * t0)
        Ce = Ch

    psi_m_u = psi_m_ice(zeta_u)
    dt = t_zu - Ts_i
    dq = q_zu - qs_i
    us = sqrt_Cd * Ub
    zeros = torch.zeros_like(Ub)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=Ts_i, q_s=qs_i,
        CdN=sqrt_Cdn10 ** 2, ChN=Ch, CeN=Ce,
        z0=z0_from_cd(zu, Cd, psi=psi_m_u), u_star=us,
        L=zu / zeta_u,
        UN10=Ub / (1.0 + sqrt_Cdn10 / c.vkarmn * (log_zu10 - psi_m_u)),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
