"""Charnock, neutral-coefficient and u* closures and the COARE first guess
on tensors:
  * charn_coare3p0          mod_blk_coare3p0.f90:420-447
  * charn_coare3p6(_wave)   mod_blk_coare3p6.f90:417-462
  * cd/ch/ce_n10_ncar       mod_blk_ncar.f90:244-328
  * u_star_andreas          mod_blk_andreas.f90:275-304
  * first_guess_coare       mod_common_coare.f90:33-179
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import constants as c
from .stability import psi_h_coare, psi_m_coare
from .thermo import absj, fsign, maxc, minc, ri_bulk, step, visc_air

__all__ = ["charn_coare3p0", "charn_coare3p6", "charn_coare3p6_wave",
           "cd_n10_ncar", "ch_n10_ncar", "ce_n10_ncar", "u_star_andreas",
           "FirstGuess", "first_guess_coare"]


def charn_coare3p0(wnd):
    """COARE 3.0 wind-dependent Charnock parameter: 0.011 below 10 m/s,
    linear to 0.018 at 18 m/s (mod_blk_coare3p0.f90:420-447)."""
    gt10 = step(wnd - 10.0)
    gt18 = step(wnd - 18.0)
    return ((1.0 - gt10) * 0.011
            + gt10 * ((1.0 - gt18) * (0.011 + (0.018 - 0.011)
                                      * (wnd - 10.0) / (18.0 - 10.0))
                      + gt18 * 0.018))


def charn_coare3p6(wnd):
    """COARE 3.6 Charnock, Edson et al. 2013 Eq. 13
    (mod_blk_coare3p6.f90:417-441)."""
    return maxc(minc(0.0017 * wnd - 0.005, 0.028), 0.0)


def charn_coare3p6_wave(us, wsh, wps):
    """Wave-state Charnock (COARE 3.5) of the friction velocity ``us``, the
    significant wave height ``wsh`` and the dominant phase speed ``wps``
    (mod_blk_coare3p6.f90:447-462)."""
    return (wsh * 0.2 * (us / wps) ** 2.2) * c.grav / (us * us)


def cd_n10_ncar(w10):
    """L&Y-2008 Eq. 11 neutral 10-m drag coefficient, incl. the >=33 m/s
    cyclone branch (mod_blk_ncar.f90:244-271)."""
    w = w10
    w6 = (w * w * w) ** 2
    gt33 = step(w - 33.0)
    cdn = 1.0e-3 * ((1.0 - gt33) * (2.7 / w + 0.142 + w / 13.09
                                    - 3.14807e-10 * w6)
                    + gt33 * 2.34)
    return maxc(cdn, c.Cx_min)


def ch_n10_ncar(sqrt_cdn10, stab):
    """L&Y-2008 Eq. 9/12 neutral heat-transfer coefficient; ``stab`` is 1
    (stable) / 0 (unstable) (mod_blk_ncar.f90:287-302)."""
    return maxc(1.0e-3 * sqrt_cdn10 * (18.0 * stab + 32.7 * (1.0 - stab)),
                c.Cx_min)


def ce_n10_ncar(sqrt_cdn10):
    """L&Y-2008 Eq. 9/13 neutral evaporation coefficient
    (mod_blk_ncar.f90:313-321)."""
    return maxc(1.0e-3 * (34.6 * sqrt_cdn10), c.Cx_min)


def u_star_andreas(un10):
    """Direct u*(UN10) closure, Andreas et al. 2015 Eq. 2.2
    (mod_blk_andreas.f90:275-293)."""
    za = un10 - 8.271
    zt = za + torch.sqrt(0.12 * za * za + 0.181)
    return 0.239 + 0.0433 * zt


class FirstGuess(NamedTuple):
    """Output of the COARE-style initialization."""
    us: torch.Tensor     # u* first guess [m/s]
    ts: torch.Tensor     # theta* first guess [K]
    qs: torch.Tensor     # q* first guess [kg/kg]
    t_zu: torch.Tensor   # potential air temp adjusted to zu [K]
    q_zu: torch.Tensor   # specific humidity adjusted to zu [kg/kg]
    Ubzu: torch.Tensor   # bulk wind speed at zu [m/s]
    z0: torch.Tensor     # roughness length [m]


def first_guess_coare(zt, zu, sst, t_zt, ssq, q_zt, U_zu, charn):
    """Fast u*/theta*/q* initialization from a Ri_bulk-based zeta estimate
    (mod_common_coare.f90:33-179).  ``zt``/``zu`` are Python floats."""
    zt_eq_zu = abs(zu - zt) < 0.01

    t_zu = maxc(t_zt, 180.0)
    q_zu = maxc(q_zt, 1.0e-6)

    z0_guess = 0.0001
    log_10 = math.log(10.0)
    log_zt = math.log(zt)
    log_zu = math.log(zu)
    c_a = 0.035 * math.log(10.0 / z0_guess) / math.log(zu / z0_guess)
    c_b = 0.004 * 600.0 * 1.2 ** 3    # zzi0=600, zBeta0=1.2

    dt = t_zu - sst
    dt = fsign(maxc(absj(dt), 1.0e-9), dt)
    dq = q_zu - ssq
    dq = fsign(maxc(absj(dq), 1.0e-12), dq)

    nu_a = visc_air(t_zu)
    Ub = torch.sqrt(U_zu * U_zu + 0.25)  # initial gustiness guess (0.5^2)
    us = c_a * Ub

    z0 = charn * us * us / c.grav + 0.11 * nu_a / us
    z0 = minc(maxc(absj(z0), 1.0e-8), 1.0)
    log_z0 = torch.log(z0)

    Cd = (c.vkarmn / (log_zu - log_z0)) ** 2
    one_on_sqrt_cd10 = (log_10 - log_z0) / c.vkarmn

    z0t = 10.0 / torch.exp(c.vkarmn / (0.00115 * one_on_sqrt_cd10))
    z0t = minc(maxc(absj(z0t), 1.0e-8), 1.0)
    log_z0t = torch.log(z0t)

    Rib = ri_bulk(zu, sst, t_zu, ssq, q_zu, Ub)

    cc = c.vkarmn2 / (Cd * (log_zt - log_z0t))
    cc_ri = cc * Rib
    one_on_Ribcu = -c_b / zu
    stab = step(Rib)
    zeta_u = ((1.0 - stab) * cc_ri / (1.0 + Rib * one_on_Ribcu)
              + stab * (cc_ri + 27.0 / 9.0 * Rib * Rib))

    us = maxc(Ub * c.vkarmn / (log_zu - log_z0 - psi_m_coare(zeta_u)),
              1.0e-9)
    ztmp = c.vkarmn / (log_zu - log_z0t - psi_h_coare(zeta_u))
    ts = dt * ztmp
    qs = dq * ztmp

    if not zt_eq_zu:
        zeta_t = zt * zeta_u / zu
        prf = math.log(zt / zu) + psi_h_coare(zeta_u) - psi_h_coare(zeta_t)
        t_zu = t_zt - ts / c.vkarmn * prf
        q_zu = q_zt - qs / c.vkarmn * prf
        q_zu = step(q_zu) * q_zu   # no negative humidity
        dt = t_zu - sst
        dt = fsign(maxc(absj(dt), 1.0e-9), dt)
        dq = q_zu - ssq
        dq = fsign(maxc(absj(dq), 1.0e-12), dq)
        ts = dt * ztmp
        qs = dq * ztmp

    z0 = charn * us * us / c.grav + 0.11 * nu_a / us
    z0 = minc(maxc(absj(z0), 1.0e-8), 1.0)

    return FirstGuess(us=us, ts=ts, qs=qs, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
                      z0=z0)
