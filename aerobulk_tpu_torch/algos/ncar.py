"""NCAR / Large & Yeager (2004, 2008) bulk algorithm on tensors.

``TURB_NCAR`` (mod_blk_ncar.f90:57-240): no skin scheme, no gustiness
(wind floored at 0.5 m/s), neutral-coefficient closures iterated via L&Y
Eq. 10.  The counterpart of ``aerobulk_tpu.algos.ncar``.
"""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..closures import cd_n10_ncar, ce_n10_ncar, ch_n10_ncar
from ..stability import psi_h_ncar, psi_m_ncar
from ..thermo import (clip_mag, maxc, minc, one_on_l, step, un10_from_cd,
                      virt_temp, z0_from_cd)
from .base import FluxResult


def turb_ncar(zt, zu, sst, t_zt, ssq, q_zt, U_zu, niter=5):
    """Compute NCAR bulk transfer coefficients.

    ``zt``/``zu`` (heights of t/q and wind [m]) and ``niter`` are Python
    values; ``sst`` [K], ``t_zt`` (potential air temperature at zt [K]),
    ``ssq`` (salt-corrected saturation humidity at the SST [kg/kg]),
    ``q_zt`` [kg/kg] and ``U_zu`` (scalar wind at zu [m/s]) are tensors.
    Returns a :class:`FluxResult`."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log1 = math.log(zt / zu)
    log2 = math.log(zu / 10.0)

    Ub = maxc(U_zu, 0.5)

    stab = step(virt_temp(t_zt, q_zt) - virt_temp(sst, ssq))

    CdN = cd_n10_ncar(Ub)
    sqrt_CdN = torch.sqrt(CdN)
    Cd = CdN
    Ce = ce_n10_ncar(sqrt_CdN)
    Ch = ch_n10_ncar(sqrt_CdN, stab)
    sqrt_Cd = sqrt_CdN

    t_zu = maxc(t_zt, 180.0)
    q_zu = maxc(q_zt, 1.0e-6)

    # diagnostics of the last iteration (the reference's scoping)
    ChN = CeN = UN10 = one_on_L = us = None

    for _ in range(niter):
        dt = t_zu - sst
        dq = q_zu - ssq

        # L&Y 2004 Eq. 7 turbulent scales
        us = sqrt_Cd * Ub
        ts = Ch / sqrt_Cd * dt
        qs = Ce / sqrt_Cd * dq

        one_on_L = one_on_l(t_zu, q_zu, us, ts, qs)
        zeta_u = clip_mag(zu * one_on_L, 10.0)

        if not zt_eq_zu:
            zeta_t = clip_mag(zt * one_on_L, 10.0)
            ztmp = log1 + psi_h_ncar(zeta_u) - psi_h_ncar(zeta_t)
            t_zu = t_zt - ts / c.vkarmn * ztmp
            q_zu = maxc(q_zt - qs / c.vkarmn * ztmp, 0.0)

        # L&Y 2004 Eq. 9a: neutral 10-m wind, floored at 0.25 m/s
        psi_m = psi_m_ncar(zeta_u)
        UN10 = maxc(un10_from_cd(zu, Ub, Cd, psi_m), 0.25)
        CdN = cd_n10_ncar(UN10)
        sqrt_CdN = torch.sqrt(CdN)

        # L&Y 2004 Eq. 10a-c transfer-coefficient update
        ztmp = 1.0 + sqrt_CdN / c.vkarmn * (log2 - psi_m)
        Cd = maxc(CdN / (ztmp * ztmp), c.Cx_min)
        sqrt_Cd = torch.sqrt(Cd)
        ztmp = (log2 - psi_h_ncar(zeta_u)) / c.vkarmn / sqrt_CdN
        ztmp2 = sqrt_Cd / sqrt_CdN

        stab = step(zeta_u)
        ChN = 1.0e-3 * sqrt_CdN * (18.0 * stab + 32.7 * (1.0 - stab))
        CeN = 1.0e-3 * (34.6 * sqrt_CdN)

        Ch = maxc(ChN * ztmp2 / (1.0 + ChN * ztmp), c.Cx_min)
        Ce = maxc(CeN * ztmp2 / (1.0 + CeN * ztmp), c.Cx_min)

    zeros = torch.zeros_like(Cd)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=sst, q_s=ssq,
        CdN=CdN, ChN=ChN, CeN=CeN,
        z0=minc(z0_from_cd(zu, CdN), c.z0_sea_max),
        u_star=us, L=1.0 / one_on_L, UN10=UN10,
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
