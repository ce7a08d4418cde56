"""Andreas et al. (2015) bulk algorithm on tensors.

``TURB_ANDREAS`` (mod_blk_andreas.f90:66-272): a direct u*(UN10) closure
instead of a drag-coefficient law, LKB scalar roughness, a guard forcing
u* = sqrt(Cx_min)*U in very stable / weak-wind regimes (RiB >= 0.15), and
the floor rCs_min on Ch/Ce.  The counterpart of
``aerobulk_tpu.algos.andreas``.
"""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..closures import u_star_andreas
from ..stability import psi_h_andreas, psi_m_andreas
from ..thermo import (maxc, minc, nonzero_delta, one_on_l, ri_bulk,
                      un10_from_ustar, visc_air, z0_from_cd, z0tq_lkb)
from .base import FluxResult

_RRI_MAX = 0.15       # stable-regime guard       (mod_blk_andreas.f90:54)
_RCS_MIN = 0.35e-3    # Ch/Ce floor               (mod_blk_andreas.f90:56)


def turb_andreas(zt, zu, sst, t_zt, ssq, q_zt, U_zu, niter=5):
    """Compute Andreas-2015 bulk transfer coefficients.  Same input
    contract as :func:`aerobulk_tpu_torch.algos.ncar.turb_ncar`."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log_zu = math.log(zu)

    Ub = maxc(U_zu, 0.25)

    UN10 = Ub
    Cd = torch.full_like(Ub, 1.1e-3)
    Ch = torch.full_like(Ub, 1.1e-3)
    Ce = torch.full_like(Ub, 1.1e-3)
    t_zu = t_zt
    q_zu = q_zt

    sqrt_cd = torch.sqrt(Cd)
    t_star = Ch / sqrt_cd * (t_zu - sst)
    q_star = Ce / sqrt_cd * (q_zu - ssq)

    RiB = ri_bulk(zu, sst, t_zu, ssq, q_zu, Ub)

    u_star = zeta_u = z0 = None
    for jit in range(1, niter + 1):
        u_star = torch.where(RiB < _RRI_MAX, u_star_andreas(UN10),
                             math.sqrt(c.Cx_min) * Ub)

        zeta_u = zu * one_on_l(t_zu, q_zu, u_star, t_star, q_star)

        Cd = maxc((u_star / Ub) ** 2, c.Cx_min)

        z0 = minc(z0_from_cd(zu, Cd, psi=psi_m_andreas(zeta_u)),
                  c.z0_sea_max)

        Rer = z0 * u_star / visc_air(t_zu)
        z0t = z0tq_lkb(1, Rer, z0)
        z0q = z0tq_lkb(2, Rer, z0)

        psi_h = psi_h_andreas(zeta_u)
        t_star = (t_zu - sst) * c.vkarmn / (log_zu - torch.log(z0t) - psi_h)
        q_star = (q_zu - ssq) * c.vkarmn / (log_zu - torch.log(z0q) - psi_h)

        if (not zt_eq_zu) and jit > 1:
            zeta_t = zeta_u / zu * zt
            prf = (math.log(zt / zu) + psi_h_andreas(zeta_u)
                   - psi_h_andreas(zeta_t))
            t_zu = t_zt - t_star / c.vkarmn * prf
            q_zu = q_zt - q_star / c.vkarmn * prf
            RiB = ri_bulk(zu, sst, t_zu, ssq, q_zu, Ub)

        UN10 = maxc(un10_from_ustar(zu, Ub, u_star, psi_m_andreas(zeta_u)),
                    0.1)

    r = u_star / Ub
    Cd = maxc(r * r, c.Cx_min)
    dt = nonzero_delta(t_zu - sst, 1.0e-6)
    dq = nonzero_delta(q_zu - ssq, 1.0e-9)
    Ch = maxc(r * t_star / dt, _RCS_MIN)
    Ce = maxc(r * q_star / dq, _RCS_MIN)

    inv_log = 1.0 / torch.log(zu / z0)
    CdN = maxc(c.vkarmn2 * inv_log * inv_log, c.Cx_min)
    Rer = z0 * u_star / visc_air(t_zu)
    ChN = c.vkarmn2 * inv_log / torch.log(zu / z0tq_lkb(1, Rer, z0))
    CeN = c.vkarmn2 * inv_log / torch.log(zu / z0tq_lkb(2, Rer, z0))

    zeros = torch.zeros_like(Cd)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=sst, q_s=ssq,
        CdN=CdN, ChN=ChN, CeN=CeN, z0=z0, u_star=u_star,
        L=zu / zeta_u,
        UN10=un10_from_ustar(zu, Ub, u_star, psi_m_andreas(zeta_u)),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
