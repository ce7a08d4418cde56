"""NEMO-default sea-ice bulk algorithm: constant coefficients
(``TURB_ICE_NEMO``, mod_blk_ice_nemo.f90:34-154): Cd = Ch = Ce = rCd_ice =
1.4e-3, no iteration."""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..thermo import maxc, nonzero_delta, one_on_l, z0_from_cd


def turb_ice_nemo(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, niter=0):
    """Constant-coefficient ice fluxes.  ``niter`` accepted for a uniform
    ice-algo signature but unused (no iteration in this scheme)."""
    del niter
    Ub = maxc(U_zu, c.wspd_thrshld_ice)
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)

    dt = nonzero_delta(t_zu - Ts_i, 1.0e-6)
    dq = nonzero_delta(q_zu - qs_i, 1.0e-9)

    Cd = torch.full_like(Ub, c.rCd_ice)
    sq = math.sqrt(c.rCd_ice)
    us = sq * Ub
    z0 = z0_from_cd(zu, Cd)
    L = 1.0 / one_on_l(t_zu, q_zu, us, sq * dt, sq * dq)

    zeros = torch.zeros_like(Ub)
    return FluxResult(
        Cd=Cd, Ch=Cd, Ce=Cd, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=Ts_i, q_s=qs_i,
        CdN=Cd, ChN=Cd, CeN=Cd, z0=z0, u_star=us, L=L,
        UN10=us / c.vkarmn * torch.log(10.0 / z0),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
