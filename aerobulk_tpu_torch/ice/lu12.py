"""Lüpkes et al. 2012 sea-ice bulk algorithm, neutral only
(``TURB_ICE_LU12``, mod_blk_ice_lu12.f90:51-215): Cd = Cd_from_z0(zu,
z0_skin=0.69e-3) + CdN10_f_LU13(A); Ch = Ce = Cd; no stability iteration."""

from __future__ import annotations

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..thermo import cd_from_z0, maxc, nonzero_delta, one_on_l, z0_from_cd
from .form_drag import cdn10_f_lu13

RZ0_I_S_0 = 0.69e-3   # LG15 Eq. 43 skin roughness  (mod_blk_ice_lu12.f90:63)


def turb_ice_lu12(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, frice, niter=0):
    """Lüpkes-2012 neutral ice coefficients (skin + LU13 form drag)."""
    del niter
    Ub = maxc(U_zu, c.wspd_thrshld_ice)
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)

    dt = nonzero_delta(t_zu - Ts_i, 1.0e-6)
    dq = nonzero_delta(q_zu - qs_i, 1.0e-9)

    z0_skin = torch.full_like(Ub, RZ0_I_S_0)
    Cd = cd_from_z0(zu, z0_skin) + cdn10_f_lu13(frice)

    sq = torch.sqrt(Cd)
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
