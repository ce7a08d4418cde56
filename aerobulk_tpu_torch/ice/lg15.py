"""Lüpkes & Gryanik 2015 sea-ice bulk algorithm, and its mixed
ice/open-water variant (``TURB_ICE_LG15``, mod_blk_ice_lg15.f90:51-308;
``TURB_ICE_LG15_IO``, mod_blk_ice_lg15_io.f90:55-404): skin + form
neutral coefficients with Louis-1979 stability functions of the bulk
Richardson number, no u* iteration.  ``turb_ice_lg15_io`` evaluates ice
and open-water coefficients in one pass for mixed grid cells.

As in the reference package, the IO variant's water side uses the fixed
open-water roughness rz0_w_0 = 3.27e-4 m where the reference reads
uninitialized memory (mod_blk_ice_lg15_io.f90:292).
"""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..thermo import (cd_from_z0, f_h_louis, f_m_louis, maxc, minc,
                      nonzero_delta, one_on_l, ri_bulk, z0_from_cd)
from .form_drag import cdn_f_lg15_light

RALPHA_0 = 0.2        # Eq. 12 ECHAM6              (mod_blk_ice_lg15.f90:54)
RZ0_I_S_0 = 0.69e-3   # skin roughness, Eq. 43     (mod_blk_ice_lg15.f90:57)
RZ0_I_F_0 = 4.54e-4   # form roughness, MIZ p.562  (mod_blk_ice_lg15.f90:58)
RZ0_W_0 = 3.27e-4     # open-water roughness       (mod_cdn_form_ice.f90:31)


def _neutral_coeffs(zu, z0_s, frice=None, add_form_drag=True):
    """Neutral skin + form coefficients (mod_blk_ice_lg15.f90:186-199)."""
    CdN_s = cd_from_z0(zu, z0_s)
    ChN_s = c.vkarmn2 / (torch.log(zu / z0_s)
                         * torch.log(zu / (RALPHA_0 * z0_s)))  # Eq. 11/12
    if add_form_drag and frice is not None:
        z0_f = torch.full_like(z0_s, RZ0_I_F_0)
        CdN_f = cdn_f_lg15_light(zu, frice, z0_f)
        ChN_f = CdN_f / (1.0 + math.log(1.0 / RALPHA_0) / c.vkarmn
                         * torch.sqrt(CdN_f))                  # Eq. 60/61
    else:
        z0_f = torch.zeros_like(z0_s)
        CdN_f = torch.zeros_like(z0_s)
        ChN_f = torch.zeros_like(z0_s)
    return CdN_s, ChN_s, CdN_f, ChN_f, z0_f


def _lg15_surface(zt, zu, Ts, t_zt, qs, q_zt, Ub, z0_s, CdN_s, ChN_s,
                  CdN_f, ChN_f, z0_f, niter, zt_eq_zu, rib_at_zu=False,
                  with_form=True):
    """One surface's Louis-stability solve (the loop body shared between
    the ice side, and the IO variant's ice and water sides)."""
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)
    dt = nonzero_delta(t_zu - Ts, 1.0e-6)
    dq = nonzero_delta(q_zu - qs, 1.0e-9)

    Cd = CdN_s + CdN_f
    Ch = ChN_s + ChN_f
    Rib = ri_bulk(zt, Ts, t_zt, qs, q_zt, Ub)

    for _ in range(niter):
        if rib_at_zu:
            Rib = ri_bulk(zu, Ts, t_zu, qs, q_zu, Ub)
        else:
            # RiB at zt with the wind adjusted to zt (stability fix,
            # mod_blk_ice_lg15.f90:216-233)
            if not zt_eq_zu:
                CdN_tot = CdN_s + CdN_f
                z0_tot = z0_s + z0_f
                prf = (math.log(zt / zu)
                       + f_h_louis(zu, Rib, CdN_tot, z0_tot)
                       - f_h_louis(zt, Rib, CdN_tot, z0_tot))
                U_zt = maxc(Ub + torch.sqrt(Cd) * Ub * prf,
                            c.wspd_thrshld_ice)
                U_zt = torch.minimum(U_zt, Ub)
            else:
                U_zt = Ub
            Rib = ri_bulk(zt, Ts, t_zt, qs, q_zt, U_zt)

        # Louis-79 stability applied to skin and form parts (Eq. 6 / 10)
        Cd = CdN_s * f_m_louis(zu, Rib, CdN_s, z0_s)
        Ch = ChN_s * f_h_louis(zu, Rib, CdN_s, z0_s)
        if with_form:   # (over water z0_f == 0 would poison f_m_louis)
            Cd = Cd + CdN_f * f_m_louis(zu, Rib, CdN_f, z0_f)
            Ch = Ch + ChN_f * f_h_louis(zu, Rib, CdN_f, z0_f)

        if not zt_eq_zu:
            CdN_tot = CdN_s + CdN_f
            z0_tot = z0_s + z0_f
            prf = (math.log(zt / zu)
                   + f_h_louis(zu, Rib, CdN_tot, z0_tot)
                   - f_h_louis(zt, Rib, CdN_tot, z0_tot))
            inv_sq = 1.0 / torch.sqrt(Cd)
            t_zu = t_zt - (Ch * dt * inv_sq) / c.vkarmn * prf
            q_zu = maxc(q_zt - (Ch * dq * inv_sq) / c.vkarmn * prf, 0.0)
            dt = nonzero_delta(t_zu - Ts, 1.0e-6)
            dq = nonzero_delta(q_zu - qs, 1.0e-9)

    return Cd, Ch, t_zu, q_zu, dt, dq


def _pack_result(zu, Ts, qs, Cd, Ch, t_zu, q_zu, dt, dq, Ub,
                 CdN_s, ChN_s, CdN_f, ChN_f):
    Ce = Ch
    sq = torch.sqrt(Cd)
    us = sq * Ub
    CdN = CdN_s + CdN_f
    zeros = torch.zeros_like(Ub)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=Ts, q_s=qs,
        CdN=CdN, ChN=ChN_s + ChN_f, CeN=ChN_s + ChN_f,
        z0=z0_from_cd(zu, CdN), u_star=us,
        L=1.0 / one_on_l(t_zu, q_zu, us, Ch * dt / sq, Ce * dq / sq),
        UN10=sq * Ub / c.vkarmn * torch.log(10.0 / z0_from_cd(zu, CdN)),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)


def turb_ice_lg15(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, frice, niter=5,
                  add_form_drag=True):
    """LG15 ice transfer coefficients (Louis stability, skin+form drag)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    Ub = maxc(U_zu, c.wspd_thrshld_ice)

    z0_s = torch.full_like(Ub, RZ0_I_S_0)
    CdN_s, ChN_s, CdN_f, ChN_f, z0_f = _neutral_coeffs(
        zu, z0_s, frice, add_form_drag)

    Cd, Ch, t_zu, q_zu, dt, dq = _lg15_surface(
        zt, zu, Ts_i, t_zt, qs_i, q_zt, Ub, z0_s, CdN_s, ChN_s,
        CdN_f, ChN_f, z0_f, niter, zt_eq_zu, with_form=add_form_drag)

    return _pack_result(zu, Ts_i, qs_i, Cd, Ch, t_zu, q_zu, dt, dq, Ub,
                        CdN_s, ChN_s, CdN_f, ChN_f)


def turb_ice_lg15_io(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, frice,
                     Ts_w=None, qs_w=None, niter=5, add_form_drag=True):
    """LG15 for mixed grid cells: returns ``(ice FluxResult, water
    FluxResult or None)``.  The water side uses skin drag only (no form
    drag over open water) with RiB evaluated at zu, as the reference's IO
    variant does (mod_blk_ice_lg15_io.f90:279-295)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    Ub = maxc(U_zu, c.wspd_thrshld_ice)

    z0_s_i = torch.full_like(Ub, RZ0_I_S_0)
    CdN_s, ChN_s, CdN_f, ChN_f, z0_f = _neutral_coeffs(
        zu, z0_s_i, frice, add_form_drag)

    Cd, Ch, t_zu, q_zu, dt, dq = _lg15_surface(
        zt, zu, Ts_i, t_zt, qs_i, q_zt, Ub, z0_s_i, CdN_s, ChN_s,
        CdN_f, ChN_f, z0_f, niter, zt_eq_zu, with_form=add_form_drag)
    res_i = _pack_result(zu, Ts_i, qs_i, Cd, Ch, t_zu, q_zu, dt, dq, Ub,
                         CdN_s, ChN_s, CdN_f, ChN_f)

    if Ts_w is None or qs_w is None:
        return res_i, None

    # water side: skin-only, defined roughness (see module docstring)
    z0_s_w = torch.full_like(Ub, RZ0_W_0)
    CdN_sw, ChN_sw, CdN_fw, ChN_fw, z0_fw = _neutral_coeffs(
        zu, z0_s_w, None, False)
    Cdw, Chw, t_zuw, q_zuw, dtw, dqw = _lg15_surface(
        zt, zu, Ts_w, t_zt, qs_w, q_zt, Ub, z0_s_w, CdN_sw, ChN_sw,
        CdN_fw, ChN_fw, z0_fw, niter, zt_eq_zu, rib_at_zu=True,
        with_form=False)
    res_w = _pack_result(zu, Ts_w, qs_w, Cdw, Chw, t_zuw, q_zuw, dtw, dqw,
                         Ub, CdN_sw, ChN_sw, CdN_fw, ChN_fw)
    return res_i, res_w


def turb_ice_lg15_io_ice(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, frice,
                         niter=5, add_form_drag=True):
    """Ice side of the IO variant, with the same ``FluxResult`` signature
    as the rest of the family: what ``ICE_ALGOS['ice_lg15_io']``
    dispatches to (the water side is reached via
    ``api.flux_step_mixed(simultaneous=True)``)."""
    res_i, _ = turb_ice_lg15_io(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu,
                                frice, niter=niter,
                                add_form_drag=add_form_drag)
    return res_i
