"""Andreas et al. 2005 (Ice Station Weddell) sea-ice bulk algorithm
(``TURB_ICE_AN05``, mod_blk_ice_an05.f90:51-228): full Monin-Obukhov
iteration with the Andreas-2005 momentum roughness (Eq. 19) and the
3-regime Andreas-1987 polynomial scalar roughnesses (Eq. 22 / Table 1),
Jordan-99 psi functions."""

from __future__ import annotations

import math

import torch

from .. import constants as c
from ..algos.base import FluxResult
from ..stability import psi_h_ice, psi_m_ice
from ..thermo import clip_mag, maxc, nonzero_delta, one_on_l, step, visc_air


def rough_leng_m(us, nua):
    """Momentum roughness of sea ice, Andreas et al. 2005 Eq. 19
    (mod_blk_ice_an05.f90:232-255)."""
    us = maxc(us, 1.0e-9)
    zz = (us - 0.18) / 0.1
    return (0.135 * nua / us
            + 0.035 * us * us / c.grav * (5.0 * torch.exp(-zz * zz) + 1.0))


def rough_leng_tq(z0, us, nua):
    """Scalar roughness lengths (z0t, z0q) of sea ice: Andreas-1987
    3-regime polynomial in ln(Re_r) (mod_blk_ice_an05.f90:257-312).

    The regime masks are the reference's 0.5+SIGN masks, kept as masks:
    for Re_r in (2.49999, 2.5) all three are 0 and z0t = z0q = z0, which an
    if/else chain would lose."""
    us = maxc(us, 1.0e-9)
    re = maxc(us * z0 / nua, 0.0)

    smooth = step(0.135 - re)                 # Re_r <= 0.135
    trans = step(2.49999 - re) - smooth       # 0.135 < Re_r < 2.5
    rough = step(re - 2.5)                    # Re_r >= 2.5

    lg = torch.log(re)
    lg2 = lg * lg

    b0 = smooth * 1.25 + trans * 0.149 + rough * 0.317
    b1 = -trans * 0.550 - rough * 0.565
    b2 = -rough * 0.183
    z0t = z0 * torch.exp(b0 + b1 * lg + b2 * lg2)

    b0 = smooth * 1.61 + trans * 0.351 + rough * 0.396
    b1 = -trans * 0.628 - rough * 0.512
    b2 = -rough * 0.180
    z0q = z0 * torch.exp(b0 + b1 * lg + b2 * lg2)
    return z0t, z0q


def turb_ice_an05(zt, zu, Ts_i, t_zt, qs_i, q_zt, U_zu, niter=5):
    """Andreas-2005 ice transfer coefficients."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log_zu = math.log(zu)

    Ub = maxc(U_zu, c.wspd_thrshld_ice)
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)

    dt = nonzero_delta(t_zu - Ts_i, 1.0e-6)
    dq = nonzero_delta(q_zu - qs_i, 1.0e-9)

    nu_a = visc_air(t_zu)

    # crude first guesses (mod_blk_ice_an05.f90:155-169)
    z0 = torch.full_like(Ub, 8.0e-4)
    us = 0.035 * Ub * torch.log(10.0 / z0) / torch.log(zu / z0)
    z0 = rough_leng_m(us, nu_a)
    for _ in range(2):
        us = maxc(Ub * c.vkarmn / (log_zu - torch.log(z0)), 1.0e-9)
        z0 = rough_leng_m(us, nu_a)
    z0t, z0q = rough_leng_tq(z0, us, nu_a)
    ts = dt * c.vkarmn / torch.log(zu / z0t)
    qs = dq * c.vkarmn / torch.log(zu / z0q)

    for _ in range(niter):
        ool = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), 200.0)
        zeta_u = clip_mag(zu * ool, 50.0)

        z0 = rough_leng_m(us, nu_a)
        z0t, z0q = rough_leng_tq(z0, us, nu_a)

        psi_h_u = psi_h_ice(zeta_u)
        ts = dt * c.vkarmn / (log_zu - torch.log(z0t) - psi_h_u)
        qs = dq * c.vkarmn / (log_zu - torch.log(z0q) - psi_h_u)
        us = maxc(Ub * c.vkarmn / (log_zu - torch.log(z0) - psi_m_ice(zeta_u)),
                  1.0e-9)

        if not zt_eq_zu:
            zeta_t = clip_mag(zt * ool, 50.0)
            prf = math.log(zt / zu) + psi_h_u - psi_h_ice(zeta_t)
            t_zu = t_zt - ts / c.vkarmn * prf
            q_zu = q_zt - qs / c.vkarmn * prf
            dt = nonzero_delta(t_zu - Ts_i, 1.0e-6)
            dq = nonzero_delta(q_zu - qs_i, 1.0e-9)

    r = us / Ub
    Cd = r * r
    Ch = r * ts / dt
    Ce = r * qs / dq

    inv_log = 1.0 / torch.log(zu / z0)
    zeros = torch.zeros_like(Ub)
    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=Ts_i, q_s=qs_i,
        CdN=c.vkarmn2 * inv_log * inv_log,
        ChN=c.vkarmn2 * inv_log / torch.log(zu / z0t),
        CeN=c.vkarmn2 * inv_log / torch.log(zu / z0q),
        z0=z0, u_star=us,
        L=1.0 / one_on_l(t_zu, q_zu, us, ts, qs),
        UN10=us / c.vkarmn * torch.log(10.0 / z0),
        dT_cs=zeros, dT_wl=zeros, Hz_wl=zeros)
