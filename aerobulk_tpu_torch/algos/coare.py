"""COARE 3.0 / 3.6 bulk algorithms with cool-skin and warm-layer, on tensors.

``TURB_COARE3P0`` (mod_blk_coare3p0.f90:106-358) and ``TURB_COARE3P6``
(mod_blk_coare3p6.f90:123-413) share one skeleton and differ only in their
Charnock closure, scalar-roughness law, gustiness parameter and the
temperature at which air viscosity is taken: :data:`_VERSIONS`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as c
from ..closures import (charn_coare3p0, charn_coare3p6, charn_coare3p6_wave,
                        first_guess_coare)
from ..skin import cs_coare, init_skin_state_coare, wl_coare
from ..stability import psi_h_coare, psi_m_coare
from ..thermo import (absj, clip_mag, maxc, minc, nonzero_delta, one_on_l,
                      pow23_pos, q_sat, update_qnsol_tau, visc_air)
from .base import FluxResult

_ZI0 = 600.0          # ABL scale height          (mod_blk_coare3p6.f90:61)
_ZETA_ABS_MAX = 50.0  # |zeta| cap                (mod_blk_coare3p6.f90:63)
# constant divides folded into multiplies, as in aerobulk_tpu
_M_ZI0_OV_K = -_ZI0 / c.vkarmn
_INV_K = 1.0 / c.vkarmn
_INV_G = 1.0 / c.grav


class _Version(NamedTuple):
    charn: object
    z0t_max: float
    z0t_coef: float
    z0t_pow: float
    beta0: float        # gustiness parameter: 1.25 (3.0) vs 1.2 (3.6)
    visc_at_tzu: bool   # air viscosity at first-guess t_zu (3.6) or t_zt (3.0)


_VERSIONS = {
    # z0t laws: COARE3.0 eq.28 / COARE3.6 Fairall-2016 private comm.
    # Gustiness beta: mod_blk_coare3p0.f90:47 vs mod_blk_coare3p6.f90:62.
    # Viscosity argument: 3.0 at t_zt (mod_blk_coare3p0.f90:238), 3.6 at
    # the first-guess t_zu (mod_blk_coare3p6.f90:294).
    "coare3p0": _Version(charn_coare3p0, 1.1e-4, 5.5e-5, 0.6, 1.25, False),
    "coare3p6": _Version(charn_coare3p6, 1.6e-4, 5.8e-5, 0.72, 1.2, True),
}


def turb_coare(version, zt, zu, T_s, t_zt, q_s, q_zt, U_zu, niter=5,
               use_cs=False, use_wl=False, Qsw=None, rad_lw=None, slp=None,
               isecday_utc=None, lon=None, skin_state=None,
               rdt=3600.0, gdept=1.0, wave_hs=None, wave_cp=None,
               charn_fn=None):
    """Run one COARE bulk-transfer solve; the arguments are those of
    ``aerobulk_tpu.algos.coare.turb_coare``.  ``zt``/``zu``/``niter`` and
    the skin switches are Python values.  Returns ``(FluxResult, SkinState)``.

    ``charn_fn`` (a Charnock law ``alpha(wind)``) replaces the version's
    own; it may close over tensors, batched ones under ``torch.func.vmap``
    included, and the solve is differentiable with respect to them.  With
    both ``wave_hs`` (significant wave height [m]) and ``wave_cp``
    (dominant phase speed [m/s]), the loop takes the wave-state Charnock
    of COARE 3.5 instead (:func:`charn_coare3p6_wave`); the first guess
    keeps the wind law, as in the reference.

    The warm layer commits its state on every iteration ``jit`` that
    divides ``niter`` (the reference's ``iwait = MOD(nb_iter, jit)``)."""
    ver = _VERSIONS[version]
    charn_of_wind = charn_fn if charn_fn is not None else ver.charn
    use_waves = wave_hs is not None and wave_cp is not None
    zt_eq_zu = abs(zu - zt) < 0.01

    log_10 = math.log(10.0)
    log_zt = math.log(zt)
    log_zu = math.log(zu)

    if use_cs or use_wl:
        if Qsw is None or rad_lw is None or slp is None:
            raise ValueError(
                f"turb_{version}: Qsw, rad_lw & slp required for skin schemes")
    if use_wl and (isecday_utc is None or lon is None):
        raise ValueError(
            f"turb_{version}: isecday_utc & lon required for warm layer")

    if skin_state is None:
        skin_state = init_skin_state_coare(T_s.shape, T_s.dtype, T_s.device)
    state = skin_state

    xSST = T_s
    dT_cs = torch.zeros_like(T_s)
    if use_cs or use_wl:
        if use_cs:
            T_s = T_s - 0.25                       # first guess of correction
        q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

    fg = first_guess_coare(zt, zu, T_s, t_zt, q_s, q_zt, U_zu,
                           charn_of_wind(U_zu))
    us, ts, qs = fg.us, fg.ts, fg.qs
    t_zu, q_zu, Ub = fg.t_zu, fg.q_zu, fg.Ubzu
    z0 = fg.z0
    log_z0 = torch.log(z0)
    nu_a = visc_air(t_zu) if ver.visc_at_tzu else visc_air(t_zt)

    dt = nonzero_delta(t_zu - T_s, 1.0e-9)
    dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    z0t = log_z0t = one_on_L = None
    for jit in range(1, niter + 1):
        us2 = us * us

        one_on_L = one_on_l(t_zu, q_zu, us, ts, qs)
        one_on_L = clip_mag(one_on_L, 200.0)

        # gustiness, Fairall et al. 2003 Eq. 8 (grad-safe clamped power)
        gust2 = (ver.beta0 * ver.beta0 * us2
                 * pow23_pos(one_on_L * _M_ZI0_OV_K))
        Ub = maxc(torch.sqrt(U_zu * U_zu + gust2), 0.2)

        zeta_u = clip_mag(zu * one_on_L, _ZETA_ABS_MAX)
        if not zt_eq_zu:
            zeta_t = clip_mag(zt * one_on_L, _ZETA_ABS_MAX)

        # roughness lengths (z0 from previous-iteration log_z0 via UN10)
        if use_waves:
            charn = charn_coare3p6_wave(us, wave_hs, wave_cp)
        else:
            charn = charn_of_wind(us * _INV_K * (log_10 - log_z0))
        z0 = charn * us2 * _INV_G + 0.11 * nu_a / us
        z0 = minc(maxc(absj(z0), 1.0e-9), 1.0)
        log_z0 = torch.log(z0)

        inv_rer_pow = (nu_a / (z0 * us)) ** ver.z0t_pow  # (1/Re_r)^p
        z0t = minc(ver.z0t_coef * inv_rer_pow, ver.z0t_max)
        z0t = minc(maxc(absj(z0t), 1.0e-9), 1.0)
        log_z0t = torch.log(z0t)

        # turbulent scales at zu
        psi_h_u = psi_h_coare(zeta_u)
        fac = c.vkarmn / (log_zu - log_z0t - psi_h_u)
        ts = dt * fac
        qs = dq * fac
        us = maxc(Ub * c.vkarmn / (log_zu - log_z0 - psi_m_coare(zeta_u)),
                  1.0e-9)

        if not zt_eq_zu:
            prf = log_zt - log_zu + psi_h_u - psi_h_coare(zeta_t)
            t_zu = t_zt - ts * _INV_K * prf
            q_zu = q_zt - qs * _INV_K * prf

        if use_cs:
            Qns, _Tau, Qlat = update_qnsol_tau(
                zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu, Ub, slp, rad_lw)
            dT_cs = cs_coare(Qsw, Qns, us, xSST, Qlat)
            T_s = xSST + dT_cs
            if use_wl:
                T_s = T_s + state.dT_wl
            q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

        if use_wl:
            # the reference commits on iwait = MOD(nb_iter, jit) == 0; on
            # the other iterations WL_COARE has no observable effect.  With
            # cool skin on, T_s is (xSST+dT_wl)+dT_cs here and
            # (xSST+dT_cs)+dT_wl above: the association order of the
            # reference (coare.py:203-206 of aerobulk_tpu).
            if niter % jit == 0:
                Qns, Tau, _ = update_qnsol_tau(
                    zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu, Ub, slp,
                    rad_lw)
                state = wl_coare(Qsw, Qns, Tau, xSST, lon, isecday_utc,
                                 state, rdt=rdt, gdept=gdept)
                T_s = xSST + state.dT_wl
                if use_cs:
                    T_s = T_s + dT_cs
                q_s = c.rdct_qsat_salt * q_sat(maxc(T_s, 200.0), slp)

        if use_cs or use_wl or not zt_eq_zu:
            dt = nonzero_delta(t_zu - T_s, 1.0e-9)
            dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    # transfer coefficients at zu
    r = us / Ub
    Cd = maxc(r * r, c.Cx_min)
    Ch = maxc(r * ts / dt, c.Cx_min)
    Ce = maxc(r * qs / dq, c.Cx_min)

    inv_log = 1.0 / (log_zu - log_z0)
    CdN = maxc(c.vkarmn2 * inv_log * inv_log, c.Cx_min)
    CxN = maxc(c.vkarmn2 * inv_log / (log_zu - log_z0t), c.Cx_min)

    return FluxResult(
        Cd=Cd, Ch=Ch, Ce=Ce, t_zu=t_zu, q_zu=q_zu, Ubzu=Ub,
        T_s=T_s, q_s=q_s,
        CdN=CdN, ChN=CxN, CeN=CxN, z0=z0, u_star=us,
        L=1.0 / one_on_L, UN10=us * _INV_K * (log_10 - log_z0),
        dT_cs=dT_cs, dT_wl=state.dT_wl, Hz_wl=state.Hz_wl), state


def turb_coare3p0(*args, **kw):
    """COARE 3.0 (Fairall et al. 2003). See :func:`turb_coare`."""
    return turb_coare("coare3p0", *args, **kw)


def turb_coare3p6(*args, **kw):
    """COARE 3.6 (Edson et al. 2013). See :func:`turb_coare`."""
    return turb_coare("coare3p6", *args, **kw)
