"""The plain reference of the mixed ocean + sea-ice cell: LG15 over the ice
fraction, ECMWF without skin over the leads, the area-weighted net, in
plain PyTorch.

A frozen copy of the eager mixed step of ``aerobulk_tpu_torch``
(``api.flux_step_mixed(ice_algo="ice_lg15", ocean_algo="ecmwf")`` and the
modules under it), cut to what the benchmark's mixed configuration runs:
specific humidity in, the five net outputs the mixed kernel returns.  It
imports nothing of the program and runs in any floating dtype: float64 for
the reference, bfloat16 for the control that must fail the check.  The
helpers the two surfaces share with the ocean reference (thermodynamics
over water, ECMWF's psi functions, COARE's first guess, the water branch
of BULK_FORMULA) are ``aerobulk.py``'s.

The expressions keep the program's association order and the Fortran's
SIGN/MAX/MIN clamps: the over-ice saturation humidity (Goff,
``mod_phymbl.f90:815-904`` with ``l_ice``), ``TURB_ICE_LG15``
(``src/ice/mod_blk_ice_lg15.f90:51-308``: skin roughness plus the form drag
of the ice concentration, Lüpkes & Gryanik 2015 Eq. 46,
``mod_cdn_form_ice.f90:272-306``; Louis-1979 stability of the bulk
Richardson number at zt with the wind brought down to zt; no u*
iteration), ``TURB_ECMWF`` (``mod_blk_ecmwf.f90:63-383``) and
``BULK_FORMULA``'s ice and ocean branches (``mod_phymbl.f90:1149-1203``).

Departures from the Fortran, each the program's:

* the leads run ECMWF without its cool skin and warm layer, as AeroBulk's
  mixed test (``src/ice/test_aerobulk_oce+ice.f90``) runs its ocean side;
  that test pairs ECMWF leads with the nemo and an05 ice algorithms and
  solves LG15_IO on both surfaces at once, where this pairs LG15's ice side
  with ECMWF leads (the repository's BASELINE config 5);
* the net is ``frice * ice + (1 - frice) * ocean`` of every output, T_s
  included, at every point: no land or ice-edge mask;
* over ice the latent heat is sublimation's of the unclamped flux and
  ``Evap`` keeps only its negative part, as ``BULK_FORMULA``'s ``l_ice``
  branch; the stress is its magnitude (the kernel returns no components).
"""

from __future__ import annotations

import math

import torch

from .aerobulk import (CX_MIN, R_DRY, RCP_DRY, RCP_VAP, RCTV0, RDCT_QSAT_SALT,
                       REPS0, RGAMMA_DRY, GRAV, VKARMN, VKARMN2, _exp10, absj,
                       bulk_formula, first_guess_coare, maxc, minc,
                       nonzero_delta, one_on_l, pow23_pos, psi_h_ecmwf,
                       psi_m_ecmwf, q_sat, ri_bulk, step, clip_mag,
                       theta_from_z_p0_t_q, visc_air)

# --- constants (mod_const.f90, mod_phymbl.f90, mod_blk_ice_lg15.f90) -----
RTT0 = 273.16            # triple point [K]
RLSUB = 2.834e6          # latent heat of sublimation [J/kg]
WSPD_THRSHLD_ICE = 0.2   # least scalar wind over ice [m/s]
# Goff over ice (mod_phymbl.f90:143-148)
AG_I, BG_I, CG_I = -9.09718, -3.56654, 0.876793
DG_I = math.log10(6.1071)
# Louis 1979 (mod_phymbl.f90:150-153)
RC2_LOUIS = 5.0 * 5.0
RAM_LOUIS = 2.0 * 5.0
RAH_LOUIS = 3.0 * 5.0
# LG15 (mod_blk_ice_lg15.f90:54-58, mod_cdn_form_ice.f90)
RALPHA_0 = 0.2
RZ0_I_S_0 = 0.69e-3
RZ0_I_F_0 = 4.54e-4
RCE10_I_0 = 3.46e-3
RBETA_0 = 1.4

# --- ECMWF's own constants (mod_blk_ecmwf.f90:51-57) -----------------------
M_ZI0_OV_K = -1000.0 / VKARMN
CHARN0_OV_G = 0.018 / GRAV


# --- the ice surface -------------------------------------------------------

def e_sat_ice(ta):
    ta = maxc(ta, 180.0)
    ztmp = RTT0 / ta
    zle = (AG_I * (ztmp - 1.0) + BG_I * torch.log10(ztmp)
           + CG_I * (1.0 - ta / RTT0) + DG_I)
    return 100.0 * _exp10(zle)


def q_sat_ice(ta, slp):
    es = e_sat_ice(ta)
    return REPS0 * es / (slp - (1.0 - REPS0) * es)


def cd_from_z0(zu, z0):
    r = 1.0 / torch.log(zu / z0)
    return VKARMN2 * r * r


def _louis(zu, rib, cxn, z0, a):
    """Louis 1979's stability function with coefficient ``a`` (10 for
    momentum, 15 for heat; mod_phymbl.f90:1419-1479)."""
    zstab = step(rib)
    ztu = rib / (1.0 + 3.0 * RC2_LOUIS * cxn
                 * torch.sqrt(absj(-rib * (zu / z0 + 1.0))))
    zts = rib / torch.sqrt(absj(1.0 + rib))
    return (1.0 - zstab) * (1.0 - a * ztu) + zstab / (1.0 + a * zts)


def f_m_louis(zu, rib, cdn, z0):
    return _louis(zu, rib, cdn, z0, RAM_LOUIS)


def f_h_louis(zu, rib, chn, z0):
    return _louis(zu, rib, chn, z0, RAH_LOUIS)


def turb_ice_lg15(zt, zu, ts_i, t_zt, qs_i, q_zt, u_zu, frice, niter):
    """LG15's transfer coefficients over ice: (cd, ch, ce, t_zu, q_zu,
    ub)."""
    ub = maxc(u_zu, WSPD_THRSHLD_ICE)
    z0_s = torch.full_like(ub, RZ0_I_S_0)
    cdn_s = cd_from_z0(zu, z0_s)
    chn_s = VKARMN2 / (torch.log(zu / z0_s)
                       * torch.log(zu / (RALPHA_0 * z0_s)))
    z0_f = torch.full_like(z0_s, RZ0_I_F_0)
    rlog = torch.log(10.0 / z0_f) / torch.log(zu / z0_f)
    cdn_f = RCE10_I_0 * rlog * rlog * frice * (1.0 - frice) ** RBETA_0
    chn_f = cdn_f / (1.0 + math.log(1.0 / RALPHA_0) / VKARMN
                     * torch.sqrt(cdn_f))

    zt_eq_zu = abs(zu - zt) < 0.01
    t_zu = maxc(t_zt, 100.0)
    q_zu = maxc(q_zt, 0.1e-6)
    dt = nonzero_delta(t_zu - ts_i, 1.0e-6)
    dq = nonzero_delta(q_zu - qs_i, 1.0e-9)
    cd = cdn_s + cdn_f
    ch = chn_s + chn_f
    rib = ri_bulk(zt, ts_i, t_zt, qs_i, q_zt, ub)

    def profile(rib):
        cdn_tot = cdn_s + cdn_f
        z0_tot = z0_s + z0_f
        return (math.log(zt / zu) + f_h_louis(zu, rib, cdn_tot, z0_tot)
                - f_h_louis(zt, rib, cdn_tot, z0_tot))

    for _ in range(niter):
        if zt_eq_zu:
            u_zt = ub
        else:       # the bulk Richardson number at zt, the wind at zt
            u_zt = maxc(ub + torch.sqrt(cd) * ub * profile(rib),
                        WSPD_THRSHLD_ICE)
            u_zt = torch.minimum(u_zt, ub)
        rib = ri_bulk(zt, ts_i, t_zt, qs_i, q_zt, u_zt)
        cd = cdn_s * f_m_louis(zu, rib, cdn_s, z0_s)
        ch = chn_s * f_h_louis(zu, rib, cdn_s, z0_s)
        cd = cd + cdn_f * f_m_louis(zu, rib, cdn_f, z0_f)
        ch = ch + chn_f * f_h_louis(zu, rib, cdn_f, z0_f)
        if not zt_eq_zu:
            prf = profile(rib)
            inv_sq = 1.0 / torch.sqrt(cd)
            t_zu = t_zt - (ch * dt * inv_sq) / VKARMN * prf
            q_zu = maxc(q_zt - (ch * dq * inv_sq) / VKARMN * prf, 0.0)
            dt = nonzero_delta(t_zu - ts_i, 1.0e-6)
            dq = nonzero_delta(q_zu - qs_i, 1.0e-9)
    return cd, ch, ch, t_zu, q_zu, ub


def bulk_formula_ice(zu, ts, qs, thta, qa, cd, ch, ce, wnd, ub, slp):
    """(Tau, Qsen, Qlat, Evap) over ice."""
    ta = thta - RGAMMA_DRY * zu
    den = R_DRY * ta * (1.0 + RCTV0 * qa)
    rho = maxc(slp / den, 0.8)
    rho = maxc((slp - rho * GRAV * zu) / den, 0.8)
    urho = ub * maxc(rho, 1.0)
    tau = urho * cd * wnd
    evap = urho * ce * (qa - qs)
    qsen = urho * ch * (thta - ts) * (RCP_DRY + RCP_VAP * qa)
    return tau, qsen, RLSUB * evap, minc(evap, 0.0)


# --- the leads: ECMWF without skin ----------------------------------------

def turb_ecmwf(zt, zu, t_s, t_zt, q_s, q_zt, u_zu, niter):
    """ECMWF's transfer coefficients over water, no skin: (cd, ch, ce,
    t_zu, q_zu, ub)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    m_ztzu = 0.0 if zt_eq_zu else 1.0
    log_10, log_zu, log_ztu = math.log(10.0), math.log(zu), math.log(zt / zu)
    us, ts, qs, t_zu, q_zu, ub, z0 = first_guess_coare(
        zt, zu, t_s, t_zt, q_s, q_zt, u_zu, torch.full_like(t_s, 0.018))
    log_z0 = torch.log(z0)
    nu_a = visc_air(t_zt)
    dt = nonzero_delta(t_zu - t_s, 1.0e-9)
    dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    one_on_L = one_on_l(t_zu, q_zu, us, ts, qs)
    zeta_u = zu * one_on_L
    z0t = 1.0 / (0.1 * torch.exp(VKARMN / (0.00115 / (VKARMN
                                                      / (log_10 - log_z0)))))
    z0t = minc(maxc(absj(z0t), 1.0e-9), 1.0)
    log_z0t = torch.log(z0t)
    fm = log_zu - log_z0 - psi_m_ecmwf(zeta_u) + psi_m_ecmwf(z0 * one_on_L)
    psi_h_u = psi_h_ecmwf(zeta_u)
    fh = log_zu - log_z0t - psi_h_u + psi_h_ecmwf(z0t * one_on_L)
    for _ in range(niter):
        rib = ri_bulk(zu, t_s, t_zu, q_s, q_zu, ub)
        one_on_L = clip_mag(rib * fm * fm / fh * (1.0 / zu), 200.0)
        zeta_u = zu * one_on_L
        psi_m_u = psi_m_ecmwf(zeta_u)
        psi_h_u = psi_h_ecmwf(zeta_u)
        psi_h_t = psi_h_ecmwf(zt * one_on_L)
        fm = log_zu - log_z0 - psi_m_u + psi_m_ecmwf(z0 * one_on_L)
        us = ub * VKARMN / fm
        us2 = us * us
        nu_on_us = nu_a / us
        z0 = minc(absj(0.11 * nu_on_us + us2 * CHARN0_OV_G), 0.001)
        z0t = minc(absj(0.40 * nu_on_us), 0.001)
        z0q = minc(absj(0.62 * nu_on_us), 0.001)
        log_z0, log_z0t, log_z0q = torch.log(z0), torch.log(z0t), \
            torch.log(z0q)
        psi_m_z0 = psi_m_ecmwf(z0 * one_on_L)
        psi_h_z0t = psi_h_ecmwf(z0t * one_on_L)
        psi_h_z0q = psi_h_ecmwf(z0q * one_on_L)
        gust2 = us2 * pow23_pos(one_on_L * M_ZI0_OV_K)
        ub = maxc(torch.sqrt(u_zu * u_zu + gust2), 0.2)
        dpsi_t = psi_h_u - psi_h_z0t
        ts = dt * VKARMN / (log_zu - log_z0t - dpsi_t)
        t_zu = t_zt - m_ztzu * ts * (1.0 / VKARMN) * (
            log_ztu + dpsi_t - psi_h_t + psi_h_z0t)
        dpsi_q = psi_h_u - psi_h_z0q
        qs = dq * VKARMN / (log_zu - log_z0q - dpsi_q)
        q_zu = maxc(q_zt - m_ztzu * qs * (1.0 / VKARMN) * (
            log_ztu + dpsi_q - psi_h_t + psi_h_z0q), 0.0)
        fm = log_zu - log_z0 - psi_m_u + psi_m_z0
        fh = log_zu - log_z0t - psi_h_u + psi_h_z0t
        dt = nonzero_delta(t_zu - t_s, 1.0e-9)
        dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    fq = log_zu - log_z0q - psi_h_u + psi_h_z0q
    cd = maxc(VKARMN2 / (fm * fm), CX_MIN)
    ch = maxc(VKARMN2 / (fm * fh), CX_MIN)
    ce = maxc(VKARMN2 / (fm * fq), CX_MIN)
    return cd, ch, ce, t_zu, q_zu, ub


# --- one mixed cell ---------------------------------------------------------

#: the five net outputs, in the mixed kernel's order
OUTPUTS = ("QL", "QH", "Tau", "Evap", "T_s")
#: the forcing fields of a mixed record, in the step's order
FORCING = ("Ts_i", "sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")


def flux_step(cfg, ts_i, sst, t_zt, hum_zt, u_zu, v_zu, slp, frice):
    """The net outputs of :data:`OUTPUTS` of ``cfg`` (a mapping with zt,
    zu, niter; LG15 ice, ECMWF leads, specific humidity) at every point,
    any shape."""
    if cfg["algo"] != "ecmwf" or cfg["ice_algo"] != "ice_lg15":
        raise ValueError(f"reference: no mixed step for {cfg['ice_algo']!r} "
                         f"over {cfg['algo']!r} leads")
    zt, zu, niter = float(cfg["zt"]), float(cfg["zu"]), int(cfg["niter"])
    wnd = torch.sqrt(u_zu * u_zu + v_zu * v_zu)
    theta_zt = theta_from_z_p0_t_q(zt, slp, t_zt, hum_zt)

    qs_i = q_sat_ice(ts_i, slp)
    cd, ch, ce, t_zu, q_zu, ub = turb_ice_lg15(zt, zu, ts_i, theta_zt, qs_i,
                                               hum_zt, wnd, frice, niter)
    ice = bulk_formula_ice(zu, ts_i, qs_i, t_zu, q_zu, cd, ch, ce, wnd, ub,
                           slp)

    ssq = RDCT_QSAT_SALT * q_sat(sst, slp)
    cd, ch, ce, t_zu, q_zu, ub = turb_ecmwf(zt, zu, sst, theta_zt, ssq,
                                            hum_zt, wnd, niter)
    ocean = bulk_formula(zu, sst, ssq, t_zu, q_zu, cd, ch, ce, wnd, ub, slp)

    def blend(i, w):
        return frice * i + (1.0 - frice) * w
    tau, qh, ql, evap = (blend(i, w) for i, w in zip(ice, ocean))
    return ql, qh, tau, evap, blend(ts_i, sst)
