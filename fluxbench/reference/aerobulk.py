"""The plain reference of the benchmark: one stateful AeroBulk step, COARE
3.6 or ECMWF with cool skin and warm layer, and the record loop over it, in
plain PyTorch.

A frozen copy of the eager step of ``aerobulk_tpu_torch`` (``api.flux_step``
and the modules under it), cut to what the benchmark's configurations run:
specific humidity in, both skin schemes on, the six outputs the fused kernel
returns.  It imports nothing of the program, so a later change to the
program cannot move it, and it runs in any floating dtype: float64 for the
reference, bfloat16 for the control that must fail the check.

The expressions keep the reference Fortran's association order and its
SIGN/MAX/MIN clamps (``mod_phymbl.f90``, ``mod_blk_coare3p6.f90``,
``mod_blk_ecmwf.f90``, ``mod_skin_coare.f90``, ``mod_skin_ecmwf.f90``), and
the derivative conventions of the JAX package at the points where a function
is not differentiable (``MAX``/``MIN`` split a tie's gradient, ``|x|`` has
slope 1 at 0, ``SIGN(a, b)`` slope sign(b) at a = 0), so that autograd
through it gives the gradient the program's kernels are held to.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

# --- constants (mod_const.f90) -------------------------------------------
GRAV = 9.8
RPI = math.pi
ROCE_ALB0 = 0.066
EMISS_W = 0.98
STEFAN = 5.67e-8
RT0 = 273.15
RCP0_W = 4190.0
RHO0_W = 1025.0
RNU0_W = 1.0e-6
RK0_W = 0.6
RCP_DRY = 1005.0
RCP_VAP = 1860.0
R_DRY = 287.05
R_VAP = 461.495
R_GAS = 8.314510
RMM_DRYAIR = 28.9647e-3
RMM_WATER = 18.0153e-3
RPOISS_DRY = R_DRY / RCP_DRY
RGAMMA_DRY = GRAV / RCP_DRY
REPS0 = R_DRY / R_VAP
RCTV0 = R_VAP / R_DRY - 1.0
RLEVAP = 2.46e6
RHO0_A = 1.2
VKARMN = 0.4
VKARMN2 = VKARMN * VKARMN
RDCT_QSAT_SALT = 0.98
RCST_CS = (-16.0 * 9.80665 * RHO0_W * RCP0_W * RNU0_W ** 3
           / (RK0_W * RK0_W))
SQ_RADRW = math.sqrt(RHO0_A / RHO0_W)
CX_MIN = 0.1e-3

HWL_MAX = 20.0     # COARE's largest warm-layer depth [m]
RICH0 = 0.65       # critical Richardson number
RD0_ECMWF = 3.0    # ECMWF's fixed warm-layer depth [m]
RNUWL0 = 0.5       # ECMWF's temperature-profile exponent


class SkinState(NamedTuple):
    """Warm-layer memory, one value per point (ECMWF uses ``dT_wl`` and a
    constant ``Hz_wl``)."""
    dT_wl: torch.Tensor
    Hz_wl: torch.Tensor
    Qnt_ac: torch.Tensor
    Tau_ac: torch.Tensor


def init_state(algo, shape, dtype, device):
    """A fresh warm-layer state: no layer, at the scheme's depth."""
    z = torch.zeros(shape, dtype=dtype, device=device)
    depth = RD0_ECMWF if algo == "ecmwf" else HWL_MAX
    return SkinState(z, torch.full(shape, depth, dtype=dtype, device=device),
                     z, z)


# --- clamps with the JAX package's derivatives ----------------------------

@functools.lru_cache(maxsize=None)
def _const(value, dtype):
    # a 0-d CPU tensor goes to a kernel on any device as a scalar
    return torch.tensor(value, dtype=dtype)


def maxc(x, c):
    return torch.maximum(x, _const(c, x.dtype))


def minc(x, c):
    return torch.minimum(x, _const(c, x.dtype))


class _AbsJ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, grad, -grad)


def absj(x):
    """|x| with slope 1 at 0."""
    return _AbsJ.apply(x) if x.requires_grad else torch.abs(x)


class _FSign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.copysign(torch.abs(a), b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        flip = torch.signbit(b) ^ ~(a >= 0.0)
        return torch.where(flip, -grad, grad), None


def fsign(a, b):
    """Fortran SIGN(a, b): |a| with the sign bit of b."""
    if a.requires_grad:
        return _FSign.apply(a, b)
    return torch.copysign(torch.abs(a), b)


def step(x):
    """0.5 + SIGN(0.5, x): 1 where x >= 0, else 0."""
    return (x >= 0.0).to(x.dtype)


def clip_mag(x, cap):
    return fsign(minc(absj(x), cap), x)


def nonzero_delta(dx, floor):
    return fsign(maxc(absj(dx), floor), dx)


def pow23_pos(x):
    """MAX(x, 0)**(2/3), with a finite slope at the clamp."""
    pos = x > 0.0
    return torch.where(pos, torch.where(pos, x, 1.0) ** (2.0 / 3.0), 0.0)


def _pos_or_one(a):
    return torch.where(a > 0.0, a, 1.0)


# --- thermodynamics (mod_phymbl.f90) --------------------------------------

def _exp10(x):
    return torch.exp2(x * math.log2(10.0))


def e_sat(ta):
    ta = maxc(ta, 180.0)
    ztmp = RT0 / ta
    zr = ta / RT0
    return 100.0 * _exp10(
        10.79574 * (1.0 - ztmp)
        - 5.028 * torch.log10(zr)
        + 1.50475e-4 * (1.0 - _exp10(-8.2969 * (zr - 1.0)))
        + 0.42873e-3 * (_exp10(4.76955 * (1.0 - ztmp)) - 1.0)
        + 0.78614)


def q_sat(ta, slp):
    es = e_sat(ta)
    return REPS0 * es / (slp - (1.0 - REPS0) * es)


def theta_from_z_p0_t_q(z, slp, ta, qa):
    es = e_sat(ta)
    pa = slp
    for _ in range(3):
        qsat = REPS0 * es / (pa - (1.0 - REPS0) * es)
        f = qa / qsat
        xm = (1.0 - f) * RMM_DRYAIR + f * RMM_WATER
        pa = slp * torch.exp(-GRAV * xm * z / (R_GAS * ta))
    return ta * (slp / pa) ** RPOISS_DRY


def visc_air(ta):
    tc = ta - RT0
    tc2 = tc * tc
    return 1.326e-5 * (1.0 + 6.542e-3 * tc + 8.301e-6 * tc2
                       - 4.84e-9 * tc2 * tc)


def l_vap(sst):
    return (2.501 - 0.00237 * (sst - RT0)) * 1.0e6


def one_on_l(thta, qa, us, ts, qs):
    zqa = 1.0 + RCTV0 * qa
    ool = GRAV * VKARMN * (ts * zqa + RCTV0 * thta * qs) / maxc(
        us * us * thta * zqa, 1.0e-9)
    return clip_mag(ool, 200.0)


def virt_temp(ta, qa):
    return ta * (1.0 + RCTV0 * qa)


def ri_bulk(z, sst, thta, ssq, qa, ub):
    sstv = virt_temp(sst, ssq)
    dthv = virt_temp(thta, qa) - sstv
    tv = 0.5 * (sstv + virt_temp(thta - RGAMMA_DRY * z, qa))
    return GRAV * dthv * z / (tv * ub * ub)


def bulk_formula(zu, ts, qs, thta, qa, cd, ch, ce, wnd, ub, slp):
    """(Tau, Qsen, Qlat, Evap) over water."""
    ta = thta - RGAMMA_DRY * zu
    den = R_DRY * ta * (1.0 + RCTV0 * qa)
    rho = maxc(slp / den, 0.8)
    rho = maxc((slp - rho * GRAV * zu) / den, 0.8)
    urho = ub * maxc(rho, 1.0)
    tau = urho * cd * wnd
    evap = urho * ce * (qa - qs)
    qsen = urho * ch * (thta - ts) * (RCP_DRY + RCP_VAP * qa)
    return tau, qsen, l_vap(ts) * evap, evap


def update_qnsol_tau(zu, ts, qs, thta, qa, ust, tst, qst, wnd, ub, slp,
                     rlw):
    """(Qns, Tau, Qlat)."""
    zdt = nonzero_delta(thta - ts, 1.0e-9)
    zdq = nonzero_delta(qa - qs, 1.0e-12)
    z0 = ust / ub
    tau, qsen, qlat, _ = bulk_formula(zu, ts, qs, thta, qa, z0 * z0,
                                      z0 * tst / zdt, z0 * qst / zdq, wnd,
                                      ub, slp)
    t2 = ts * ts
    qlw = EMISS_W * (rlw - STEFAN * t2 * t2)
    return qlat + qsen + qlw, tau, qlat


def alpha_sw(sst):
    x = maxc(sst - RT0 + 3.2, 0.0)
    pos = x > 0.0
    return 2.1e-5 * torch.where(pos, torch.where(pos, x, 1.0) ** 0.79, 0.0)


def _inv_cbrt_1p(s):
    root = torch.pow(1.0 + s, 1.0 / 3.0)
    return torch.ones_like(root) / root


def _skin_layer_coefs(alpha, ustar, qlat):
    usw = maxc(ustar, 1.0e-4) * SQ_RADRW
    inv_usw = 1.0 / usw
    inv2 = inv_usw * inv_usw
    coef_y = alpha * RCST_CS * (inv2 * inv2)
    ztmp = RNU0_W * inv_usw
    corr = None
    if qlat is not None:
        corr = 0.026 * minc(qlat, 0.0) * RCP0_W / RLEVAP / alpha
    return coef_y, ztmp, corr


def _delta_skin_layer(coefs, qd):
    coef_y, ztmp, corr = coefs
    zqd = qd if corr is None else qd + corr
    ztf = step(zqd)
    zy = coef_y * zqd
    pos = zy > 0.0
    zs = torch.sqrt(torch.where(pos, zy, 1.0))
    lamb = 6.0 * _inv_cbrt_1p(torch.where(pos, zs * torch.sqrt(zs), 0.0))
    return (1.0 - ztf) * lamb * ztmp + ztf * minc(6.0 * ztmp, 0.007)


# --- stability (mod_common_coare.f90, mod_blk_ecmwf.f90) -----------------

_INV_3 = 1.0 / 3.0
_INV_SQRT3 = 1.0 / 1.7320508


def psi_m_coare(zeta):
    phi_m = torch.sqrt(torch.sqrt(_pos_or_one(absj(1.0 - 15.0 * zeta))))
    psi_k = (2.0 * torch.log((1.0 + phi_m) * 0.5)
             + torch.log((1.0 + phi_m * phi_m) * 0.5)
             - 2.0 * torch.atan(phi_m) + 0.5 * RPI)
    phi_c = _pos_or_one(absj(1.0 - 10.15 * zeta)) ** 0.3333
    psi_c = (1.5 * torch.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * torch.atan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
             + 1.813799447)
    f = zeta * zeta
    f = f / (1.0 + f)
    cc = minc(0.35 * zeta, 50.0)
    stb = step(zeta)
    return ((1.0 - stb) * ((1.0 - f) * psi_k + f * psi_c)
            - stb * (1.0 + zeta
                     + 0.6667 * (zeta - 14.28) * torch.exp(-cc) + 8.525))


def psi_h_coare(zeta):
    phi_h = torch.sqrt(_pos_or_one(absj(1.0 - 15.0 * zeta)))
    psi_k = 2.0 * torch.log((1.0 + phi_h) * 0.5)
    phi_c = _pos_or_one(absj(1.0 - 34.15 * zeta)) ** 0.3333
    psi_c = (1.5 * torch.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * torch.atan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
             + 1.813799447)
    f = zeta * zeta
    f = f / (1.0 + f)
    cc = minc(0.35 * zeta, 50.0)
    stb = step(zeta)
    x32 = absj(1.0 + zeta * (2.0 / 3.0))
    x32 = x32 * torch.sqrt(_pos_or_one(x32))
    return ((1.0 - stb) * ((1.0 - f) * psi_k + f * psi_c)
            - stb * (x32
                     + 0.6667 * (zeta - 14.28) * torch.exp(-cc) + 8.525))


_ZC_ECMWF = 5.0 / 0.35


def _cap_zeta_ecmwf(zeta):
    return minc(maxc(zeta, -50.0), 5.0)


def psi_m_ecmwf(zeta):
    zta = _cap_zeta_ecmwf(zeta)
    x2 = torch.sqrt(_pos_or_one(absj(1.0 - 16.0 * zta)))
    x = torch.sqrt(x2)
    t = 1.0 + x
    psi_unst = (torch.log(0.125 * t * t * (1.0 + x2))
                - 2.0 * torch.atan(x) + 0.5 * RPI)
    psi_stab = (-2.0 / 3.0 * (zta - _ZC_ECMWF) * torch.exp(-0.35 * zta)
                - zta - 2.0 / 3.0 * _ZC_ECMWF)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_ecmwf(zeta):
    zta = _cap_zeta_ecmwf(zeta)
    x2 = torch.sqrt(_pos_or_one(absj(1.0 - 16.0 * zta)))
    psi_unst = 2.0 * torch.log(0.5 * (1.0 + x2))
    x32 = absj(1.0 + 2.0 / 3.0 * zta)
    x32 = x32 * torch.sqrt(_pos_or_one(x32))
    psi_stab = (-2.0 / 3.0 * (zta - _ZC_ECMWF) * torch.exp(-0.35 * zta)
                - x32 - 2.0 / 3.0 * _ZC_ECMWF + 1.0)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# --- the COARE first guess (mod_common_coare.f90:33-179) ------------------

def charn_coare3p6(wnd):
    return maxc(minc(0.0017 * wnd - 0.005, 0.028), 0.0)


def first_guess_coare(zt, zu, sst, t_zt, ssq, q_zt, u_zu, charn):
    """(us, ts, qs, t_zu, q_zu, Ub, z0)."""
    zt_eq_zu = abs(zu - zt) < 0.01
    t_zu = maxc(t_zt, 180.0)
    q_zu = maxc(q_zt, 1.0e-6)
    z0_guess = 0.0001
    log_10, log_zt, log_zu = math.log(10.0), math.log(zt), math.log(zu)
    c_a = 0.035 * math.log(10.0 / z0_guess) / math.log(zu / z0_guess)
    c_b = 0.004 * 600.0 * 1.2 ** 3

    dt = t_zu - sst
    dt = fsign(maxc(absj(dt), 1.0e-9), dt)
    dq = q_zu - ssq
    dq = fsign(maxc(absj(dq), 1.0e-12), dq)

    nu_a = visc_air(t_zu)
    ub = torch.sqrt(u_zu * u_zu + 0.25)
    us = c_a * ub
    z0 = charn * us * us / GRAV + 0.11 * nu_a / us
    z0 = minc(maxc(absj(z0), 1.0e-8), 1.0)
    log_z0 = torch.log(z0)
    cd = (VKARMN / (log_zu - log_z0)) ** 2
    one_on_sqrt_cd10 = (log_10 - log_z0) / VKARMN
    z0t = 10.0 / torch.exp(VKARMN / (0.00115 * one_on_sqrt_cd10))
    z0t = minc(maxc(absj(z0t), 1.0e-8), 1.0)
    log_z0t = torch.log(z0t)

    rib = ri_bulk(zu, sst, t_zu, ssq, q_zu, ub)
    cc = VKARMN2 / (cd * (log_zt - log_z0t))
    cc_ri = cc * rib
    one_on_ribcu = -c_b / zu
    stab = step(rib)
    zeta_u = ((1.0 - stab) * cc_ri / (1.0 + rib * one_on_ribcu)
              + stab * (cc_ri + 27.0 / 9.0 * rib * rib))

    us = maxc(ub * VKARMN / (log_zu - log_z0 - psi_m_coare(zeta_u)), 1.0e-9)
    ztmp = VKARMN / (log_zu - log_z0t - psi_h_coare(zeta_u))
    ts = dt * ztmp
    qs = dq * ztmp
    if not zt_eq_zu:
        zeta_t = zt * zeta_u / zu
        prf = math.log(zt / zu) + psi_h_coare(zeta_u) - psi_h_coare(zeta_t)
        t_zu = t_zt - ts / VKARMN * prf
        q_zu = q_zt - qs / VKARMN * prf
        q_zu = step(q_zu) * q_zu
        dt = t_zu - sst
        dt = fsign(maxc(absj(dt), 1.0e-9), dt)
        dq = q_zu - ssq
        dq = fsign(maxc(absj(dq), 1.0e-12), dq)
        ts = dt * ztmp
        qs = dq * ztmp
    z0 = charn * us * us / GRAV + 0.11 * nu_a / us
    z0 = minc(maxc(absj(z0), 1.0e-8), 1.0)
    return us, ts, qs, t_zu, q_zu, ub, z0


# --- cool skin and warm layers (mod_skin_coare.f90, mod_skin_ecmwf.f90) ----

def _cool_skin(qsw, qnsol, ustar, sst, fr0, qlat=None):
    coefs = _skin_layer_coefs(alpha_sw(sst), ustar, qlat)
    qabs = qnsol
    delta = _delta_skin_layer(coefs, qabs)
    for _ in range(4):
        fr = maxc(fr0 + 11.0 * delta
                  - 6.6e-5 / delta * (1.0 - torch.exp(delta * (-1.0 / 8.0e-4))),
                  0.01)
        qabs = qnsol + fr * qsw
        delta = _delta_skin_layer(coefs, qabs)
    return qabs * delta * (1.0 / RK0_W)


def _wl_coare_absorption(hwl):
    return 1.0 - (0.28 * 0.014 * (1.0 - torch.exp(hwl * (-1.0 / 0.014)))
                  + 0.27 * 0.357 * (1.0 - torch.exp(hwl * (-1.0 / 0.357)))
                  + 0.45 * 12.82 * (1.0 - torch.exp(hwl * (-1.0 / 12.82)))) \
        / hwl


def local_solar_seconds(lon, isecday_utc):
    rlag = -torch.remainder((360.0 - torch.remainder(lon, 360.0)) / 15.0, 24.0)
    rlag = -fsign(torch.minimum(torch.abs(rlag),
                                torch.abs(torch.remainder(rlag, 24.0))),
                  rlag + 12.0)
    ilag_s = torch.trunc(rlag * 3600.0)
    return torch.remainder(isecday_utc + ilag_s, 24.0 * 3600.0)


def wl_coare(qsw, qnsol, tau, sst, lon, isecday_utc, state, rdt, gdept):
    """COARE 3.6 warm layer, its early exits as masks; returns the
    committed state."""
    dtwl0 = state.dT_wl
    hwl0 = maxc(minc(state.Hz_wl, HWL_MAX), 0.1)
    qac0, tac0 = state.Qnt_ac, state.Tau_ac
    rhr_sol = local_solar_seconds(lon, isecday_utc) / 3600.0
    alpha = alpha_sw(sst)
    cd1 = torch.sqrt(2.0 * RICH0 * RCP0_W / (alpha * GRAV * RHO0_W))
    cd2 = torch.sqrt(2.0 * alpha * GRAV / (RICH0 * RHO0_W)) / RCP0_W ** 1.5

    dawn = (rhr_sol > 4.0) & (rhr_sol <= 6.5)
    destroy = dawn
    qabs = _wl_coare_absorption(hwl0) * qsw + qnsol
    no_wl_yet = (~dawn) & (torch.abs(dtwl0) < 1.0e-6) & (qabs <= 0.0)
    exited = dawn | no_wl_yet
    qac_first = qac0 + qabs * rdt
    drained = (~exited) & (qac_first <= 0.0)
    destroy = destroy | drained
    active = ~(exited | drained)

    tac = tac0 + maxc(tau, 0.002) * rdt
    qac, hwl, live = qac0, hwl0, active
    for k in range(5):
        if k == 0:
            qac_i = qac_first
        else:
            qac_i = qac0 + (_wl_coare_absorption(hwl) * qsw + qnsol) * rdt
        qac = torch.where(live, qac_i, qac)
        cont = qac_i > 0.0
        hwl_i = maxc(minc(cd1 * tac / torch.sqrt(maxc(qac_i, 1.0e-30)),
                          HWL_MAX), 0.1)
        hwl = torch.where(live & cont, hwl_i, hwl)
        live = live & cont

    destroy = destroy | (active & (qac <= 0.0))
    built = active & (qac > 0.0)
    qac_pos = maxc(qac, 1.0e-30)
    dtwl_new = cd2 * (qac_pos * torch.sqrt(qac_pos)) / tac
    flg = step(gdept - hwl)
    dtwl_new = dtwl_new * (flg + (1.0 - flg) * gdept / hwl)
    return SkinState(
        dT_wl=torch.where(destroy, 0.0, torch.where(built, dtwl_new, dtwl0)),
        Hz_wl=torch.where(destroy, HWL_MAX, torch.where(built, hwl, hwl0)),
        Qnt_ac=torch.where(destroy, 0.0, torch.where(built, qac, qac0)),
        Tau_ac=torch.where(destroy, 0.0, torch.where(built, tac, tac0)))


def _phi_takaya(zeta):
    zt2 = zeta * zeta
    tf = step(zeta)
    return (tf * (1.0 + (5.0 * zeta + 4.0 * zt2)
                  / (1.0 + 3.0 * zeta + 0.25 * zt2))
            + (1.0 - tf) / torch.sqrt(1.0 - 16.0 * (-absj(zeta))))


def wl_ecmwf(qsw, qnsol, ustar, sst, state, rdt, gdept):
    """ECMWF prognostic warm layer, 10 semi-implicit passes."""
    hwl = state.Hz_wl
    flg = step(gdept - hwl)
    tcorr = flg + (1.0 - flg) * gdept / hwl
    dtwl_b = maxc(state.dT_wl / tcorr, 0.0)
    alpha = alpha_sw(sst)
    fr = (1.0 - 0.28 * torch.exp(-71.5 * hwl) - 0.27 * torch.exp(-2.8 * hwl)
          - 0.45 * torch.exp(-0.07 * hwl))
    qabs = fr * qsw + qnsol
    usw = maxc(ustar, 1.0e-4) * SQ_RADRW
    usw2 = usw * usw
    fla = max(0.3 ** (-2.0 / 3.0), 1.0)
    wf = step(qabs)
    rhocp_w = RHO0_W * RCP0_W
    cst1 = VKARMN * GRAV * alpha
    l2 = cst1 * qabs / (rhocp_w * usw2 * usw)
    cst2 = cst1 / (5.0 * hwl * usw2)
    cst0 = rdt * (RNUWL0 + 1.0) / hwl
    za = cst0 * qabs / (RNUWL0 * rhocp_w)
    cst3 = -cst0 * VKARMN * usw * fla
    dtwl_n = dtwl_b
    for _ in range(10):
        dtwl_n = 0.5 * (dtwl_n + dtwl_b)
        pos = dtwl_n * cst2 > 0.0
        l1 = torch.where(
            pos, torch.sqrt(torch.where(pos, dtwl_n * cst2, 1.0)), 0.0)
        zeta = (1.0 - wf) * hwl * l1 + wf * hwl * l2
        zb = cst3 / _phi_takaya(zeta)
        dtwl_n = maxc(dtwl_b + za + zb * dtwl_n, 0.0)
    return state._replace(dT_wl=dtwl_n * tcorr)


# --- the bulk solves (mod_blk_coare3p6.f90:123-413, mod_blk_ecmwf.f90) -----

def turb_coare3p6(zt, zu, t_s, t_zt, q_s, q_zt, u_zu, niter, qsw, rad_lw,
                  slp, isecday_utc, lon, state, rdt, gdept):
    """COARE 3.6 with cool skin and warm layer: (Cd, Ch, Ce, t_zu, q_zu, Ub,
    T_s, q_s), state."""
    zt_eq_zu = abs(zu - zt) < 0.01
    log_10, log_zt, log_zu = math.log(10.0), math.log(zt), math.log(zu)
    m_zi0_ov_k = -600.0 / VKARMN
    xsst = t_s
    t_s = t_s - 0.25
    q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)

    us, ts, qs, t_zu, q_zu, ub, z0 = first_guess_coare(
        zt, zu, t_s, t_zt, q_s, q_zt, u_zu, charn_coare3p6(u_zu))
    log_z0 = torch.log(z0)
    nu_a = visc_air(t_zu)
    dt = nonzero_delta(t_zu - t_s, 1.0e-9)
    dq = nonzero_delta(q_zu - q_s, 1.0e-12)
    dt_cs = torch.zeros_like(t_s)
    for jit in range(1, niter + 1):
        us2 = us * us
        one_on_L = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), 200.0)
        gust2 = 1.2 * 1.2 * us2 * pow23_pos(one_on_L * m_zi0_ov_k)
        ub = maxc(torch.sqrt(u_zu * u_zu + gust2), 0.2)
        zeta_u = clip_mag(zu * one_on_L, 50.0)
        if not zt_eq_zu:
            zeta_t = clip_mag(zt * one_on_L, 50.0)
        charn = charn_coare3p6(us * (1.0 / VKARMN) * (log_10 - log_z0))
        z0 = charn * us2 * (1.0 / GRAV) + 0.11 * nu_a / us
        z0 = minc(maxc(absj(z0), 1.0e-9), 1.0)
        log_z0 = torch.log(z0)
        z0t = minc(5.8e-5 * (nu_a / (z0 * us)) ** 0.72, 1.6e-4)
        z0t = minc(maxc(absj(z0t), 1.0e-9), 1.0)
        log_z0t = torch.log(z0t)
        psi_h_u = psi_h_coare(zeta_u)
        fac = VKARMN / (log_zu - log_z0t - psi_h_u)
        ts = dt * fac
        qs = dq * fac
        us = maxc(ub * VKARMN / (log_zu - log_z0 - psi_m_coare(zeta_u)),
                  1.0e-9)
        if not zt_eq_zu:
            prf = log_zt - log_zu + psi_h_u - psi_h_coare(zeta_t)
            t_zu = t_zt - ts * (1.0 / VKARMN) * prf
            q_zu = q_zt - qs * (1.0 / VKARMN) * prf

        qns, _, qlat = update_qnsol_tau(zu, t_s, q_s, t_zu, q_zu, us, ts, qs,
                                        u_zu, ub, slp, rad_lw)
        dt_cs = _cool_skin(qsw, qns, us, xsst, 0.137, qlat)
        t_s = xsst + dt_cs
        t_s = t_s + state.dT_wl
        q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)
        if niter % jit == 0:
            # the warm layer commits on iwait = MOD(nb_iter, jit) == 0
            qns, tau, _ = update_qnsol_tau(zu, t_s, q_s, t_zu, q_zu, us, ts,
                                           qs, u_zu, ub, slp, rad_lw)
            state = wl_coare(qsw, qns, tau, xsst, lon, isecday_utc, state,
                             rdt, gdept)
            t_s = xsst + state.dT_wl
            t_s = t_s + dt_cs
            q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)
        dt = nonzero_delta(t_zu - t_s, 1.0e-9)
        dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    r = us / ub
    cd = maxc(r * r, CX_MIN)
    ch = maxc(r * ts / dt, CX_MIN)
    ce = maxc(r * qs / dq, CX_MIN)
    return (cd, ch, ce, t_zu, q_zu, ub, t_s, q_s), state


def turb_ecmwf(zt, zu, t_s, t_zt, q_s, q_zt, u_zu, niter, qsw, rad_lw, slp,
               state, rdt, gdept):
    """ECMWF (IFS Cy40r1) with cool skin and warm layer."""
    zt_eq_zu = abs(zu - zt) < 0.01
    m_ztzu = 0.0 if zt_eq_zu else 1.0
    log_10, log_zu, log_ztu = math.log(10.0), math.log(zu), math.log(zt / zu)
    m_zi0_ov_k = -1000.0 / VKARMN
    charn0_ov_g = 0.018 / GRAV
    xsst = t_s
    t_s = t_s - 0.25
    q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)

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
    dt_cs = torch.zeros_like(t_s)
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
        z0 = minc(absj(0.11 * nu_on_us + us2 * charn0_ov_g), 0.001)
        z0t = minc(absj(0.40 * nu_on_us), 0.001)
        z0q = minc(absj(0.62 * nu_on_us), 0.001)
        log_z0, log_z0t, log_z0q = torch.log(z0), torch.log(z0t), \
            torch.log(z0q)
        psi_m_z0 = psi_m_ecmwf(z0 * one_on_L)
        psi_h_z0t = psi_h_ecmwf(z0t * one_on_L)
        psi_h_z0q = psi_h_ecmwf(z0q * one_on_L)
        gust2 = us2 * pow23_pos(one_on_L * m_zi0_ov_k)
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

        qns, _, _ = update_qnsol_tau(zu, t_s, q_s, t_zu, q_zu, us, ts, qs,
                                     u_zu, ub, slp, rad_lw)
        dt_cs = _cool_skin(qsw, qns, us, xsst, 0.065)
        t_s = xsst + dt_cs
        t_s = t_s + state.dT_wl
        q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)
        qns, _, _ = update_qnsol_tau(zu, t_s, q_s, t_zu, q_zu, us, ts, qs,
                                     u_zu, ub, slp, rad_lw)
        state = wl_ecmwf(qsw, qns, us, xsst, state, rdt, gdept)
        t_s = xsst + state.dT_wl
        t_s = t_s + dt_cs
        q_s = RDCT_QSAT_SALT * q_sat(maxc(t_s, 200.0), slp)
        dt = nonzero_delta(t_zu - t_s, 1.0e-9)
        dq = nonzero_delta(q_zu - q_s, 1.0e-12)

    fq = log_zu - log_z0q - psi_h_u + psi_h_z0q
    cd = maxc(VKARMN2 / (fm * fm), CX_MIN)
    ch = maxc(VKARMN2 / (fm * fh), CX_MIN)
    ce = maxc(VKARMN2 / (fm * fq), CX_MIN)
    return (cd, ch, ce, t_zu, q_zu, ub, t_s, q_s), state


# --- one record and the record loop ----------------------------------------

#: the six outputs of a step, in the fused kernel's order
OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")


def flux_step(cfg, sst, t_zt, hum_zt, u_zu, v_zu, slp, rad_sw, rad_lw,
              lon, isecday_utc, state):
    """One record of ``cfg`` (a mapping with algo, zt, zu, niter, rdt,
    gdept; specific humidity, both skin schemes): the six outputs of
    :data:`OUTPUTS` and the new state."""
    zt, zu = float(cfg["zt"]), float(cfg["zu"])
    wnd = torch.sqrt(u_zu * u_zu + v_zu * v_zu)
    ssq = RDCT_QSAT_SALT * q_sat(sst, slp)
    theta_zt = theta_from_z_p0_t_q(zt, slp, t_zt, hum_zt)
    qsw = (1.0 - ROCE_ALB0) * rad_sw
    rdt, gdept, niter = float(cfg["rdt"]), float(cfg["gdept"]), \
        int(cfg["niter"])
    if cfg["algo"] == "coare3p6":
        res, state = turb_coare3p6(zt, zu, sst, theta_zt, ssq, hum_zt, wnd,
                                   niter, qsw, rad_lw, slp, isecday_utc, lon,
                                   state, rdt, gdept)
    elif cfg["algo"] == "ecmwf":
        res, state = turb_ecmwf(zt, zu, sst, theta_zt, ssq, hum_zt, wnd,
                                niter, qsw, rad_lw, slp, state, rdt, gdept)
    else:
        raise ValueError(f"reference: no step for algo {cfg['algo']!r}")
    cd, ch, ce, t_zu, q_zu, ub, t_s, q_s = res
    tau, qh, ql, evap = bulk_formula(zu, t_s, q_s, t_zu, q_zu, cd, ch, ce,
                                     wnd, ub, slp)
    inv_w = torch.where(wnd > 1.0e-3, 1.0 / maxc(wnd, 1.0e-3), 0.0)
    return (ql, qh, tau * inv_w * u_zu, tau * inv_w * v_zu, evap, t_s), state


#: the forcing fields of a record, in the step's order
FORCING = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw")


def run_series(cfg, forcing, lon, isecday, state=None):
    """The records of ``forcing`` (name -> tensor of shape (nt, ...)) in
    order, the state carried from each to the next: a list of the records'
    outputs and the final state."""
    sst = forcing["sst"]
    if state is None:
        state = init_state(cfg["algo"], sst.shape[1:], sst.dtype, sst.device)
    outs = []
    for k in range(sst.shape[0]):
        out, state = flux_step(cfg, *(forcing[n][k] for n in FORCING), lon,
                               int(isecday[k]), state)
        outs.append(out)
    return outs, state
