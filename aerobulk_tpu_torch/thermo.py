"""Thermodynamics / physics functions on tensors: every public function of
``aerobulk_tpu.thermo``.

Each function is elementwise, broadcasts over any shape and keeps the
dtype of its tensor arguments.  The expressions keep the reference's
association order and its SIGN/MAX/MIN clamps (``mod_phymbl.f90``), so an
fp64 run agrees with ``aerobulk_tpu`` to rounding.

Gradients follow the reference's (JAX's) conventions at the points where
a function is not differentiable, so that autograd through the port gives
the reference's gradient everywhere:
  * ``MAX``/``MIN`` against a constant are :func:`maxc`/:func:`minc`
    (``torch.maximum``/``torch.minimum``), which split the gradient 0.5/0.5
    at a tie, as ``jnp.maximum`` does; ``torch.clamp`` would pass all of
    it.  They nest as the reference nests them.
  * ``|x|`` has derivative 1 at 0 (:func:`absj`) and ``SIGN(a, b)`` has
    derivative sign(b) at a = 0 (:func:`fsign`), where ``torch.abs`` and
    ``torch.copysign`` give 0.  Their values are ``torch.abs`` and
    ``torch.copysign``'s, bit for bit; they take the slower
    ``torch.autograd.Function`` (with backward, jvp and vmap rules) only
    when a derivative may be taken: under autograd, forward-mode AD or a
    ``torch.func`` transform.
Functions cite the reference as ``mod_phymbl.f90:LINE``.
"""

from __future__ import annotations

import functools
import math

import torch
from torch.utils._python_dispatch import is_in_torch_dispatch_mode

from . import constants as c
from .math_compat import inv_cbrt_1p

__all__ = [
    "maxc", "minc", "absj", "fsign", "step", "clip_mag", "nonzero_delta",
    "pow23_pos", "pot_temp", "abs_temp",
    "virt_temp", "pz_from_p0_tz_qz", "theta_from_z_p0_t_q",
    "t_from_z_p0_theta_q", "rho_air", "visc_air",
    "l_vap", "cp_air", "gamma_moist", "one_on_l", "ri_bulk", "e_sat",
    "e_sat_ice", "de_sat_dt_ice", "q_sat", "dq_sat_dt_ice", "q_air_rh",
    "q_air_dp", "e_air", "rh_air", "rho_air_adv", "q_sat_crude",
    "dry_static_energy", "bulk_formula", "qlw_net", "update_qnsol_tau",
    "alpha_sw", "variance", "vmean", "skin_layer_coefs",
    "delta_skin_layer_from_coefs", "delta_skin_layer", "z0_from_cd",
    "z0_from_ustar", "cd_from_z0", "f_m_louis", "f_h_louis",
    "un10_from_ustar", "un10_from_cdn", "un10_from_cd", "z0tq_lkb",
]

# Goff-formula constants over ice (mod_phymbl.f90:143-148)
_rAg_i = -9.09718
_rBg_i = -3.56654
_rCg_i = 0.876793
_rDg_i = math.log10(6.1071)

# Louis (1979) constants (mod_phymbl.f90:150-153)
_rc_louis = 5.0
_rc2_louis = _rc_louis * _rc_louis
_ram_louis = 2.0 * _rc_louis
_rah_louis = 3.0 * _rc_louis


def _in_transform():
    """True inside a ``torch.func`` transform (grad, jvp, vmap, hessian)."""
    return torch._C._functorch.peek_interpreter_stack() is not None


@functools.lru_cache(maxsize=None)
def _cached_const(value, dtype):
    return torch.tensor(value, dtype=dtype)


def _const(value, dtype):
    """A 0-d CPU tensor: PyTorch passes it to a kernel on any device as a
    scalar argument.  Cached, except inside a ``torch.func`` transform or
    under a dispatch mode (a fake, proxy or counting mode: ``make_fx``,
    ``roofline.count_primitives``): a tensor made there belongs to the
    transform or the mode and must not outlive it, and a cached eager
    tensor is foreign to a fake mode."""
    if _in_transform() or is_in_torch_dispatch_mode():
        return torch.tensor(value, dtype=dtype)
    return _cached_const(value, dtype)


def maxc(x, c):
    """``MAX(x, c)`` for a constant ``c``: propagates NaN, and at a tie
    gives ``x`` half the gradient, as ``jnp.maximum`` does."""
    return torch.maximum(x, _const(c, x.dtype))


def minc(x, c):
    """``MIN(x, c)`` for a constant ``c``, as :func:`maxc`."""
    return torch.minimum(x, _const(c, x.dtype))


def _differentiated(x):
    """True where a derivative of ``x`` may be taken: autograd records it,
    a forward-mode dual level is open, or a ``torch.func`` transform runs."""
    return ((torch.is_grad_enabled() and x.requires_grad)
            or torch.autograd.forward_ad._current_level >= 0
            or _in_transform())


class _AbsJ(torch.autograd.Function):
    """``|x|`` with the derivative of ``jnp.abs``: 1 where x >= 0 (also at
    0 and -0.0), -1 elsewhere, in reverse and forward mode and under
    ``vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(x):
        return torch.abs(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, grad, -grad)

    @staticmethod
    def jvp(ctx, tangent):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0.0, tangent, -tangent)


def absj(x):
    """``|x|`` with derivative 1 at x = 0, as ``jnp.abs``."""
    return _AbsJ.apply(x) if _differentiated(x) else torch.abs(x)


class _FSign(torch.autograd.Function):
    """``copysign(|a|, b)`` with the derivative of ``jnp.copysign(jnp.abs(a),
    b)``: ``sign(b) * (1 if a >= 0 else -1)`` in ``a`` (also at a = 0,
    where ``torch.copysign`` gives 0), nothing in ``b``; in reverse and
    forward mode and under ``vmap``."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        return torch.copysign(torch.abs(a), b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        flip = torch.signbit(b) ^ ~(a >= 0.0)
        return torch.where(flip, -grad, grad), None

    @staticmethod
    def jvp(ctx, ta, tb):
        a, b = ctx.saved_tensors
        if ta is None:
            return torch.zeros_like(torch.copysign(a, b))
        flip = torch.signbit(b) ^ ~(a >= 0.0)
        return torch.where(flip, -ta, ta)


def fsign(a, b):
    """Fortran SIGN(a, b): |a| with the sign *bit* of b (copysign)."""
    if _differentiated(a):
        return _FSign.apply(a, b)
    return torch.copysign(torch.abs(a), b)


def step(x):
    """Fortran ``0.5 + SIGN(0.5, x)``: 1 where x >= 0, else 0 (in x's dtype)."""
    return (x >= 0.0).to(x.dtype)


def clip_mag(x, cap):
    """SIGN(MIN(|x|, cap), x) — symmetric magnitude clamp."""
    return fsign(minc(absj(x), cap), x)


def nonzero_delta(dx, floor):
    """SIGN(MAX(|dx|, floor), dx) — keep a difference away from zero."""
    return fsign(maxc(absj(dx), floor), dx)


def pow23_pos(x):
    """``MAX(x, 0)**(2/3)`` with a finite gradient at the clamp.

    The same value as the naive form (0 for x <= 0), but the inner
    ``where`` keeps pow's infinite slope at 0 out of the backward pass,
    where the clamp's zero cotangent would turn it into NaN."""
    pos = x > 0.0
    return torch.where(pos, torch.where(pos, x, 1.0) ** (2.0 / 3.0), 0.0)


# ---------------------------------------------------------------------------
# temperature conversions
# ---------------------------------------------------------------------------

def pot_temp(Ta, Pz, Pref=c.Patm):
    """Potential temperature from absolute temp via Poisson eq. (mod_phymbl.f90:163-200)."""
    return Ta * (Pref / Pz) ** c.rpoiss_dry


def abs_temp(Thta, Pz, Pref=c.Patm):
    """Absolute temperature from potential temp (mod_phymbl.f90:205-241)."""
    return Thta / maxc((Pref / Pz) ** c.rpoiss_dry, 1.0e-9)


def virt_temp(Ta, qa):
    """Virtual (absolute or potential) temperature (mod_phymbl.f90:247-276)."""
    return Ta * (1.0 + c.rctv0 * qa)


def pz_from_p0_tz_qz(z, slp, Ta, qa, l_ice=False):
    """Barometric pressure at height ``z`` via 3-iteration fixed point
    (mod_phymbl.f90:283-318), saturation over ice with ``l_ice``.  The
    saturation pressure depends only on ``Ta`` and is evaluated once."""
    es = e_sat_ice(Ta) if l_ice else e_sat(Ta)
    pa = slp
    for _ in range(3):
        qsat = c.reps0 * es / (pa - (1.0 - c.reps0) * es)
        f = qa / qsat
        xm = (1.0 - f) * c.rmm_dryair + f * c.rmm_water
        pa = slp * torch.exp(-c.grav * xm * z / (c.R_gas * Ta))
    return pa


def theta_from_z_p0_t_q(z, slp, Ta, qa):
    """Absolute temp at height z -> potential temp (mod_phymbl.f90:343-375)."""
    Pz = pz_from_p0_tz_qz(z, slp, Ta, qa)
    return pot_temp(Ta, Pz, Pref=slp)


def t_from_z_p0_theta_q(z, slp, Thta, qa):
    """Potential temp at height z -> absolute temp, 4-iteration
    (mod_phymbl.f90:380-407)."""
    Ta = Thta - c.rgamma_dry * z
    for _ in range(4):
        Pz = pz_from_p0_tz_qz(z, slp, Ta, qa)
        Ta = abs_temp(Thta, Pz, Pref=slp)
    return Ta


# ---------------------------------------------------------------------------
# air properties
# ---------------------------------------------------------------------------

def rho_air(Ta, qa, slp):
    """Moist-air density, floored at 0.8 kg/m^3 (mod_phymbl.f90:522-546)."""
    return maxc(slp / (c.R_dry * Ta * (1.0 + c.rctv0 * qa)), 0.8)


def visc_air(Ta):
    """Kinematic viscosity of air [m^2/s] (mod_phymbl.f90:549-574)."""
    tc = Ta - c.rt0
    tc2 = tc * tc
    return 1.326e-5 * (1.0 + 6.542e-3 * tc + 8.301e-6 * tc2 - 4.84e-9 * tc2 * tc)


def l_vap(sst):
    """Latent heat of vaporization of water [J/kg] (mod_phymbl.f90:579-598)."""
    return (2.501 - 0.00237 * (sst - c.rt0)) * 1.0e6


def cp_air(qa):
    """Specific heat of moist air [J/K/kg] (mod_phymbl.f90:603-622)."""
    return c.rCp_dry + c.rCp_vap * qa


def gamma_moist(Ta, qa):
    """Moist adiabatic lapse rate [K/m] (mod_phymbl.f90:627-661); the
    latent heat takes the unclamped ``Ta``, as the reference does."""
    ta = maxc(Ta, 180.0)
    qa_ = maxc(qa, 1.0e-6)
    wa = qa_ / (1.0 - qa_)
    iRT = 1.0 / (c.R_dry * ta)
    Lv = l_vap(Ta)
    return c.grav * (1.0 + Lv * wa * iRT) / (
        c.rCp_dry + Lv * Lv * wa * c.reps0 * iRT / ta)


# ---------------------------------------------------------------------------
# stability metrics
# ---------------------------------------------------------------------------

def one_on_l(Thta, qa, us, ts, qs):
    """1/(Obukhov length) [1/m], capped at |200| (mod_phymbl.f90:666-693)."""
    zqa = 1.0 + c.rctv0 * qa
    ool = c.grav * c.vkarmn * (ts * zqa + c.rctv0 * Thta * qs) / maxc(
        us * us * Thta * zqa, 1.0e-9)
    return clip_mag(ool, 200.0)


def ri_bulk(z, sst, Thta, ssq, qa, ub, Ta_layer=None, qa_layer=None):
    """Bulk Richardson number (mod_phymbl.f90:712-747); the layer's virtual
    temperature from ``Ta_layer`` and ``qa_layer`` when both are given."""
    sstv = virt_temp(sst, ssq)
    dthv = virt_temp(Thta, qa) - sstv
    if Ta_layer is not None and qa_layer is not None:
        tv = virt_temp(Ta_layer, qa_layer)
    else:
        tv = 0.5 * (sstv + virt_temp(Thta - c.rgamma_dry * z, qa))
    return c.grav * dthv * z / (tv * ub * ub)


# ---------------------------------------------------------------------------
# humidity
# ---------------------------------------------------------------------------

_LOG2_10 = math.log2(10.0)


def _exp10(x):
    """10**x as exp2(x * log2(10))."""
    return torch.exp2(x * _LOG2_10)


def e_sat(Ta):
    """Saturation vapour pressure over water [Pa], Goff 1957
    (mod_phymbl.f90:777-800).  NB: uses rt0=273.15, as the reference does."""
    ta = maxc(Ta, 180.0)
    ztmp = c.rt0 / ta
    zr = ta / c.rt0
    return 100.0 * _exp10(
        10.79574 * (1.0 - ztmp)
        - 5.028 * torch.log10(zr)
        + 1.50475e-4 * (1.0 - _exp10(-8.2969 * (zr - 1.0)))
        + 0.42873e-3 * (_exp10(4.76955 * (1.0 - ztmp)) - 1.0)
        + 0.78614)


def e_sat_ice(Ta):
    """Saturation vapour pressure over ice [Pa] (mod_phymbl.f90:815-830)."""
    ta = maxc(Ta, 180.0)
    ztmp = c.rtt0 / ta
    zle = (_rAg_i * (ztmp - 1.0) + _rBg_i * torch.log10(ztmp)
           + _rCg_i * (1.0 - ta / c.rtt0) + _rDg_i)
    return 100.0 * _exp10(zle)


def de_sat_dt_ice(Ta):
    """d(e_sat_ice)/dT [Pa/K], analytic (mod_phymbl.f90:845-861)."""
    ta = maxc(Ta, 180.0)
    ln10 = math.log(10.0)
    zde = (-(_rAg_i * c.rtt0) / (ta * ta) - _rBg_i / (ta * ln10)
           - _rCg_i / c.rtt0)
    return ln10 * zde * e_sat_ice(ta)


def q_sat(Ta, slp, l_ice=False):
    """Saturation specific humidity [kg/kg] over water, or over ice with
    ``l_ice`` (mod_phymbl.f90:881-904)."""
    es = e_sat_ice(Ta) if l_ice else e_sat(Ta)
    return c.reps0 * es / (slp - (1.0 - c.reps0) * es)


def dq_sat_dt_ice(Ta, slp):
    """d(q_sat_ice)/dT [1/K], analytic (mod_phymbl.f90:926-945)."""
    es = e_sat_ice(Ta)
    des_dt = de_sat_dt_ice(Ta)
    ztmp = (c.reps0 - 1.0) * es + slp
    return c.reps0 * slp * des_dt / (ztmp * ztmp)


def q_air_rh(rha, Ta, slp):
    """Specific humidity from relative humidity [%] (mod_phymbl.f90:963-985)."""
    ze = 0.01 * rha * e_sat(Ta)
    return ze * c.reps0 / maxc(slp - (1.0 - c.reps0) * ze, 1.0)


def q_air_dp(da, slp):
    """Specific humidity from dew-point temperature (mod_phymbl.f90:990-1000)."""
    e = maxc(e_sat(da), 0.0)
    return e * c.reps0 / maxc(slp - (1.0 - c.reps0) * e, 1.0)


def e_air(qa, slp, niter=10):
    """Vapour pressure of air from specific humidity, fixed point
    (mod_phymbl.f90:1706-1736; ``niter`` passes of a strong contraction in
    place of the reference's 1e-6 stopping test)."""
    e = qa * slp / c.reps0
    for _ in range(niter):
        e = qa / c.reps0 * (slp - (1.0 - c.reps0) * e)
    return e


def rh_air(qa, Ta, slp):
    """Relative humidity [%] from specific humidity (mod_phymbl.f90:1741-1756)."""
    return 100.0 * e_air(qa, slp) / e_sat(Ta)


def rho_air_adv(Ta, qa, slp):
    """Air density using true virtual temperature (mod_phymbl.f90:1008-1020)."""
    return slp / (c.R_dry * Ta / (1.0 - e_air(qa, slp) / slp * (1.0 - c.reps0)))


def q_sat_crude(ts, rhoa):
    """Crude saturation humidity (mod_phymbl.f90:1029-1035)."""
    return 640380.0 / rhoa * torch.exp(-5107.4 / ts)


def dry_static_energy(z, Ta, qa):
    """Dry static energy, IFS Eq. 3.5 (mod_phymbl.f90:1043-1055)."""
    return c.grav * z + cp_air(qa) * Ta


# ---------------------------------------------------------------------------
# fluxes
# ---------------------------------------------------------------------------

def bulk_formula(zu, ts, qs, Thta, qa, Cd, Ch, Ce, wnd, Ub, slp,
                 l_ice=False):
    """Turbulent fluxes from transfer coefficients, over water or, with
    ``l_ice``, over ice (mod_phymbl.f90:1149-1203).  Returns ``(Tau, Qsen,
    Qlat, Evap, rhoa)``.  Air density is evaluated at zu with a
    height-corrected pressure, as the reference does.  Over ice the latent
    heat is sublimation's, of the unclamped flux, and ``Evap`` keeps only
    its negative part."""
    ta = Thta - c.rgamma_dry * zu       # absolute temperature at zu
    den = c.R_dry * ta * (1.0 + c.rctv0 * qa)
    rho = maxc(slp / den, 0.8)
    rho = maxc((slp - rho * c.grav * zu) / den, 0.8)
    Urho = Ub * maxc(rho, 1.0)
    Tau = Urho * Cd * wnd
    evap = Urho * Ce * (qa - qs)
    Qsen = Urho * Ch * (Thta - ts) * cp_air(qa)
    if l_ice:
        return Tau, Qsen, c.rLsub * evap, minc(evap, 0.0), rho
    return Tau, Qsen, l_vap(ts) * evap, evap, rho


def qlw_net(dwlw, ts, l_ice=False):
    """Net longwave flux at the surface (mod_phymbl.f90:1291-1314)."""
    emiss = c.emiss_i if l_ice else c.emiss_w
    t2 = ts * ts
    return emiss * (dwlw - c.stefan * t2 * t2)


def update_qnsol_tau(zu, ts, qs, Thta, qa, ust, tst, qst, wnd, Ub, slp, rlw):
    """Non-solar heat flux Qns = Qlat+Qsen+Qlw and wind-stress module
    (mod_phymbl.f90:1059-1103).  Returns ``(Qns, Tau, Qlat)``."""
    zdt = nonzero_delta(Thta - ts, 1.0e-9)
    zdq = nonzero_delta(qa - qs, 1.0e-12)
    z0 = ust / Ub
    Cd = z0 * z0
    Ch = z0 * tst / zdt
    Ce = z0 * qst / zdq
    Tau, Qsen, Qlat, _, _ = bulk_formula(zu, ts, qs, Thta, qa, Cd, Ch, Ce,
                                         wnd, Ub, slp)
    Qlw = qlw_net(rlw, ts)
    return Qlat + Qsen + Qlw, Tau, Qlat


def alpha_sw(sst):
    """Thermal expansion coefficient of surface sea water [1/K]
    (mod_phymbl.f90:1267-1286).  The double ``where`` keeps the value of
    ``max(x, 0)**0.79`` and a finite gradient for sst <= 269.95 K."""
    x = maxc(sst - c.rt0 + 3.2, 0.0)
    pos = x > 0.0
    return 2.1e-5 * torch.where(pos, torch.where(pos, x, 1.0) ** 0.79, 0.0)


def variance(x):
    """Population *standard deviation* of a field: the reference's VARIANCE
    (mod_phymbl.f90:1794-1807) returns the square root despite its name."""
    x = torch.as_tensor(x)
    m = torch.mean(x)
    return torch.sqrt(torch.mean((x - m) * (x - m)))


def vmean(x):
    """Arithmetic mean of a field (mod_phymbl.f90:1811-1822)."""
    return torch.mean(torch.as_tensor(x))


def skin_layer_coefs(alpha, ustar_a, Qlat=None):
    """The Qd-independent pieces of the viscous-layer thickness, hoisted out
    of the cool-skin fixed point.  ``alpha * rcst_cs / usw^4`` is written
    with products of ``1/usw`` so that no backward intermediate overflows
    fp32 at the ustar floor.  Without ``Qlat`` (the ECMWF scheme) there is
    no Saunders correction: ``corr`` is None."""
    usw = maxc(ustar_a, 1.0e-4) * c.sq_radrw
    inv_usw = 1.0 / usw
    inv2 = inv_usw * inv_usw
    coef_y = alpha * c.rcst_cs * (inv2 * inv2)
    ztmp = c.rnu0_w * inv_usw
    corr = None
    if Qlat is not None:
        corr = 0.026 * minc(Qlat, 0.0) * c.rCp0_w / c.rLevap / alpha
    return coef_y, ztmp, corr


def delta_skin_layer_from_coefs(coefs, Qd):
    """Viscous-layer thickness for one absorbed-flux value, Fairall et al.
    1996 (mod_phymbl.f90:2010-2046), given :func:`skin_layer_coefs`.

    ``6*(1 + y^(3/4))^(-1/3)`` is evaluated as sqrt/cbrt chains; the
    ``where`` guard keeps the value at the ``MAX(y, 0)`` clamp (active at
    every cooling point) and a finite gradient there."""
    coef_y, ztmp, corr = coefs
    zQd = Qd if corr is None else Qd + corr
    ztf = step(zQd)
    zy = coef_y * zQd
    pos = zy > 0.0
    zs = torch.sqrt(torch.where(pos, zy, 1.0))
    lamb = 6.0 * inv_cbrt_1p(torch.where(pos, zs * torch.sqrt(zs), 0.0))
    return (1.0 - ztf) * lamb * ztmp + ztf * minc(6.0 * ztmp, 0.007)


def delta_skin_layer(alpha, Qd, ustar_a, Qlat=None):
    """Thickness of the viscous skin layer, Fairall et al. 1996
    (mod_phymbl.f90:2010-2046)."""
    return delta_skin_layer_from_coefs(
        skin_layer_coefs(alpha, ustar_a, Qlat=Qlat), Qd)


# ---------------------------------------------------------------------------
# roughness length / drag conversions
# ---------------------------------------------------------------------------

def z0_from_cd(zu, Cd, psi=None):
    """Roughness length from (neutral or stability-corrected) drag coefficient
    (mod_phymbl.f90:1335-1366)."""
    if psi is None:
        return zu * torch.exp(-c.vkarmn / torch.sqrt(Cd))
    return zu * torch.exp(-(c.vkarmn / torch.sqrt(Cd) + psi))


def z0_from_ustar(zu, us, uzu):
    """Roughness length from friction velocity (mod_phymbl.f90:1371-1391)."""
    return zu * torch.exp(-c.vkarmn * uzu / us)


def cd_from_z0(zu, z0, psi=None):
    """Drag coefficient from roughness length (mod_phymbl.f90:1396-1414)."""
    if psi is None:
        r = 1.0 / torch.log(zu / z0)
    else:
        r = 1.0 / (torch.log(zu / z0) - psi)
    return c.vkarmn2 * r * r


def f_m_louis(zu, Rib, Cdn, z0):
    """Louis (1979) momentum stability function (mod_phymbl.f90:1419-1440).
    ``Cdn`` and ``z0`` may be Python floats: their products with the
    constants are then folded in double, as in the reference package."""
    zstab = step(Rib)
    ztu = Rib / (1.0 + 3.0 * _rc2_louis * Cdn
                 * torch.sqrt(absj(-Rib * (zu / z0 + 1.0))))
    zts = Rib / torch.sqrt(absj(1.0 + Rib))
    return ((1.0 - zstab) * (1.0 - _ram_louis * ztu)
            + zstab / (1.0 + _ram_louis * zts))


def f_h_louis(zu, Rib, Chn, z0):
    """Louis (1979) heat stability function (mod_phymbl.f90:1458-1479)."""
    zstab = step(Rib)
    ztu = Rib / (1.0 + 3.0 * _rc2_louis * Chn
                 * torch.sqrt(absj(-Rib * (zu / z0 + 1.0))))
    zts = Rib / torch.sqrt(absj(1.0 + Rib))
    return ((1.0 - zstab) * (1.0 - _rah_louis * ztu)
            + zstab / (1.0 + _rah_louis * zts))


def un10_from_ustar(zu, Uzu, us, psi):
    """Neutral-stability 10-m wind from u* (mod_phymbl.f90:1498-1510)."""
    return Uzu - us / c.vkarmn * (math.log(zu / 10.0) - psi)


def un10_from_cdn(zu, Ub, Cdn, psi):
    """Neutral-stability 10-m wind from CdN (mod_phymbl.f90:1515-1527)."""
    return Ub / (1.0 + torch.sqrt(Cdn) / c.vkarmn * (math.log(zu / 10.0) - psi))


def un10_from_cd(zu, Ub, Cd, psi):
    """Neutral-stability 10-m wind from Cd (mod_phymbl.f90:1532-1558)."""
    return (torch.sqrt(Cd) * Ub / c.vkarmn
            * torch.log(10.0 / z0_from_cd(zu, Cd, psi=psi)))


# Liu-Katsaros-Businger (1979) piecewise-power table (mod_phymbl.f90:1635-1701)
_LKB_XA = ((0.177, 1.376, 1.026, 1.625, 4.661, 34.904, 1667.19, 5.88e5),
           (0.292, 1.808, 1.393, 1.956, 4.994, 30.709, 1448.68, 2.98e5))
_LKB_XB = ((0.0, 0.929, -0.599, -1.018, -1.475, -2.067, -2.907, -3.935),
           (0.0, 0.826, -0.528, -0.870, -1.297, -1.845, -2.682, -3.616))
_LKB_XRAN = (0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0, 1000.0)


def z0tq_lkb(iflag, Rer, z0):
    """Scalar roughness lengths z0t (iflag=1) / z0q (iflag=2) from the
    roughness Reynolds number, LKB table (mod_phymbl.f90:1635-1701).

    The reference's DO WHILE bin search is a ``bucketize`` over the bin
    edges: bin j is (e_j, e_{j+1}].  Out-of-range Re_r gets the
    reference's -999 sentinel, which the |.| and the clamp to [1e-9, 0.05]
    turn into 0.05 m."""
    xa = torch.tensor(_LKB_XA[iflag - 1], dtype=Rer.dtype, device=Rer.device)
    xb = torch.tensor(_LKB_XB[iflag - 1], dtype=Rer.dtype, device=Rer.device)
    edges = torch.tensor(_LKB_XRAN[:-1], dtype=Rer.dtype, device=Rer.device)
    # the count of edges strictly below Rer (jnp.searchsorted side="left")
    jm = torch.bucketize(Rer.detach(), edges, right=False)
    jm = torch.clamp(jm - 1, 0, 7)
    val = xa[jm] * Rer ** xb[jm] * z0 / Rer
    in_range = (Rer > 0.0) & (Rer < 1000.0)
    val = torch.where(in_range, val, -999.0)
    return minc(maxc(absj(val), 1.0e-9), 0.05)
