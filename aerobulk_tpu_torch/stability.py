"""Stability-profile functions psi_m / psi_h on tensors.

Branch-free, as in ``aerobulk_tpu.stability``: the reference's
``0.5 + SIGN(0.5, zeta)`` mask becomes :func:`thermo.step`.  Families:
  * COARE  (Fairall et al. 2003)           mod_common_coare.f90:217-392
  * NCAR   (Large & Yeager 2004)           mod_blk_ncar.f90:333-419
  * ECMWF  (IFS Cy31r1)                    mod_blk_ecmwf.f90:441-564
  * ANDREAS (Paulson-70 / Grachev-07)      mod_blk_andreas.f90:307-410
  * GRACHEV07 (SHEBA, Jordan-99 unstable)  mod_blk_grachev07.f90:49-127
  * ICE (Jordan et al. 1999)               mod_blk_ice_an05.f90:316-406

Scalar constants that Python folds in double stay folded in double.

One deliberate difference from ``aerobulk_tpu``: :func:`psi_h_andreas`
guards the denominator of its stable-branch log as well as the numerator.
``zz + sqrt(5)`` is exactly 0 at zeta = -(3 + sqrt(5))/2, an unstable zeta
where the stable branch is masked to 0; the reference's value there is
``0 * inf = NaN``, the port's is the unstable branch.  Only values that
the stability mask sets to 0 change.
"""

from __future__ import annotations

import math

import torch

from .constants import rpi
from .math_compat import arctan
from .thermo import absj, maxc, minc, step

__all__ = ["psi_m_coare", "psi_h_coare", "psi_m_ncar", "psi_h_ncar",
           "psi_m_ecmwf", "psi_h_ecmwf", "psi_m_andreas", "psi_h_andreas",
           "psi_m_grachev07", "psi_h_grachev07", "psi_m_ice", "psi_h_ice"]

_INV_3 = 1.0 / 3.0
_INV_SQRT3 = 1.0 / 1.7320508


def _pos_or_one(a):
    """``a`` where positive, else 1 — grad-safety feed for a
    ``sqrt``/``**frac`` whose argument can land exactly on 0 inside a
    branch the stability mask zeroes out (e.g. ``|1-15z|`` at z=1/15).
    Only masked-branch values change, so every psi value is unchanged,
    and the backward pass no longer meets ``inf slope x 0 = NaN``."""
    return torch.where(a > 0.0, a, 1.0)


def _ge_one(a):
    """``a`` where >= 1, else 1 — the same guard for the NCAR/Andreas
    ``MAX(sqrt(|1-16z|), 1)`` clamp: for a < 1 the clamp gives 1 anyway."""
    return torch.where(a >= 1.0, a, 1.0)


def psi_m_coare(zeta):
    """COARE psi_m (mod_common_coare.f90:217-254), with the same strength
    reductions as ``aerobulk_tpu.stability.psi_m_coare``."""
    phi_m = torch.sqrt(torch.sqrt(_pos_or_one(absj(1.0 - 15.0 * zeta))))
    psi_k = (2.0 * torch.log((1.0 + phi_m) * 0.5)
             + torch.log((1.0 + phi_m * phi_m) * 0.5)
             - 2.0 * arctan(phi_m) + 0.5 * rpi)
    phi_c = _pos_or_one(absj(1.0 - 10.15 * zeta)) ** 0.3333
    psi_c = (1.5 * torch.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * arctan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
             + 1.813799447)
    f = zeta * zeta
    f = f / (1.0 + f)
    cc = minc(0.35 * zeta, 50.0)
    stb = step(zeta)
    return ((1.0 - stb) * ((1.0 - f) * psi_k + f * psi_c)
            - stb * (1.0 + zeta
                     + 0.6667 * (zeta - 14.28) * torch.exp(-cc) + 8.525))


def psi_h_coare(zeta):
    """COARE psi_h (mod_common_coare.f90:305-344)."""
    phi_h = torch.sqrt(_pos_or_one(absj(1.0 - 15.0 * zeta)))
    psi_k = 2.0 * torch.log((1.0 + phi_h) * 0.5)
    phi_c = _pos_or_one(absj(1.0 - 34.15 * zeta)) ** 0.3333
    psi_c = (1.5 * torch.log((1.0 + phi_c + phi_c * phi_c) * _INV_3)
             - 1.7320508 * arctan((1.0 + 2.0 * phi_c) * _INV_SQRT3)
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


# ---------------------------------------------------------------------------
# NCAR / Large & Yeager
# ---------------------------------------------------------------------------

def psi_m_ncar(zeta):
    """NCAR psi_m (mod_blk_ncar.f90:333-363)."""
    x2 = maxc(torch.sqrt(_ge_one(absj(1.0 - 16.0 * zeta))), 1.0)
    x = torch.sqrt(x2)
    psi_unst = (2.0 * torch.log((1.0 + x) * 0.5)
                + torch.log((1.0 + x2) * 0.5)
                - 2.0 * arctan(x) + rpi * 0.5)
    psi_stab = -5.0 * zeta
    stb = step(zeta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_ncar(zeta):
    """NCAR psi_h (mod_blk_ncar.f90:379-407)."""
    x2 = maxc(torch.sqrt(_ge_one(absj(1.0 - 16.0 * zeta))), 1.0)
    psi_unst = 2.0 * torch.log(0.5 * (1.0 + x2))
    psi_stab = -5.0 * zeta
    stb = step(zeta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# ECMWF / IFS
# ---------------------------------------------------------------------------

_ZC_ECMWF = 5.0 / 0.35


def _cap_zeta_ecmwf(zeta):
    """Clamp zeta into [-50, 5] (mod_blk_ecmwf.f90:551-564)."""
    return minc(maxc(zeta, -50.0), 5.0)


def psi_m_ecmwf(zeta):
    """ECMWF psi_m: Paulson-70 unstable + IFS stable (mod_blk_ecmwf.f90:441-477)."""
    zc = _ZC_ECMWF
    zta = _cap_zeta_ecmwf(zeta)
    x2 = torch.sqrt(_pos_or_one(absj(1.0 - 16.0 * zta)))
    x = torch.sqrt(x2)
    t = 1.0 + x
    psi_unst = (torch.log(0.125 * t * t * (1.0 + x2))
                - 2.0 * arctan(x) + 0.5 * rpi)
    psi_stab = (-2.0 / 3.0 * (zta - zc) * torch.exp(-0.35 * zta)
                - zta - 2.0 / 3.0 * zc)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_ecmwf(zeta):
    """ECMWF psi_h (mod_blk_ecmwf.f90:498-533)."""
    zc = _ZC_ECMWF
    zta = _cap_zeta_ecmwf(zeta)
    x2 = torch.sqrt(_pos_or_one(absj(1.0 - 16.0 * zta)))
    psi_unst = 2.0 * torch.log(0.5 * (1.0 + x2))
    x32 = absj(1.0 + 2.0 / 3.0 * zta)
    x32 = x32 * torch.sqrt(_pos_or_one(x32))
    psi_stab = (-2.0 / 3.0 * (zta - zc) * torch.exp(-0.35 * zta)
                - x32 - 2.0 / 3.0 * zc + 1.0)
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# ANDREAS (Paulson-70 unstable; Grachev-07 SHEBA stable)
# ---------------------------------------------------------------------------

def psi_m_andreas(zeta):
    """Andreas psi_m (mod_blk_andreas.f90:307-360)."""
    am = 5.0
    bm = am / 6.5
    one_third = 1.0 / 3.0
    sr3 = math.sqrt(3.0)
    zta = minc(zeta, 15.0)
    x2 = maxc(torch.sqrt(_ge_one(absj(1.0 - 16.0 * zta))), 1.0)
    x = torch.sqrt(x2)
    psi_unst = (2.0 * torch.log(absj((1.0 + x) * 0.5))
                + torch.log(absj((1.0 + x2) * 0.5))
                - 2.0 * arctan(x) + rpi * 0.5)
    xs = _pos_or_one(absj(1.0 + zta)) ** one_third
    bbm = abs((1.0 - bm) / bm) ** one_third  # scalar B_m
    psi_stab = (-3.0 * am / bm * (xs - 1.0) + am * bbm / (2.0 * bm) * (
        2.0 * torch.log(absj((xs + bbm) / (1.0 + bbm)))
        - torch.log(absj((xs * xs - xs * bbm + bbm * bbm)
                         / (1.0 - bbm + bbm * bbm)))
        + 2.0 * sr3 * (arctan((2.0 * xs - bbm) / (sr3 * bbm))
                       - math.atan((2.0 - bbm) / (sr3 * bbm)))))
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


def psi_h_andreas(zeta):
    """Andreas psi_h (mod_blk_andreas.f90:363-410).

    The stable-branch log arguments vanish at unstable (masked) zetas:
    ``|1 + 3z + z^2|`` at (-3 +- sqrt(5))/2, ``zz - sqrt(5)`` at
    (sqrt(5) - 3)/2 and ``zz + sqrt(5)`` at -(3 + sqrt(5))/2.  Each side
    of the ratio is guarded here (``|a / b| = |a / |b||`` to the bit, so
    the value elsewhere is unchanged); ``aerobulk_tpu`` guards the ratio
    only, which leaves ``log(|x/0|) = inf`` and ``0 * inf = NaN`` at the
    last point (module docstring)."""
    ah = 5.0
    bh = 5.0
    ch = 3.0
    bbh = math.sqrt(5.0)
    zta = minc(zeta, 15.0)
    x2 = maxc(torch.sqrt(_ge_one(absj(1.0 - 16.0 * zta))), 1.0)
    psi_unst = 2.0 * torch.log(0.5 * (1.0 + x2))
    zz = 2.0 * zta + ch
    psi_stab = (-0.5 * bh * torch.log(_pos_or_one(
                    absj(1.0 + ch * zta + zta * zta)))
                + (-ah / bbh + 0.5 * bh * ch / bbh)
                * (torch.log(_pos_or_one(absj(
                    (zz - bbh) / _pos_or_one(absj(zz + bbh)))))
                   - math.log(abs((ch - bbh) / (ch + bbh)))))
    stb = step(zta)
    return stb * psi_stab + (1.0 - stb) * psi_unst


# ---------------------------------------------------------------------------
# GRACHEV07 (SHEBA over sea ice; Jordan-99 unstable)
# ---------------------------------------------------------------------------

def psi_m_grachev07(zeta):
    """Grachev-07 psi_m (mod_blk_grachev07.f90:49-70)."""
    x = _pos_or_one(absj(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = (torch.log(0.5 * (1.0 + x * x)) + 2.0 * torch.log(0.5 * (1.0 + x))
             - 2.0 * arctan(x) + 0.5 * rpi)
    psi_s = (1.0 + 6.5 * zeta * _pos_or_one(1.0 + zeta) ** 0.3333333
             / torch.where(zeta < 0.0, 1.0, 1.3 + zeta))
    return torch.where(zeta < 0.0, psi_u, -psi_s)


def psi_h_grachev07(zeta):
    """Grachev-07 psi_h (mod_blk_grachev07.f90:91-113)."""
    x = _pos_or_one(absj(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = 2.0 * torch.log(0.5 * (1.0 + x * x))
    psi_s = 1.0 + 5.0 * zeta * (1.0 + zeta) / (1.0 + 3.0 * zeta + zeta * zeta)
    return torch.where(zeta < 0.0, psi_u, -psi_s)


# ---------------------------------------------------------------------------
# ICE: Jordan et al. 1999 (Paulson-70 unstable, Holtslag & De Bruin stable)
# shared by the AN05 / EASY / BEST ice algorithms
# (mod_blk_ice_an05.f90:316-406, identical copies in easy/best modules)
# ---------------------------------------------------------------------------

def _psi_s_holtslag(zeta):
    """Holtslag & De Bruin 1988 stable branch, Jordan-99 Eq. 33."""
    return -(0.7 * zeta + 0.75 * (zeta - 14.3) * torch.exp(-0.35 * zeta)
             + 10.7)


def psi_m_ice(zeta):
    """Ice psi_m: Jordan-99 Eq. 30 unstable / Eq. 33 stable
    (mod_blk_ice_an05.f90:316-360)."""
    x = _pos_or_one(absj(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = (torch.log((1.0 + x * x) / 2.0) + 2.0 * torch.log((1.0 + x) / 2.0)
             - 2.0 * arctan(x) + 0.5 * rpi)
    stb = step(zeta)
    return (1.0 - stb) * psi_u + stb * _psi_s_holtslag(zeta)


def psi_h_ice(zeta):
    """Ice psi_h: Jordan-99 Eq. 31 unstable / Eq. 33 stable
    (mod_blk_ice_an05.f90:363-406)."""
    x = _pos_or_one(absj(1.0 - 16.0 * zeta)) ** 0.25
    psi_u = 2.0 * torch.log((1.0 + x * x) / 2.0)
    stb = step(zeta)
    return (1.0 - stb) * psi_u + stb * _psi_s_holtslag(zeta)
