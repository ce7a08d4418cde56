"""Neutral form-drag contributions over sea ice vs ice concentration
(``mod_cdn_form_ice.f90``): the Lüpkes et al. 2012 / Lüpkes & Gryanik 2015
family of "form" (edge) drag coefficients added to the "skin" drag over
ice.  Constants that Python folds in double stay folded in double."""

from __future__ import annotations

import math

import torch

__all__ = ["cdn10_f_lu12", "cdn_f_lu12_eq36", "cdn10_f_lu13", "cdn_f_lg15",
           "cdn_f_lg15_light"]

_RCE_0 = 2.23e-3      # Lüpkes-2013 Eq. 1          (mod_cdn_form_ice.f90:22)
_RNU_0 = 1.0
_RMU_0 = 1.0
_RBETA_0 = 1.4        # Eq. 47 MIZ
_RHMIN_0 = 0.286      # Eq. 25
_RHMAX_0 = 0.534      # Eq. 25
_RDMIN_0 = 8.0        # Eq. 27
_RDMAX_0 = 300.0      # Eq. 27
_RZ0_W_0 = 3.27e-4    # fixed water roughness (below Eq. 36)
_RCE10_I_0 = 3.46e-3  # Eq. 48 MIZ


def _sc_hf_di(frice, Sc=None, hf=None, Di=None):
    """Sheltering / freeboard / floe-length, parameterized from ice
    concentration when not provided (mod_cdn_form_ice.f90:80-103)."""
    frw = 1.0 - frice
    if Sc is None:
        Sc = frw ** (1.0 / (10.0 * _RBETA_0))                 # Eq. 31
    if hf is None:
        hf = _RHMAX_0 * frice + _RHMIN_0 * frw                # Eq. 25
    if Di is None:
        astar = 1.0 / (1.0 - (_RDMIN_0 / _RDMAX_0) ** (1.0 / _RBETA_0))
        Di = _RDMIN_0 * (astar / (astar - frice)) ** _RBETA_0  # Eq. 26/27
    return Sc, hf, Di


def cdn10_f_lu12(frice, z0w, Sc=None, hf=None, Di=None):
    """Lüpkes et al. 2012 Eq. 22, general form (mod_cdn_form_ice.f90:42-114)."""
    Sc, hf, Di = _sc_hf_di(frice, Sc, hf, Di)
    rlog = torch.log(hf / z0w) / torch.log(10.0 / z0w)
    return 0.5 * 0.3 * rlog * rlog * Sc * hf / Di * frice


def cdn_f_lu12_eq36(zu, frice):
    """Lüpkes et al. 2012 Eq. 35/36 (mod_cdn_form_ice.f90:117-142)."""
    hf = 0.41
    Di = _RDMIN_0
    rlog = math.log(hf / _RZ0_W_0) / math.log(zu / _RZ0_W_0)
    return 0.5 * 0.3 * rlog * rlog * hf / Di * (1.0 - frice) ** _RBETA_0


def cdn10_f_lu13(frice):
    """Lüpkes et al. 2013 level-4 approximation:
    Ce * A^(mu-1) * (1-A)^(nu + 1/(10 beta)) (mod_cdn_form_ice.f90:147-193)."""
    coef = _RNU_0 + 1.0 / (10.0 * _RBETA_0)
    return _RCE_0 * frice ** (_RMU_0 - 1.0) * (1.0 - frice) ** coef


def cdn_f_lg15(zu, frice, z0i, Sc=None, hf=None, Di=None):
    """Lüpkes & Gryanik 2015 Eq. 21 (mod_cdn_form_ice.f90:196-268)."""
    Sc, hf, Di = _sc_hf_di(frice, Sc, hf, Di)
    rlog = torch.log(hf / (z0i * 2.718)) / torch.log(zu / z0i)
    return 0.5 * 0.4 * rlog * rlog * Sc * hf / Di * frice


def cdn_f_lg15_light(zu, frice, z0w):
    """Lüpkes & Gryanik 2015 Eq. 46 (mod_cdn_form_ice.f90:272-306)."""
    rlog = torch.log(10.0 / z0w) / torch.log(zu / z0w)
    return _RCE10_I_0 * rlog * rlog * frice * (1.0 - frice) ** _RBETA_0
