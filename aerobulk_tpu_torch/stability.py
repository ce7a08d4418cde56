"""COARE stability-profile functions psi_m / psi_h on tensors
(mod_common_coare.f90:217-392).

Branch-free, as in ``aerobulk_tpu.stability``: the reference's
``0.5 + SIGN(0.5, zeta)`` mask becomes :func:`thermo.step`.
"""

from __future__ import annotations

import torch

from .constants import rpi
from .math_compat import arctan
from .thermo import absj, minc, step

__all__ = ["psi_m_coare", "psi_h_coare"]

_INV_3 = 1.0 / 3.0
_INV_SQRT3 = 1.0 / 1.7320508


def _pos_or_one(a):
    """``a`` where positive, else 1 — grad-safety feed for a
    ``sqrt``/``**frac`` whose argument can land exactly on 0 inside a
    branch the stability mask zeroes out (e.g. ``|1-15z|`` at z=1/15).
    Only masked-branch values change, so every psi value is unchanged,
    and the backward pass no longer meets ``inf slope x 0 = NaN``."""
    return torch.where(a > 0.0, a, 1.0)


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
