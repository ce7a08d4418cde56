"""Neutral-stability transfer coefficients at 10 m against the 10-m
neutral wind, on tensors.

``TURB_NEUTRAL_10M`` (mod_blk_neutral_10m.f90:33-209), the curves of the
reference's ``test_coef_n10.x`` diagnostics.  As in
``aerobulk_tpu.algos.neutral_10m``, the 'andreas' branch (``STOP 'YET TO
BE CODED'`` in the reference, mod_blk_neutral_10m.f90:196) is the
Andreas-2015 u*(UN10) closure with LKB scalar roughness.
"""

from __future__ import annotations

import torch

from .. import constants as c
from ..closures import (cd_n10_ncar, ce_n10_ncar, ch_n10_ncar,
                        charn_coare3p0, charn_coare3p6, u_star_andreas)
from ..thermo import maxc, minc, z0_from_cd, z0tq_lkb
from .ecmwf import CHARN0_ECMWF

_ZU = 10.0


def turb_neutral_10m(algo, U_N10, niter=5):
    """Neutral CdN10/ChN10/CeN10/z0 from the 10-m neutral wind speed.

    ``algo`` is one of 'coare3p0', 'coare3p6', 'ecmwf', 'ncar', 'andreas';
    ``niter`` is the number of z0 <-> CdN iterations of the COARE/ECMWF
    branch.  Returns ``(CdN10, ChN10, CeN10, z0)``."""
    if algo in ("coare3p0", "coare3p6", "ecmwf"):
        Ub = maxc(U_N10, 0.1)
        charn = {"coare3p0": charn_coare3p0,
                 "coare3p6": charn_coare3p6,
                 "ecmwf": lambda u: torch.full_like(u, CHARN0_ECMWF)}[algo]

        CdN10 = 8.575e-5 * Ub + 0.657e-3    # first guess from ref. curves
        us = z0 = log_zu_z0 = None
        for _ in range(niter):
            us = Ub * torch.sqrt(CdN10)
            z0 = charn(Ub) * us * us / c.grav + 0.11 * c.rnu0_air / us
            log_zu_z0 = torch.log(_ZU / z0)
            CdN10 = c.vkarmn2 / (log_zu_z0 * log_zu_z0)

        if algo == "coare3p0":
            rer = z0 * us / c.rnu0_air
            z0t = minc(5.5e-5 * rer ** (-0.6), 1.1e-4)
            z0q = z0t
        elif algo == "coare3p6":
            rer = z0 * us / c.rnu0_air
            z0t = minc(5.8e-5 * rer ** (-0.72), 1.6e-4)
            z0q = z0t
        else:   # ecmwf
            nu_on_us = c.rnu0_air / us
            z0t = 0.40 * nu_on_us
            z0q = 0.62 * nu_on_us

        ChN10 = c.vkarmn2 / (log_zu_z0 * torch.log(_ZU / z0t))
        CeN10 = c.vkarmn2 / (log_zu_z0 * torch.log(_ZU / z0q))
        return CdN10, ChN10, CeN10, z0

    if algo == "ncar":
        Ub = maxc(U_N10, 0.5)
        CdN10 = cd_n10_ncar(Ub)
        s = torch.sqrt(CdN10)
        ChN10 = ch_n10_ncar(s, torch.zeros_like(Ub))   # unstable-case value
        CeN10 = ce_n10_ncar(s)
        z0 = minc(maxc(z0_from_cd(_ZU, CdN10), 0.0001), 0.1)
        return CdN10, ChN10, CeN10, z0

    if algo == "andreas":
        Ub = maxc(U_N10, 0.5)
        us = u_star_andreas(Ub)
        r = us / Ub
        CdN10 = r * r
        z0 = z0_from_cd(_ZU, CdN10)
        rer = z0 * us / c.rnu0_air
        z0t = z0tq_lkb(1, rer, z0)
        z0q = z0tq_lkb(2, rer, z0)
        log_zu_z0 = torch.log(_ZU / z0)
        ChN10 = c.vkarmn2 / (log_zu_z0 * torch.log(_ZU / z0t))
        CeN10 = c.vkarmn2 / (log_zu_z0 * torch.log(_ZU / z0q))
        return CdN10, ChN10, CeN10, z0

    raise ValueError(f"turb_neutral_10m: unknown algorithm {algo!r}")
