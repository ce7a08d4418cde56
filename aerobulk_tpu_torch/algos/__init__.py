"""Bulk-algorithm registry, with the names and flags of
``aerobulk_tpu.algos.OCEAN_ALGOS``.

The reference dispatches through a SELECT CASE
(mod_aerobulk_compute.f90:129-176); here dispatch is a dict of functions
with one signature.  ``supports_skin`` marks the algorithms that run the
cool-skin/warm-layer schemes (COARE*/ECMWF, mod_aerobulk.f90:67-79).
"""

from .andreas import turb_andreas
from .base import FluxResult
from .coare import turb_coare, turb_coare3p0, turb_coare3p6
from .ecmwf import turb_ecmwf
from .ncar import turb_ncar

#: name -> (function, supports_skin, needs_solar_time)
OCEAN_ALGOS = {
    "coare3p0": (turb_coare3p0, True, True),
    "coare3p6": (turb_coare3p6, True, True),
    "ecmwf": (turb_ecmwf, True, False),
    "ncar": (turb_ncar, False, False),
    "andreas": (turb_andreas, False, False),
}

__all__ = [
    "FluxResult", "OCEAN_ALGOS", "turb_andreas", "turb_coare",
    "turb_coare3p0", "turb_coare3p6", "turb_ecmwf", "turb_ncar",
]
