"""Bulk-algorithm registry, with the names and flags of
``aerobulk_tpu.algos.OCEAN_ALGOS``.

Only the COARE family is ported so far.  ``ecmwf``, ``ncar`` and
``andreas`` keep their entries (so configs name them as before) but raise
``NotImplementedError`` when run; none of them falls back to COARE.
"""

from .base import FluxResult
from .coare import turb_coare, turb_coare3p0, turb_coare3p6


def _not_ported(name):
    def turb(*args, **kw):
        raise NotImplementedError(
            f"algorithm {name!r} is not ported to aerobulk_tpu_torch yet "
            "(ROADMAP.md section 1, item 8)")
    turb.__name__ = f"turb_{name}"
    return turb


turb_ecmwf = _not_ported("ecmwf")
turb_ncar = _not_ported("ncar")
turb_andreas = _not_ported("andreas")

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
