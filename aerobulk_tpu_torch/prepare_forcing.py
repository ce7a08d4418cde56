"""Forcing-preparation utilities — the python/misc equivalents.

The same functions as ``aerobulk_tpu.prepare_forcing`` (numpy only), kept in
this package so that it never imports that one, whose package imports jax.

The reference ships data-prep scripts (``build_q2_from_d2_slp.py``,
``prepare_PAPA_forcing_aerobulk.py``, ``download_prepare_ERA5*.py``) that
convert raw reanalysis / mooring files to AeroBulk conventions.  This
module provides the conversion core as reusable functions (downloading is
out of scope in a zero-egress environment — point these at local files):

  * q2 from dew point + slp (the build_q2_from_d2_slp capability);
  * unit normalization (degC->K, hPa->Pa, accumulated J/m^2 -> W/m^2 for
    ERA5 radiation);
  * variable-name normalization to the aerobulk registry;
  * land/range masking with a fill value.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from . import constants as c
from . import io as abio

__all__ = ["q2_from_d2_slp", "normalize_units", "prepare_forcing_dict",
           "era5_accum_to_flux", "build_era5_cds_requests",
           "write_era5_download_script", "ERA5_SURFACE_VARS", "RMISS"]

RMISS = -9999.0   # reference scripts' fill value


def q2_from_d2_slp(d2: np.ndarray, slp: np.ndarray,
                   mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Specific humidity at 2 m from dew-point temperature and sea-level
    pressure (host-side numpy; same Goff formula as the compute core)."""
    d2 = np.asarray(d2, np.float64)
    slp = np.asarray(slp, np.float64)
    ta = np.maximum(d2, 180.0)
    ztmp = c.rt0 / ta
    es = 100.0 * (10.0 ** (
        10.79574 * (1 - ztmp) - 5.028 * np.log10(ta / c.rt0)
        + 1.50475e-4 * (1 - 10.0 ** (-8.2969 * (ta / c.rt0 - 1)))
        + 0.42873e-3 * (10.0 ** (4.76955 * (1 - ztmp)) - 1) + 0.78614))
    q2 = es * c.reps0 / np.maximum(slp - (1 - c.reps0) * es, 1.0)
    if mask is not None:
        q2 = np.where(np.asarray(mask) >= 0.5, q2, RMISS)
    return q2


def era5_accum_to_flux(x: np.ndarray, accum_seconds: float = 3600.0):
    """ERA5 ssrd/strd are accumulated J/m^2 over the step -> mean W/m^2."""
    return np.asarray(x, np.float64) / accum_seconds


def normalize_units(name: str, x: np.ndarray) -> np.ndarray:
    """Heuristic unit normalization matching the reference's TO_KELVIN_3D
    and hPa checks (mod_phymbl.f90:1826-1848 spirit)."""
    x = np.asarray(x, np.float64)
    m = np.nanmean(np.where(x == RMISS, np.nan, x))
    if name in ("sst", "t_air", "dp_air"):
        if -80.0 < m < 50.0:
            return x + c.rt0          # degC -> K
        return x
    if name == "slp":
        if 800.0 < m < 1100.0:
            return x * 100.0          # hPa -> Pa
        return x
    return x


# ERA5 surface variables required for OGCM atmospheric forcing:
# short (NetCDF) name -> cdsapi request name
# (download_prepare_ERA5.py:34-36)
ERA5_SURFACE_VARS = {
    "u10": "10m_u_component_of_wind",
    "v10": "10m_v_component_of_wind",
    "d2m": "2m_dewpoint_temperature",
    "t2m": "2m_temperature",
    "msl": "mean_sea_level_pressure",
    "ssrd": "surface_solar_radiation_downwards",
    "strd": "surface_thermal_radiation_downwards",
    "tp": "total_precipitation",
}

# accumulated variables and their conversion once downloaded (divide the
# per-step accumulation by rdt; tp is in metres -> mm/s)
# (download_prepare_ERA5.py:114-117)
ERA5_ACCUM_FACTORS = {"ssrd": 1.0, "strd": 1.0, "tp": 1000.0}


def _lon_to_m180_p180(x):
    """Force a longitude into [-180, 180] (download_prepare_ERA5.py:125-130)."""
    import math
    x = x % 360.0
    return math.copysign(1.0, 180.0 - x) * min(x, abs(x - 360.0))


def build_era5_cds_requests(year, lat_min=-90.0, lat_max=90.0,
                            lon_min=-180.0, lon_max=180.0, freq="1h",
                            variables=None):
    """Build the CDS-API request dicts the reference's
    ``download_prepare_ERA5.py`` constructs (one per surface variable,
    whole year, hourly or 3-hourly snapshots, regional area box).

    This is the download tooling minus the network call: pass each
    ``(filename, request)`` pair to ``cdsapi.Client().retrieve(
    'reanalysis-era5-single-levels', request, filename)`` on a machine
    with CDS credentials (cdsapi is not installed here — zero-egress
    environment), then run the local files through
    :func:`prepare_forcing_dict` (with ``accum_radiation=3600``) to get
    aerobulk-convention forcing.

    Returns ``[(out_filename, request_dict), ...]``.
    """
    if variables is None:
        variables = list(ERA5_SURFACE_VARS)
    unknown = set(variables) - set(ERA5_SURFACE_VARS)
    if unknown:
        raise ValueError(f"unknown ERA5 variables {sorted(unknown)}; "
                         f"known: {sorted(ERA5_SURFACE_VARS)}")
    if freq == "1h":
        hours = range(24)
    elif freq == "3h":
        hours = range(0, 24, 3)
    else:
        raise ValueError("freq must be '1h' or '3h'")
    times = [f"{h:02d}:00" for h in hours]
    months = [f"{m:02d}" for m in range(1, 13)]
    days = [f"{d:02d}" for d in range(1, 32)]
    if (lon_min, lon_max) != (-180.0, 180.0):
        lon_min = _lon_to_m180_p180(lon_min)
        lon_max = _lon_to_m180_p180(lon_max)
    label = (f"_{int(lat_min)}N_{int(lon_min)}E_{int(lat_max)}N_"
             f"{int(lon_max)}E_")

    out = []
    for short in variables:
        req = {
            "product_type": "reanalysis",
            "format": "netcdf",
            "variable": [ERA5_SURFACE_VARS[short]],
            "year": str(int(year)),
            "month": months,
            "day": days,
            "time": times,
            "area": [lat_max, lon_min, lat_min, lon_max],
        }
        out.append((f"{short}_ERA5_surface{label}{int(year)}.nc", req))
    return out


def write_era5_download_script(path, year, **kw):
    """Emit a self-contained download script (to run where cdsapi and
    network exist) from :func:`build_era5_cds_requests`."""
    import json
    reqs = build_era5_cds_requests(year, **kw)
    lines = [
        "#!/usr/bin/env python3",
        '"""ERA5 surface forcing download (generated by',
        f'{__name__}.write_era5_download_script).',
        "Requires cdsapi + CDS credentials.  After download, convert with",
        f"{__name__}.prepare_forcing_dict(...,",
        'accum_radiation=3600)."""',
        "import os, cdsapi",
        "c = cdsapi.Client()",
    ]
    for fname, req in reqs:
        lines += [
            f"if not os.path.exists({fname!r}):",
            f"    c.retrieve('reanalysis-era5-single-levels',",
            f"               {json.dumps(req)}, {fname!r})",
        ]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path


def prepare_forcing_dict(path: str, names: Optional[dict] = None,
                         accum_radiation: Optional[float] = None
                         ) -> Dict[str, np.ndarray]:
    """Read a raw forcing file and return unit-normalized arrays under
    aerobulk-internal names, deriving q_air from dp_air when needed."""
    f = abio.read_forcing(path, names=names)
    out = {}
    for k, v in f.items():
        out[k] = normalize_units(k, v)
    if "q_air" not in out and "dp_air" in out and "slp" in out:
        out["q_air"] = q2_from_d2_slp(out["dp_air"], out["slp"])
    if accum_radiation:
        for k in ("rad_sw", "rad_lw"):
            if k in out:
                out[k] = era5_accum_to_flux(out[k], accum_radiation)
    return out
