"""Forcing reader / diagnostics writer + calendar helpers.

Host-side replacement for the reference's test-only NetCDF helper library
``io_ezcdf.f90`` (DIMS / GETVAR_1D / PT_SERIES / time_to_date, SURVEY.md
§2.1).  Everything here runs on numpy: the same functions as
``aerobulk_tpu.io``, kept in this package so that it never imports that one
(whose package imports jax).  A file written by either module reads
identically in the other.

Formats: NetCDF-4/HDF5 via h5py, classic NetCDF-3 via scipy, and .npz —
the environment ships no netCDF4/xarray, and these three cover every file
the reference's tooling produces or consumes.

The variable-name registries mirror ``set_variable_names_default`` /
``set_variable_names_ecmwf`` (mod_const.f90:208-234).
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional

import numpy as np

__all__ = [
    "VAR_NAMES_DEFAULT", "VAR_NAMES_ECMWF", "read_forcing", "write_series",
    "time_to_date", "to_epoch", "seconds_of_day",
]

#: aerobulk-internal name -> NetCDF variable name (mod_const.f90:208-220)
VAR_NAMES_DEFAULT = {
    "sst": "sst", "slp": "msl", "t_air": "t_air", "q_air": "q_air",
    "rh_air": "rh_air", "dp_air": "dp_air", "wndspd": "wndspd",
    "u_wnd": "u10", "v_wnd": "v10", "rad_sw": "ssrd", "rad_lw": "strd",
    "time": "time",
}

#: ECMWF-convention names (mod_const.f90:222-234)
VAR_NAMES_ECMWF = dict(VAR_NAMES_DEFAULT,
                       t_air="t2m", q_air="q2m", rh_air="rh2m",
                       dp_air="d2m")


def _read_any(path: str) -> Dict[str, np.ndarray]:
    """Load every variable of a NetCDF3/NetCDF4/npz file into a dict."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    # try HDF5-based NetCDF4 first
    try:
        import h5py
        with h5py.File(path, "r") as f:
            out = {}

            def visit(name, obj):
                if isinstance(obj, h5py.Dataset):
                    out[name.split("/")[-1]] = np.asarray(obj[()])
            f.visititems(visit)
            return out
    except (OSError, ImportError):
        pass
    # classic NetCDF3
    from scipy.io import netcdf_file
    with netcdf_file(path, "r", mmap=False) as f:
        return {k: np.asarray(v[:]) for k, v in f.variables.items()}


def read_forcing(path: str, names: Optional[dict] = None,
                 squeeze_3x3: bool = True) -> Dict[str, np.ndarray]:
    """Read a forcing file into aerobulk-internal variable names.

    Implements the GETVAR semantics the reference's buoy driver needs,
    including the NEMO STATION_ASF convention of storing a station as a
    3x3 spatial patch whose centre point carries the data
    (io_ezcdf.f90:410-445): with ``squeeze_3x3`` any trailing (3, 3)
    spatial shape collapses to the centre point.
    """
    names = names or VAR_NAMES_DEFAULT
    raw = _read_any(path)
    rev = {v: k for k, v in names.items()}
    out = {}
    for fname, arr in raw.items():
        key = rev.get(fname, fname)
        if squeeze_3x3 and arr.ndim >= 2 and arr.shape[-2:] == (3, 3):
            arr = arr[..., 1, 1]
        out[key] = np.squeeze(arr)
    return out


def write_series(path: str, time: np.ndarray, variables: Dict[str, np.ndarray],
                 units: Optional[Dict[str, str]] = None,
                 time_units: str = "seconds since 1970-01-01 00:00:00"):
    """Write a multi-variable time series (the ``PT_SERIES`` analogue,
    io_ezcdf.f90:1033) or gridded (nt, ny, nx) fields (the P2D_T dumper
    analogue).  Classic NetCDF3 via scipy for portability; .npz when the
    extension asks for it.

    A (nt,) variable becomes a point series; (nt, n) keeps its station
    axis; (nt, ny, nx) becomes a 2-D field series.
    """
    units = units or {}
    if path.endswith(".npz"):
        np.savez(path, time=time, **variables)
        return
    from scipy.io import netcdf_file
    with netcdf_file(path, "w") as f:
        f.createDimension("time", len(time))
        tv = f.createVariable("time", "d", ("time",))
        tv[:] = np.asarray(time, np.float64)
        tv.units = time_units.encode()
        made_dims = {"time": len(time)}

        def dim_for(size, stem):
            for dname, dsize in made_dims.items():
                if dsize == size and dname != "time":
                    return dname
            dname = f"{stem}{len(made_dims)}"
            f.createDimension(dname, size)
            made_dims[dname] = size
            return dname

        for name, arr in variables.items():
            arr = np.asarray(arr, np.float64)
            if arr.ndim == 1:
                dims = ("time",)
            elif arr.ndim == 2:
                dims = ("time", dim_for(arr.shape[1], "x"))
            elif arr.ndim == 3:
                dims = ("time", dim_for(arr.shape[1], "y"),
                        dim_for(arr.shape[2], "x"))
            else:
                raise ValueError(f"write_series: {name} has ndim {arr.ndim}")
            v = f.createVariable(name, "d", dims)
            v[:] = arr
            if name in units:
                v.units = units[name].encode()


# ---------------------------------------------------------------------------
# calendar (io_ezcdf.f90:2387-2741 equivalents)
# ---------------------------------------------------------------------------

_EPOCH = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def _parse_time_units(units: str):
    """Parse 'seconds since YYYY-MM-DD [hh:mm:ss]' CF-style units."""
    parts = units.split("since")
    scale = {"seconds": 1.0, "minutes": 60.0, "hours": 3600.0,
             "days": 86400.0}[parts[0].strip().lower()]
    ref = parts[1].strip()
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d %H:%M", "%Y-%m-%d"):
        try:
            t0 = datetime.datetime.strptime(ref, fmt).replace(
                tzinfo=datetime.timezone.utc)
            return scale, t0
        except ValueError:
            continue
    raise ValueError(f"cannot parse time units {units!r}")


def time_to_date(values, units: str):
    """CF time values -> array of datetimes (``time_to_date`` analogue)."""
    scale, t0 = _parse_time_units(units)
    return np.array([t0 + datetime.timedelta(seconds=float(v) * scale)
                     for v in np.atleast_1d(values)])


def to_epoch(values, units: str) -> np.ndarray:
    """CF time values -> seconds since the Unix epoch."""
    scale, t0 = _parse_time_units(units)
    off = (t0 - _EPOCH).total_seconds()
    return np.atleast_1d(np.asarray(values, np.float64)) * scale + off


def seconds_of_day(epoch_seconds) -> np.ndarray:
    """UTC seconds since 00h of the day — the warm-layer ``isecday_utc``."""
    return np.asarray(np.mod(epoch_seconds, 86400.0), np.int64)
