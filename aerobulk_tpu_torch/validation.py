"""Idealized-forcing validation bands (build_validation_idealized.py port).

The reference's acceptance-testing workflow runs all five ocean algorithms
over an idealized one-year forcing series and derives, per flux component
(Qlat, Qsen, Qlw, Tau), a mean and lower/upper acceptance bounds across the
algorithm family (``python/plot_tests/build_validation_idealized.py:4-17``).
A future run is accepted when it stays inside the bands.

The reference's idealized forcing is an external file; here an equivalent
series is generated deterministically (annual + diurnal cycles with
phase-shifted harmonics — same spirit, self-contained).

The counterpart of ``aerobulk_tpu.validation``: the forcing and the bands
are the same numpy code; the runs go through this package's eager series
on a torch device.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from . import constants as c
from . import io as abio
from . import thermo
from .algos import OCEAN_ALGOS
from .api import AeroBulkConfig, run_series
from .skin import default_device

OCEAN_ALGOS_ORDER = ("andreas", "coare3p0", "coare3p6", "ecmwf", "ncar")
FLUX_VARS = ("Qlat", "Qsen", "Qlw", "Tau")


def idealized_forcing(nt: int = 24 * 365, lat: float = 50.0) -> Dict[str, np.ndarray]:
    """Deterministic idealized hourly forcing (PAPA-station-like)."""
    h = np.arange(nt, dtype=np.float64)
    day = h / 24.0
    year = day / 365.0

    sst = 283.0 + 6.0 * np.sin(2 * np.pi * (year - 0.22))        # annual SST
    t2 = sst - 1.0 + 2.5 * np.sin(2 * np.pi * (year - 0.26)) \
        + 1.5 * np.sin(2 * np.pi * day)                           # diurnal
    slp = 101000.0 + 800.0 * np.sin(2 * np.pi * day / 5.3) \
        + 600.0 * np.sin(2 * np.pi * year * 3.0)
    rh = 78.0 + 12.0 * np.sin(2 * np.pi * day / 3.7 + 1.0)

    # specific humidity from RH (host-side numpy mirror of q_air_rh)
    ta = t2
    ztmp = c.rt0 / ta
    es = 100.0 * (10.0 ** (10.79574 * (1 - ztmp) - 5.028 * np.log10(ta / c.rt0)
                           + 1.50475e-4 * (1 - 10.0 ** (-8.2969 * (ta / c.rt0 - 1)))
                           + 0.42873e-3 * (10.0 ** (4.76955 * (1 - ztmp)) - 1)
                           + 0.78614))
    e = 0.01 * rh * es
    q2 = e * c.reps0 / np.maximum(slp - (1 - c.reps0) * e, 1.0)

    wnd = np.maximum(
        0.3, 7.0 + 4.5 * np.sin(2 * np.pi * day / 4.1)
        + 2.0 * np.sin(2 * np.pi * day / 1.3 + 0.7))
    coszen = np.maximum(
        0.0, np.sin(np.deg2rad(lat)) * 0.35
        + np.cos(np.deg2rad(lat)) * np.cos(2 * np.pi * (h % 24 - 12) / 24.0))
    rsw = 1000.0 * coszen * (0.75 + 0.25 * np.sin(2 * np.pi * year))
    rlw = 310.0 + 60.0 * np.sin(2 * np.pi * (year - 0.2)) \
        + 15.0 * np.sin(2 * np.pi * day / 2.3)

    return dict(sst=sst, t_zt=t2, hum_zt=q2, U_zu=wnd,
                V_zu=np.zeros(nt), slp=slp, rad_sw=rsw, rad_lw=rlw,
                isecday_utc=((h % 24) * 3600).astype(np.int64))


def run_idealized(algo: str, forcing=None, niter: int = 10,
                  zt: float = 2.0, zu: float = 10.0,
                  device=None) -> Dict[str, np.ndarray]:
    """Run one algorithm over the idealized forcing; returns flux series.

    The series runs eagerly (``run_series(backend="eager")``) in float64 on
    ``device``: the CUDA device unless the caller names another (pass
    ``device="cpu"`` to run on the CPU); without a GPU and without
    ``device`` this raises."""
    device = default_device(device)
    if forcing is None:
        forcing = idealized_forcing()
    use_skin = OCEAN_ALGOS[algo][1]
    cfg = AeroBulkConfig(algo=algo, zt=zt, zu=zu, niter=niter,
                         use_skin=use_skin)
    keys = ["sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp"]
    if use_skin:
        keys += ["rad_sw", "rad_lw"]
    tf = {k: torch.as_tensor(forcing[k], device=device)[:, None]
          for k in keys}
    outs, _ = run_series(cfg, tf, isecday_utc=forcing["isecday_utc"],
                         backend="eager")

    qlw = thermo.qlw_net(torch.as_tensor(forcing["rad_lw"], device=device),
                         outs.T_s[:, 0])
    return {"Qlat": outs.QL[:, 0].cpu().numpy(),
            "Qsen": outs.QH[:, 0].cpu().numpy(),
            "Qlw": qlw.cpu().numpy(),
            "Tau": outs.Tau[:, 0].cpu().numpy()}


def build_validation_bands(niter: int = 10, device=None
                           ) -> Dict[str, Dict[str, np.ndarray]]:
    """Mean + lower/upper acceptance bounds per flux across the five
    algorithms over the idealized forcing (run on ``device``, as
    :func:`run_idealized`)."""
    forcing = idealized_forcing()
    runs = {a: run_idealized(a, forcing, niter=niter, device=device)
            for a in OCEAN_ALGOS_ORDER}
    bands = {}
    for v in FLUX_VARS:
        stack = np.stack([runs[a][v] for a in OCEAN_ALGOS_ORDER])
        bands[v] = {"mean": stack.mean(axis=0),
                    "lower": stack.min(axis=0),
                    "upper": stack.max(axis=0)}
    return bands


def write_validation_file(path: str = "VALIDATION_IDEALIZED.nc",
                          niter: int = 10, device=None):
    """Write the acceptance-band file (VALIDATION_IDEALIZED.nc analogue)."""
    bands = build_validation_bands(niter=niter, device=device)
    nt = len(next(iter(bands.values()))["mean"])
    time = np.arange(nt, dtype=np.float64) * 3600.0
    variables = {}
    for v, b in bands.items():
        for which in ("mean", "lower", "upper"):
            variables[f"{v}_{which}"] = b[which]
    abio.write_series(path, time, variables)
    return bands


def check_against_bands(series: Dict[str, np.ndarray],
                        bands: Dict[str, Dict[str, np.ndarray]],
                        slack: float = 0.05) -> Dict[str, bool]:
    """Accept a run when each flux stays within [lower, upper] (+/- a
    relative slack of the band width)."""
    verdict = {}
    for v in FLUX_VARS:
        if v not in series:
            continue
        lo, up = bands[v]["lower"], bands[v]["upper"]
        width = np.maximum(up - lo, 1e-6) * slack
        ok = np.all((series[v] >= lo - width) & (series[v] <= up + width))
        verdict[v] = bool(ok)
    return verdict
