"""Diagnostic figures — the python/plot_tests equivalents.

Consumes the JSON / NetCDF artifacts the CLI sweeps produce:

  plot_cx_wind        <- cli cx-vs-wind   (plot_Cx_wind.py analogue)
  plot_coef_n10       <- cli coef-n10     (plot_CxN10_UN10.py analogue)
  plot_psi_profiles   <- cli psi-stab     (plot_Psi_profiles.py analogue)
  plot_station_series <- cli series       (plot_station_asf.py analogue)

All functions take the artifact path and save a PNG; headless Agg backend.
The same figures as ``aerobulk_tpu.plotting``, reading the artifacts of this
package's CLI through its own ``io``.
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["plot_cx_wind", "plot_coef_n10", "plot_psi_profiles",
           "plot_station_series", "plot_ice_cdn", "plot_ice_bulk_comp"]


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_cx_wind(json_path: str, out_png: str = "cx_vs_wind.png",
                 coef: str = "Cd"):
    plt = _plt()
    with open(json_path) as fh:
        data = json.load(fh)
    w = np.asarray(data["wind"])
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    for name, curves in sorted(data["curves"].items()):
        ax.plot(w, 1e3 * np.asarray(curves[coef]), lw=1, label=name)
    ax.set_xlabel("wind speed at zu [m/s]")
    ax.set_ylabel(f"{coef} [10^-3]")
    ax.set_title(f"{coef} vs wind")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=7, ncol=2)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_coef_n10(json_path: str, out_png: str = "coef_n10.png"):
    plt = _plt()
    with open(json_path) as fh:
        data = json.load(fh)
    u = np.asarray(data["UN10"])
    fig, axes = plt.subplots(1, 3, figsize=(15, 5), dpi=100, sharex=True)
    for algo, c in sorted(data["curves"].items()):
        for ax, key in zip(axes, ("CdN10", "ChN10", "CeN10")):
            ax.plot(u, 1e3 * np.asarray(c[key]), lw=1.2, label=algo)
    for ax, key in zip(axes, ("CdN10", "ChN10", "CeN10")):
        ax.set_xlabel("UN10 [m/s]")
        ax.set_ylabel(f"{key} [10^-3]")
        ax.grid(alpha=0.3)
    axes[0].legend(fontsize=8)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_psi_profiles(json_path: str, out_png: str = "psi_profiles.png"):
    plt = _plt()
    with open(json_path) as fh:
        data = json.load(fh)
    z = np.asarray(data["zeta"])
    fig, (axm, axh) = plt.subplots(1, 2, figsize=(13, 6), dpi=100)
    for fam, c in sorted(data["curves"].items()):
        axm.plot(z, c["psi_m"], lw=1.2, label=fam)
        axh.plot(z, c["psi_h"], lw=1.2, label=fam)
    for ax, t in ((axm, "psi_m"), (axh, "psi_h")):
        ax.set_xlabel("zeta = z/L")
        ax.set_ylabel(t)
        ax.set_ylim(-20, 6)
        ax.grid(alpha=0.3)
    axm.legend(fontsize=8)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_ice_cdn(json_path: str, out_png: str = "ice_cdn.png"):
    """Form-drag CdN_f variants vs ice concentration
    (plot_ice_cdn_comp.py analogue; consumes `cli cdnf` output)."""
    plt = _plt()
    with open(json_path) as fh:
        data = json.load(fh)
    A = np.asarray(data["frice"])
    fig, ax = plt.subplots(figsize=(9, 6), dpi=100)
    for k, v in sorted(data.items()):
        if k == "frice":
            continue
        ax.plot(A, 1e3 * np.asarray(v), lw=1.4, label=k)
    ax.set_xlabel("ice concentration A")
    ax.set_ylabel("CdN_f [10^-3]")
    ax.grid(alpha=0.3)
    ax.legend(fontsize=8)
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_ice_bulk_comp(nc_paths: dict, out_png: str = "ice_bulk_comp.png",
                       variables=("Qlat", "Qsen", "Tau"),
                       anomalies=True):
    """Multi-algorithm ice bulk-series comparison
    (the reference's python/plot_tests/plot_ice_bulk_comp.py).

    ``nc_paths`` maps a label per ice algorithm (e.g. ``"nemo"``,
    ``"an05"``, ``"lu12"``, ``"lg15"``) to the NetCDF series file written
    by ``cli series --algo ice_*``.  For each variable, every algorithm's
    trajectory is overlaid; with ``anomalies=True`` a second panel per
    variable shows each algorithm minus the first label's trajectory
    (the reference's L_ANOM panels).
    """
    plt = _plt()
    from . import io as abio

    data = {name: abio.read_forcing(p) for name, p in nc_paths.items()}
    names = list(data)
    base = names[0]
    t = np.asarray(data[base].get(
        "time", np.arange(len(np.asarray(next(iter(data[base].values())))))))
    t_days = (np.asarray(t, np.float64) - float(t[0])) / 86400.0

    rows = len(variables) * (2 if anomalies else 1)
    fig, axes = plt.subplots(rows, 1, figsize=(13, 2.4 * rows), dpi=100,
                             sharex=True)
    axes = np.atleast_1d(axes)
    r = 0
    for v in variables:
        ax = axes[r]
        for name in names:
            if v in data[name]:
                ax.plot(t_days, np.asarray(data[name][v]).reshape(len(t), -1)
                        [:, 0], lw=0.9, label=name)
        ax.set_ylabel(v)
        ax.grid(alpha=0.3)
        if r == 0:
            ax.legend(fontsize=8, ncol=len(names))
        r += 1
        if anomalies:
            ax = axes[r]
            ref = np.asarray(data[base][v]).reshape(len(t), -1)[:, 0]
            for name in names[1:]:
                if v in data[name]:
                    cur = np.asarray(data[name][v]).reshape(len(t), -1)[:, 0]
                    ax.plot(t_days, cur - ref, lw=0.9, label=name)
            ax.set_ylabel(f"{v} - {base}")
            ax.grid(alpha=0.3)
            r += 1
    axes[-1].set_xlabel("days")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png


def plot_station_series(nc_path: str, out_png: str = "station_series.png",
                        variables=("Qlat", "Qsen", "Tau", "dT_wl")):
    plt = _plt()
    from . import io as abio
    data = abio.read_forcing(nc_path)
    t = np.asarray(data.get("time", np.arange(len(next(iter(data.values()))))))
    t_days = (t - t[0]) / 86400.0
    n = len(variables)
    fig, axes = plt.subplots(n, 1, figsize=(13, 2.6 * n), dpi=100,
                             sharex=True)
    for ax, v in zip(np.atleast_1d(axes), variables):
        if v in data:
            ax.plot(t_days, np.asarray(data[v]), lw=0.8)
        ax.set_ylabel(v)
        ax.grid(alpha=0.3)
    np.atleast_1d(axes)[-1].set_xlabel("days")
    fig.savefig(out_png, bbox_inches="tight")
    plt.close(fig)
    return out_png
