"""Production demo at full scale: COARE 3.6 + cool-skin/warm-layer over the
0.25-degree global grid (721 x 1440, fp32) on one CUDA device, one
synthetic day of hourly records streamed host->device through the chunked
pipeline (one H2D copy per chunk, one launch of the fused kernel per
record, fluxes collected asynchronously), with NetCDF diagnostics written
through ``io.write_series``.

The analogue of the reference's flagship workload
(test_aerobulk_buoy_series_oce.f90:364-537: NetCDF-fed stateful time loop
-> PT_SERIES diagnostics), at 1M grid points per record instead of one
buoy.  Prints the sustained throughput (including all H2D/D2H) with the
card's name and power limit.

Usage:
    python3 -m aerobulk_tpu_torch.run_global_grid [--ny N] [--nx N]
        [--nt N] [--chunk K] [--out FILE.nc] [--wire f32|i16|i8d]
        [--device cuda|cpu]

Without a GPU it raises unless given ``--device cpu`` (which steps the
eager port on the CPU: a check of the program, not a measurement).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import time

import numpy as np
import torch

from .api import AeroBulkConfig
from .io import write_series
from .pipeline import run_series_pipelined
from .skin import default_device


def synthetic_day(nt, ny, nx):
    """One day of hourly forcing records (synthetic but physically
    shaped: diurnal shortwave cycle, drifting SST, noisy winds)."""
    rng = np.random.default_rng(0)
    sst = (285.0 + 15.0 * rng.random((ny, nx))).astype(np.float32)
    t0 = sst + rng.normal(0, 2, (ny, nx)).astype(np.float32)
    q = (0.004 + 0.012 * rng.random((ny, nx))).astype(np.float32)
    u = rng.normal(0, 6, (ny, nx)).astype(np.float32)
    v = rng.normal(0, 6, (ny, nx)).astype(np.float32)
    slp = np.full((ny, nx), 101000.0, np.float32)
    rlw = np.full((ny, nx), 380.0, np.float32)
    for jt in range(nt):
        diurnal = 700.0 * max(0.0, np.sin((jt - 6) / 12 * np.pi))
        yield {
            "sst": sst + np.float32(0.02 * jt),
            "t_zt": t0,
            "hum_zt": q,
            "U_zu": u,
            "V_zu": v,
            "slp": slp,
            "rad_sw": np.full((ny, nx), diurnal, np.float32),
            "rad_lw": rlw,
            "isecday_utc": np.int32(jt * 3600 % 86400),
        }


def card_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or the
    device's type when it is not a CUDA device."""
    if device.type != "cuda":
        return device.type
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, check=True).stdout.strip()
    return smi.splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ny", type=int, default=721)
    ap.add_argument("--nx", type=int, default=1440)   # 0.25-degree global
    ap.add_argument("--nt", type=int, default=24)     # one day, hourly
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--out", default="global_day_fluxes.nc")
    ap.add_argument("--wire", default="f32", choices=("f32", "i16", "i8d"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)
    ny, nx, nt = args.ny, args.nx, args.nt

    device = default_device(args.device)
    cfg = AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)
    # longitude grid anchors each point's warm-layer solar clock
    lon = np.broadcast_to(np.linspace(0.0, 360.0, nx, endpoint=False,
                                      dtype=np.float32), (ny, nx))

    kw = dict(chunk=args.chunk, lon=lon, inflight=2, wire=args.wire,
              backend="fused" if device.type == "cuda" else "eager",
              device=device,
              collect=lambda out: {"QL": out.QL, "QH": out.QH,
                                   "Tau_x": out.Tau_x, "Evap": out.Evap,
                                   "T_s": out.T_s})

    # warm-up chunk: builds and loads the kernel so the measured run
    # reflects the sustained streaming rate
    run_series_pipelined(cfg, synthetic_day(args.chunk, ny, nx), **kw)

    t0 = time.perf_counter()
    results, final_state = run_series_pipelined(
        cfg, synthetic_day(nt, ny, nx), **kw)
    dT_wl = final_state.dT_wl.cpu().numpy()       # the final true sync
    wall = time.perf_counter() - t0

    pts = nt * ny * nx / wall
    print(f"device: {card_name(device)}  grid: {ny}x{nx}  records: {nt} "
          f"(chunks of {args.chunk}, wire {args.wire})")
    print(f"streamed wall time: {wall:.3f} s  ->  {pts:.4e} points/s "
          "(incl. all H2D + D2H)")

    QL = np.concatenate([r["QL"] for r in results])
    QH = np.concatenate([r["QH"] for r in results])
    Tau_x = np.concatenate([r["Tau_x"] for r in results])
    Evap = np.concatenate([r["Evap"] for r in results])
    T_s = np.concatenate([r["T_s"] for r in results])
    if not (np.isfinite(QL).all() and np.isfinite(T_s).all()):
        raise RuntimeError("run_global_grid: non-finite QL or T_s")

    # NetCDF diagnostics (PT_SERIES analogue): daily mean + final record
    # of each flux, and the final warm-layer state
    tm = np.asarray([0.0, (nt - 1) * 3600.0])
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    write_series(args.out, tm, {
        "QL": np.stack([QL.mean(0), QL[-1]]),
        "QH": np.stack([QH.mean(0), QH[-1]]),
        "Tau_x": np.stack([Tau_x.mean(0), Tau_x[-1]]),
        "Evap": np.stack([Evap.mean(0), Evap[-1]]),
        "T_s": np.stack([T_s.mean(0), T_s[-1]]),
        "dT_wl": np.stack([dT_wl] * 2),
    }, units={"QL": "W/m^2", "QH": "W/m^2", "Tau_x": "N/m^2",
              "Evap": "kg/m^2/s", "T_s": "K", "dT_wl": "K"})
    print(f"wrote {args.out}: daily-mean + final-record QL/QH/Tau_x/Evap/T_s "
          f"and the final warm-layer state")
    print(f"daily-mean global-mean QL = {QL.mean():.2f} W/m^2, "
          f"max warm-layer dT = {float(dT_wl.max()):.3f} K")
    return pts


if __name__ == "__main__":
    main()
