"""Command-line tools — the reference test-executable equivalents.

  aerobulk-tpu-torch toy          -> aerobulk_toy.x      (single-point, all algos)
  aerobulk-tpu-torch ice-toy      -> test_aerobulk_ice.x (single-point, ice algos)
  aerobulk-tpu-torch oce-ice-toy  -> test_aerobulk_oce+ice.x (mixed cell)
  aerobulk-tpu-torch series       -> test_aerobulk_buoy_series_oce.x (forcing file)
  aerobulk-tpu-torch cdnf         -> test_aerobulk_cdnf_series.x (form drag)
  aerobulk-tpu-torch cx-vs-wind   -> test_cx_vs_wind.x   (wind/stability sweeps)
  aerobulk-tpu-torch coef-n10     -> test_coef_n10.x     (neutral-coef curves)
  aerobulk-tpu-torch psi-stab     -> test_psi_stab.x     (psi profiles)
  aerobulk-tpu-torch tune         -> the launch-shape sweep of kernels 1 or 5
  aerobulk-tpu-torch bench        -> bench.py's modes on the card
                                     (aerobulk_tpu_torch.bench)

Run via ``python -m aerobulk_tpu_torch.cli [--device cuda|cpu] <subcommand>
[options]``.  Every subcommand computes on the CUDA device unless given
``--device cpu``, in float64 (the reference is -fdefault-real-8 Fortran);
without a GPU and without ``--device cpu`` the command exits non-zero.
``bench`` measures the card alone (fp32, and bf16 in ``--bf16``): it takes
no ``--device cpu``, and without a GPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import bench
from . import constants as c
from . import io as abio
from . import thermo
from .api import (AeroBulkConfig, flux_step, flux_step_ice, flux_step_mixed,
                  run_series)
from .profiling import Profiler

PROG = "aerobulk-tpu-torch"


def _full(value, shape, dev):
    return torch.full(shape, float(value), dtype=torch.float64, device=dev)


def _tensor(x, dev):
    return torch.as_tensor(np.asarray(x, np.float64), device=dev)


def cmd_toy(args):
    """Single-point comparison of all ocean algorithms
    (aerobulk_toy.F90 behaviour; nb_iter=20, slp default 1010 hPa)."""
    dev = args.dev
    shape = (1,)
    sst = _full(args.sst + c.rt0, shape, dev)
    U = _full(args.wind, shape, dev)
    V = _full(0.0, shape, dev)
    slp = _full(args.slp * 100.0, shape, dev)

    if args.neutral:
        # -N mode of aerobulk_toy.F90:205-216: find the air temperature at
        # zt (with the given RH) that makes the virtual potential
        # temperature profile perfectly neutral
        ssq = c.rdct_qsat_salt * thermo.q_sat(sst, slp)
        t_zt = sst
        for _ in range(10):
            q_zt = thermo.q_air_rh(_full(args.rh, shape, dev), t_zt, slp)
            t_zt = (thermo.virt_temp(sst, ssq) / (1.0 + c.rctv0 * q_zt)
                    - c.rgamma_dry * args.zt)
        q_zt = thermo.q_air_rh(_full(args.rh, shape, dev), t_zt, slp)
        print(f" forced neutral: t_zt = {float(t_zt[0]) - c.rt0:.4f} C, "
              f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg (RH={args.rh}%)")
    else:
        t_zt = _full(args.t + c.rt0, shape, dev)
        if args.hum_rh is not None:       # the reference toy's -r mode
            q_zt = thermo.q_air_rh(_full(args.hum_rh, shape, dev), t_zt, slp)
            print(f" humidity from RH={args.hum_rh}%: "
                  f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg")
        elif args.hum_dp is not None:     # the -d (dew point) mode
            q_zt = thermo.q_air_dp(_full(args.hum_dp + c.rt0, shape, dev),
                                   slp)
            print(f" humidity from dew point {args.hum_dp} C: "
                  f"q_zt = {float(q_zt[0]) * 1e3:.4f} g/kg")
        else:
            q_zt = _full(args.q * 1e-3, shape, dev)

    theta = thermo.theta_from_z_p0_t_q(args.zt, slp, t_zt, q_zt)
    print(f"\n zu={args.zu} m, zt={args.zt} m, SST={args.sst} C, "
          f"t_zt={args.t} C, q_zt={args.q} g/kg, U={args.wind} m/s, "
          f"slp={args.slp} hPa, niter={args.niter}")
    print(f" theta_zt = {float(theta[0]) - c.rt0:.5f} C\n")

    algos = ["coare3p0", "coare3p6", "ncar", "ecmwf", "andreas"]
    rows = {k: [] for k in ("C_D", "C_E", "C_H", "z_0", "u*", "L", "UN10",
                            "C_D_N", "C_E_N", "C_H_N", "Tau", "Evap",
                            "QL", "QH")}
    for algo in algos:
        cfg = AeroBulkConfig(algo=algo, zt=args.zt, zu=args.zu,
                             niter=args.niter)
        out, _ = flux_step(cfg, sst, t_zt, q_zt, U, V, slp)
        d = out.diag
        rows["C_D"].append(float(d.Cd[0]) * 1e3)
        rows["C_E"].append(float(d.Ce[0]) * 1e3)
        rows["C_H"].append(float(d.Ch[0]) * 1e3)
        rows["z_0"].append(float(d.z0[0]))
        rows["u*"].append(float(d.u_star[0]))
        rows["L"].append(float(d.L[0]))
        rows["UN10"].append(float(d.UN10[0]))
        rows["C_D_N"].append(float(d.CdN[0]) * 1e3)
        rows["C_E_N"].append(float(d.CeN[0]) * 1e3)
        rows["C_H_N"].append(float(d.ChN[0]) * 1e3)
        rows["Tau"].append(float(out.Tau[0]) * 1e3)
        rows["Evap"].append(float(out.Evap[0]) * 86400.0)
        rows["QL"].append(float(out.QL[0]))
        rows["QH"].append(float(out.QH[0]))

    hdr = "   Algorithm:   " + " | ".join(f"{a:>10s}" for a in algos)
    print("=" * len(hdr))
    print(hdr)
    print("=" * len(hdr))
    units = {"C_D": "[10^-3]", "C_E": "[10^-3]", "C_H": "[10^-3]",
             "z_0": "[m]", "u*": "[m/s]", "L": "[m]", "UN10": "[m/s]",
             "C_D_N": "[10^-3]", "C_E_N": "[10^-3]", "C_H_N": "[10^-3]",
             "Tau": "[mN/m^2]", "Evap": "[mm/day]", "QL": "[W/m^2]",
             "QH": "[W/m^2]"}
    for k, vals in rows.items():
        cells = " | ".join(f"{v:10.5g}" for v in vals)
        print(f"   {k:<10s}  {cells}   {units[k]}")
    print("=" * len(hdr))


def cmd_ice_toy(args):
    """Single-point comparison of the ice algorithms
    (test_aerobulk_ice.f90 behaviour)."""
    from .ice import ICE_ALGOS

    dev = args.dev
    shape = (1,)
    Ts_i = _full(args.ts + c.rt0, shape, dev)
    t_zt = _full(args.t + c.rt0, shape, dev)
    slp = _full(args.slp * 100.0, shape, dev)
    q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp, l_ice=True)
    U = _full(args.wind, shape, dev)
    V = _full(0.0, shape, dev)
    frice = _full(args.frice, shape, dev)

    print(f"\n zu={args.zu} m, zt={args.zt} m, Ts_ice={args.ts} C, "
          f"t_zt={args.t} C, RH={args.rh}%, U={args.wind} m/s, "
          f"A={args.frice}\n")
    print(f" {'algo':>10s} {'Cd[e-3]':>9s} {'Ch[e-3]':>9s} {'Ce[e-3]':>9s}"
          f" {'QH[W/m2]':>10s} {'QL[W/m2]':>10s} {'Tau[mN/m2]':>11s}")
    for algo in ICE_ALGOS:
        out, d = flux_step_ice(algo, args.zt, args.zu, Ts_i, t_zt, q_zt,
                               U, V, slp, frice=frice, niter=args.niter)
        print(f" {algo:>10s} {float(d.Cd[0])*1e3:9.4f} "
              f"{float(d.Ch[0])*1e3:9.4f} {float(d.Ce[0])*1e3:9.4f} "
              f"{float(out.QH[0]):10.3f} {float(out.QL[0]):10.3f} "
              f"{float(out.Tau[0])*1e3:11.4f}")


def cmd_oce_ice_toy(args):
    """Single-point mixed ocean+ice cell comparison
    (test_aerobulk_oce+ice.f90 behaviour): ECMWF over the leads + each of
    the ice algorithms over the ice fraction, plus the LG15_IO
    simultaneous ice+water solve."""
    dev = args.dev
    shape = (1,)
    Ts_i = _full(args.ts + c.rt0, shape, dev)
    sst = _full(args.sst + c.rt0, shape, dev)
    t_zt = _full(args.t + c.rt0, shape, dev)
    slp = _full(args.slp * 100.0, shape, dev)
    q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp)
    U = _full(args.wind, shape, dev)
    V = _full(0.0, shape, dev)
    frice = _full(args.frice, shape, dev)

    print(f"\n zu={args.zu} m, zt={args.zt} m, Ts_ice={args.ts} C, "
          f"SST={args.sst} C, t_zt={args.t} C, RH={args.rh}%, "
          f"U={args.wind} m/s, A={args.frice}\n")
    print(f" {'ice algo':>12s} {'QH_net':>9s} {'QL_net':>9s} "
          f"{'Tau_net':>9s} {'QH_ice':>9s} {'QH_oce':>9s}  [W/m2, N/m2]")

    for algo in ("ice_nemo", "ice_an05", "ice_lg15"):
        net, oi, ow = flux_step_mixed(args.zt, args.zu, Ts_i, sst, t_zt,
                                      q_zt, U, V, slp, frice,
                                      ice_algo=algo, niter=args.niter)
        print(f" {algo:>12s} {float(net.QH[0]):9.3f} "
              f"{float(net.QL[0]):9.3f} {float(net.Tau[0]):9.5f} "
              f"{float(oi.QH[0]):9.3f} {float(ow.QH[0]):9.3f}")

    net, oi, ow = flux_step_mixed(args.zt, args.zu, Ts_i, sst, t_zt, q_zt,
                                  U, V, slp, frice, simultaneous=True,
                                  niter=args.niter)
    print(f" {'lg15_io(sim)':>12s} {float(net.QH[0]):9.3f} "
          f"{float(net.QL[0]):9.3f} {float(net.Tau[0]):9.5f} "
          f"{float(oi.QH[0]):9.3f} {float(ow.QH[0]):9.3f}")


def _columns(f, nt, source):
    """``col(name, *alts, default=None)``: the first of the named forcing
    variables, as float64 of shape ``(nt, -1)``."""
    def col(name, *alts, default=None):
        for n in (name,) + alts:
            if n in f:
                return np.atleast_1d(np.asarray(f[n], np.float64)).reshape(
                    nt, -1)
        if default is not None:
            return np.full((nt, 1), default)
        raise KeyError(f"forcing variable {name!r} not found in {source}")
    return col


def _map(fn, *trees):
    """``fn`` over the tensor or array leaves of matching named tuples
    (None stays None)."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        return type(first)(*(_map(fn, *parts) for parts in zip(*trees)))
    return fn(*trees)


def _ocean_columns(f, nt, col, use_skin):
    """The ocean series' forcing columns (float64, (nt, -1)), its time axis
    and the records' UTC seconds of day."""
    sst = col("sst")
    sst = sst + c.rt0 if sst.mean() < 200.0 else sst
    t_air = col("t_air", "t2m")
    t_air = t_air + c.rt0 if t_air.mean() < 200.0 else t_air
    hum = col("q_air", "q2m", "rh_air", "dp_air")
    slp = col("slp", "msl", default=101000.0)
    if "wndspd" in f:
        wnd = col("wndspd")
        u, v = wnd, np.zeros_like(wnd)
    else:
        u, v = col("u_wnd", "u10"), col("v_wnd", "v10")

    forcing_np = dict(sst=sst, t_zt=t_air, hum_zt=hum, U_zu=u, V_zu=v,
                      slp=slp)
    if use_skin:
        forcing_np["rad_sw"] = col("rad_sw", "ssrd", default=0.0)
        forcing_np["rad_lw"] = col("rad_lw", "strd", default=350.0)

    if "time" in f:
        time = np.asarray(f["time"], np.float64)
        isd = np.asarray(abio.seconds_of_day(time), np.int32)
    else:
        # no time column: synthesize an hourly axis starting at 00h UTC
        # and derive the warm layer's seconds-of-day from it (the library
        # refuses a silent default — see api.flux_step on the reference's
        # hardcoded isecday_utc=12 bug)
        time = np.arange(nt, dtype=np.float64) * 3600.0
        isd = np.asarray(time % 86400.0, np.int32)

    return forcing_np, time, isd


def cmd_series(args):
    """Time-series run over a forcing file: ocean algorithms through
    ``run_series`` (test_aerobulk_buoy_series_oce.x analogue) or, with an
    ``ice_*`` algorithm, the ice algorithm family over ice-station forcing
    (test_aerobulk_buoy_series_ice.x analogue).  ``args.profiler`` times
    the stages: read (the file into float64 columns), put (host ->
    device), series (the time loop, synchronized; with ``--chunk`` the
    streamed feed, put included) and write (read-back and the file)."""
    dev, prof = args.dev, args.profiler
    if args.backend == "fused" and dev.type != "cuda":
        sys.exit(f"{PROG} series: --backend fused runs CUDA kernel 1 and has "
                 "no CPU route; use --backend eager with --device cpu")
    if args.algo.startswith("ice_"):
        return _series_ice(args)

    with prof.stage("read"):
        f = abio.read_forcing(args.file)
        nt = len(f["sst"])
        col = _columns(f, nt, args.file)
        forcing_np, time, isd = _ocean_columns(f, nt, col, args.skin)

    cfg = AeroBulkConfig(algo=args.algo, zt=args.zt, zu=args.zu,
                         niter=args.niter, use_skin=args.skin)
    if args.backend == "fused":
        # kernel 1 takes 2-D (y, x) grids; station series are (nt, 1)
        forcing_np = {k: v.reshape(nt, 1, -1) for k, v in forcing_np.items()}
    if args.chunk:
        # the streamed feed (run_series_pipelined chunked mode): records are
        # fed host->device chunk by chunk with the compute of chunk k
        # overlapping the transfer of chunk k+1 — the production shape
        # when the forcing does not fit in device memory.  Records stream
        # from the HOST copy of the forcing; only the first point of each
        # output, the one written, comes back.
        from .pipeline import run_series_pipelined

        def records():
            for jt in range(nt):
                rec = {k: v[jt] for k, v in forcing_np.items()}
                rec["isecday_utc"] = isd[jt]
                yield rec

        with prof.stage("series", block=True):
            chunks, _ = run_series_pipelined(
                cfg, records(), chunk=args.chunk, backend=args.backend,
                collect=lambda o: _map(
                    lambda x: x.reshape(x.shape[0], -1)[:, 0].contiguous(),
                    o),
                device=dev)
            outs = _map(lambda *xs: np.concatenate(xs), *chunks)
    else:
        with prof.stage("put", block=True):
            forcing = {k: torch.from_numpy(v).to(dev)
                       for k, v in forcing_np.items()}
        with prof.stage("series", block=True):
            outs, _ = run_series(cfg, forcing, isecday_utc=isd.tolist(),
                                 backend=args.backend)

    def first_col(x):
        if isinstance(x, torch.Tensor):
            x = x.reshape(nt, -1)[:, 0].cpu().numpy()
        return np.asarray(x).reshape(nt, -1)[:, 0]

    with prof.stage("write"):
        variables = {
            "Qlat": first_col(outs.QL), "Qsen": first_col(outs.QH),
            "Evap": first_col(outs.Evap), "T_s": first_col(outs.T_s),
        }
        if outs.Tau is not None:
            variables["Tau"] = first_col(outs.Tau)
            variables["rho_a"] = first_col(outs.rho_a)
        else:   # fused backend: reduced output set
            variables["Tau"] = np.hypot(first_col(outs.Tau_x),
                                        first_col(outs.Tau_y))
        if outs.diag is not None:
            variables.update({
                "Cd": first_col(outs.diag.Cd), "Ch": first_col(outs.diag.Ch),
                "Ce": first_col(outs.diag.Ce),
                "u_star": first_col(outs.diag.u_star),
                "dT_cs": first_col(outs.diag.dT_cs),
                "dT_wl": first_col(outs.diag.dT_wl),
                "Hz_wl": first_col(outs.diag.Hz_wl),
            })
        abio.write_series(args.out, time, variables)
        print(f"wrote {len(variables)} series of {nt} records to {args.out}")


def _series_ice(args):
    """Ice-algorithm time series (no cross-step state -> a plain loop over
    steps on the device; forcing must provide Ts_i as `sst` or `ts_i`, and
    optionally `frice`)."""
    dev = args.dev
    f = abio.read_forcing(args.file)
    key_ts = "ts_i" if "ts_i" in f else "sst"
    nt = len(f[key_ts])
    col = _columns(f, nt, args.file)

    Ts = col(key_ts)
    Ts = Ts + c.rt0 if Ts.mean() < 200.0 else Ts
    t_air = col("t_air", "t2m")
    t_air = t_air + c.rt0 if t_air.mean() < 200.0 else t_air
    hum = col("q_air", "q2m")
    slp = col("slp", "msl", default=101000.0)
    if "wndspd" in f:
        u, v = col("wndspd"), np.zeros((nt, 1))
    else:
        u, v = col("u_wnd", "u10"), col("v_wnd", "v10")
    frice = col("frice", "siconc", "at_i", default=1.0)

    rows = []
    for jt in range(nt):
        Ts_j, t_j, q_j, u_j, v_j, slp_j, A_j = (
            _tensor(x[jt], dev) for x in (Ts, t_air, hum, u, v, slp, frice))
        out, diag = flux_step_ice(args.algo, args.zt, args.zu, Ts_j, t_j,
                                  q_j, u_j, v_j, slp_j, frice=A_j,
                                  niter=args.niter)
        rows.append((out.QL, out.QH, out.Tau, out.Evap, diag.Cd, diag.Ch))
    series = [torch.stack([r[i][0] for r in rows]).cpu().numpy()
              for i in range(6)]
    time = np.asarray(f.get("time", np.arange(nt) * 3600.0), np.float64)
    abio.write_series(args.out, time, dict(
        Qlat=series[0], Qsen=series[1], Tau=series[2], Evap=series[3],
        Cd=series[4], Ch=series[5]))
    print(f"wrote ice series ({args.algo}) of {nt} records to {args.out}")


def _dump(path, result):
    with open(path, "w") as fh:
        json.dump(result, fh)


def _list(x):
    return x.cpu().tolist()


def cmd_cdnf(args):
    """Neutral form-drag coefficient variants vs ice concentration
    (test_aerobulk_cdnf_series.x analogue)."""
    from .ice import form_drag as fd

    A = _tensor(np.linspace(0.0, 1.0, args.n), args.dev)
    z0w = torch.full_like(A, 3.27e-4)
    z0i = torch.full_like(A, 4.54e-4)
    _dump(args.out, {
        "frice": _list(A),
        "CdN10_f_LU12": _list(fd.cdn10_f_lu12(A, z0w)),
        "CdN_f_LU12_eq36": _list(fd.cdn_f_lu12_eq36(args.zu, A)),
        "CdN10_f_LU13": _list(fd.cdn10_f_lu13(A)),
        "CdN_f_LG15": _list(fd.cdn_f_lg15(args.zu, A, z0i)),
        "CdN_f_LG15_light": _list(fd.cdn_f_lg15_light(args.zu, A, z0w)),
    })
    print(f"wrote form-drag curves to {args.out}")


def cmd_cx_vs_wind(args):
    """Cd/Ch/Ce (+z0, u*, L, UN10) vs wind for a range of air-sea
    stability states (test_cx_vs_wind.f90 sweep; nb_iter=20)."""
    dev = args.dev
    # non-uniform wind grid: dense at low winds (reference :98-107 spirit)
    w = np.concatenate([np.linspace(0.1, 5.0, 200, endpoint=False),
                        np.linspace(5.0, 20.0, 400, endpoint=False),
                        np.linspace(20.0, 50.0, 200)])
    dthetas = np.asarray([float(x) for x in args.dtheta.split(",")])

    result = {"wind": w.tolist(), "curves": {}}
    for algo in args.algos.split(","):
        cfg = AeroBulkConfig(algo=algo, zt=args.zt, zu=args.zu, niter=20)
        for dth in dthetas:
            sst = _full(273.15 + 15.0, w.shape, dev)
            t_zt = sst + dth
            slp = _full(101000.0, w.shape, dev)
            q_zt = args.rh / 100.0 * thermo.q_sat(t_zt, slp)
            out, _ = flux_step(cfg, sst, t_zt, q_zt, _tensor(w, dev),
                               torch.zeros_like(sst), slp)
            d = out.diag
            result["curves"][f"{algo}_dT{dth:+.1f}"] = {
                "Cd": _list(d.Cd), "Ch": _list(d.Ch), "Ce": _list(d.Ce),
                "z0": _list(d.z0), "u_star": _list(d.u_star),
                "UN10": _list(d.UN10),
            }
    _dump(args.out, result)
    print(f"wrote {len(result['curves'])} curve sets to {args.out}")


def cmd_coef_n10(args):
    """Neutral-coefficient curves CxN10(UN10) (test_coef_n10.f90;
    nb_iter=50)."""
    from .algos.neutral_10m import turb_neutral_10m

    un10 = np.linspace(0.5, 40.0, 396)
    result = {"UN10": un10.tolist(), "curves": {}}
    for algo in args.algos.split(","):
        cdn, chn, cen, z0 = turb_neutral_10m(algo, _tensor(un10, args.dev),
                                             niter=50)
        result["curves"][algo] = {"CdN10": _list(cdn), "ChN10": _list(chn),
                                  "CeN10": _list(cen), "z0": _list(z0)}
    _dump(args.out, result)
    print(f"wrote neutral-coefficient curves to {args.out}")


def cmd_psi_stab(args):
    """psi_m / psi_h profiles on zeta in [-15, 15] (test_psi_stab.f90)."""
    from . import stability as st

    zeta = np.linspace(-15.0, 15.0, 1001)
    z = _tensor(zeta, args.dev)
    fams = {
        "coare": (st.psi_m_coare, st.psi_h_coare),
        "ncar": (st.psi_m_ncar, st.psi_h_ncar),
        "ecmwf": (st.psi_m_ecmwf, st.psi_h_ecmwf),
        "andreas": (st.psi_m_andreas, st.psi_h_andreas),
        "grachev07": (st.psi_m_grachev07, st.psi_h_grachev07),
        "ice": (st.psi_m_ice, st.psi_h_ice),
    }
    result = {"zeta": zeta.tolist(), "curves": {}}
    for name, (pm, ph) in fams.items():
        result["curves"][name] = {"psi_m": _list(pm(z)),
                                  "psi_h": _list(ph(z))}
    _dump(args.out, result)
    print(f"wrote psi profiles to {args.out}")


def cmd_tune(args):
    """The launch-shape and numerics sweep (``launch_sweep``) of kernel 1
    (``--kernel flux``) or kernel 5 (``--kernel mixed``) on the card."""
    from . import launch_sweep

    launch_sweep.main(["--kernels",
                       "step" if args.kernel == "flux" else "mixed"])


def cmd_bench(args):
    """bench.py's modes on the card (:mod:`aerobulk_tpu_torch.bench`)."""
    bench.run(args, prog=f"{PROG} bench")


def main(argv=None, profiler=None):
    """Run one subcommand.  ``profiler`` (a :class:`profiling.Profiler`)
    receives the stage times of ``series``."""
    p = argparse.ArgumentParser(prog=PROG, description=__doc__)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where every subcommand computes (float64): the "
                        "CUDA device (default) or the CPU")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("toy", help="single-point all-algo comparison")
    t.add_argument("--zu", type=float, default=10.0)
    t.add_argument("--zt", type=float, default=2.0)
    t.add_argument("--sst", type=float, default=22.0, help="SST [C]")
    t.add_argument("--t", type=float, default=20.0, help="air temp [C]")
    t.add_argument("--q", type=float, default=12.0, help="spec hum [g/kg]")
    t.add_argument("--hum-rh", type=float, default=None,
                   help="give humidity as relative humidity [%%] instead "
                        "of --q (the reference toy's -r mode)")
    t.add_argument("--hum-dp", type=float, default=None,
                   help="give humidity as dew point [C] instead of --q "
                        "(the reference toy's -d mode)")
    t.add_argument("--wind", type=float, default=5.0, help="wind [m/s]")
    t.add_argument("--slp", type=float, default=1010.0, help="slp [hPa]")
    t.add_argument("--niter", type=int, default=20)
    t.add_argument("--neutral", action="store_true",
                   help="force neutral-stability air temp (the -N mode)")
    t.add_argument("--rh", type=float, default=80.0,
                   help="relative humidity for --neutral [%%]")
    t.set_defaults(fn=cmd_toy)

    it = sub.add_parser("ice-toy", help="single-point ice-algo comparison")
    it.add_argument("--zu", type=float, default=10.0)
    it.add_argument("--zt", type=float, default=2.0)
    it.add_argument("--ts", type=float, default=-10.0, help="ice temp [C]")
    it.add_argument("--t", type=float, default=-12.0, help="air temp [C]")
    it.add_argument("--rh", type=float, default=80.0, help="rel hum [%%]")
    it.add_argument("--wind", type=float, default=7.0)
    it.add_argument("--slp", type=float, default=1000.0)
    it.add_argument("--frice", type=float, default=0.8)
    it.add_argument("--niter", type=int, default=8)
    it.set_defaults(fn=cmd_ice_toy)

    oi = sub.add_parser("oce-ice-toy",
                        help="single-point mixed ocean+ice cell "
                             "(test_aerobulk_oce+ice.x analogue)")
    oi.add_argument("--zu", type=float, default=10.0)
    oi.add_argument("--zt", type=float, default=2.0)
    oi.add_argument("--ts", type=float, default=-5.0, help="ice temp [C]")
    oi.add_argument("--sst", type=float, default=-1.0, help="lead SST [C]")
    oi.add_argument("--t", type=float, default=-4.0, help="air temp [C]")
    oi.add_argument("--rh", type=float, default=85.0, help="rel hum [%%]")
    oi.add_argument("--wind", type=float, default=7.0)
    oi.add_argument("--slp", type=float, default=1000.0)
    oi.add_argument("--frice", type=float, default=0.7)
    oi.add_argument("--niter", type=int, default=8)
    oi.set_defaults(fn=cmd_oce_ice_toy)

    s = sub.add_parser("series", help="time-series run over a forcing file")
    s.add_argument("file", help="forcing file (.nc NetCDF3/4 or .npz)")
    s.add_argument("--algo", default="coare3p6")
    s.add_argument("--zt", type=float, default=2.0)
    s.add_argument("--zu", type=float, default=10.0)
    s.add_argument("--niter", type=int, default=20)
    s.add_argument("--skin", action="store_true")
    s.add_argument("--backend", default="eager", choices=("eager", "fused"),
                   help="per-step implementation: the eager PyTorch step "
                        "(default) or CUDA kernel 1, one launch a record "
                        "(needs --skin and the CUDA device)")
    s.add_argument("--chunk", type=int, default=0, metavar="K",
                   help="stream the series host->device K records at a "
                        "time (overlapped chunked pipeline) instead of "
                        "keeping it device-resident")
    s.add_argument("--out", default="aerobulk_series.nc")
    s.set_defaults(fn=cmd_series)

    cf = sub.add_parser("cdnf", help="ice form-drag curves vs concentration")
    cf.add_argument("--zu", type=float, default=10.0)
    cf.add_argument("--n", type=int, default=101)
    cf.add_argument("--out", default="cdnf_curves.json")
    cf.set_defaults(fn=cmd_cdnf)

    cx = sub.add_parser("cx-vs-wind", help="transfer-coef vs wind sweeps")
    cx.add_argument("--algos", default="coare3p0,coare3p6,ncar,ecmwf,andreas")
    cx.add_argument("--dtheta", default="-5,-2,0,2,5",
                    help="air-sea potential temp differences [K]")
    cx.add_argument("--rh", type=float, default=80.0)
    cx.add_argument("--zt", type=float, default=10.0)
    cx.add_argument("--zu", type=float, default=10.0)
    cx.add_argument("--out", default="cx_vs_wind.json")
    cx.set_defaults(fn=cmd_cx_vs_wind)

    cn = sub.add_parser("coef-n10", help="neutral coefficient curves")
    cn.add_argument("--algos", default="coare3p0,coare3p6,ncar,ecmwf,andreas")
    cn.add_argument("--out", default="coef_n10.json")
    cn.set_defaults(fn=cmd_coef_n10)

    ps = sub.add_parser("psi-stab", help="stability-function profiles")
    ps.add_argument("--out", default="psi_stab.json")
    ps.set_defaults(fn=cmd_psi_stab)

    tu = sub.add_parser("tune", help="launch-shape sweep of a forward "
                                     "kernel on the card (launch_sweep)")
    tu.add_argument("--kernel", default="flux", choices=("flux", "mixed"),
                    help="which kernel to sweep: the skin flux step "
                         "(kernel 1) or the mixed ocean+ice step (kernel 5)")
    tu.set_defaults(fn=cmd_tune)

    be = sub.add_parser("bench", help="bench.py's modes on the card through "
                                      "the CUDA kernels, timed with CUDA "
                                      "events, parity in every line")
    bench.add_arguments(be)
    be.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    if args.cmd == "bench":
        if args.device == "cpu":
            p.exit(2, f"{PROG} bench: the bench measures the card (an NVIDIA "
                      "GPU) and has no CPU route; drop --device cpu\n")
        return args.fn(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        p.exit(2, f"{PROG}: no CUDA device is available; every subcommand "
                  "computes on the card unless given --device cpu "
                  f"(e.g. {PROG} --device cpu {args.cmd} ...)\n")
    args.dev = (torch.device("cuda", torch.cuda.current_device())
                if args.device == "cuda" else torch.device("cpu"))
    args.profiler = Profiler() if profiler is None else profiler
    args.fn(args)


if __name__ == "__main__":
    main()
