"""The port's host tools on the CPU: ``prepare_forcing`` against
aerobulk_tpu.prepare_forcing (outputs and the written download script
identical), ``plotting`` (each figure written from the port CLI's
artifacts), ``profiling`` (the report, a trace file, the slope timer) and
``example_call_aerobulk`` (the doc/ex_ab.dat goldens at the rtol 1e-5 of
tests/test_golden_ocean.py).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

from aerobulk_tpu import prepare_forcing as jpf
from aerobulk_tpu_torch import cli as tcli
from aerobulk_tpu_torch import example_call_aerobulk, plotting, profiling
from aerobulk_tpu_torch import prepare_forcing as tpf
from test_golden_ocean import EX_AB


def _equal(got, ref):
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k in ref:
            _equal(got[k], ref[k])
    elif isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _equal(g, r)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(got, ref)
    else:
        assert got == ref


def test_prepare_forcing_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    d2 = 260.0 + 40.0 * rng.random(50)
    slp = 97000.0 + 6000.0 * rng.random(50)
    mask = rng.random(50)
    _equal(tpf.q2_from_d2_slp(d2, slp), jpf.q2_from_d2_slp(d2, slp))
    _equal(tpf.q2_from_d2_slp(d2, slp, mask),
           jpf.q2_from_d2_slp(d2, slp, mask))
    _equal(tpf.era5_accum_to_flux(d2, 10800.0),
           jpf.era5_accum_to_flux(d2, 10800.0))
    for name, x in (("sst", d2 - 273.15), ("sst", d2), ("slp", slp / 100.0),
                    ("slp", slp), ("t_air", np.r_[d2[:5] - 273.15, -9999.0]),
                    ("q_air", mask)):
        _equal(tpf.normalize_units(name, x), jpf.normalize_units(name, x))
    for kw in ({}, dict(lat_min=-50.0, lat_max=35.0, lon_min=140.0,
                        lon_max=-69.0),
               dict(freq="3h", variables=["t2m", "ssrd"])):
        _equal(tpf.build_era5_cds_requests(2020, **kw),
               jpf.build_era5_cds_requests(2020, **kw))
    with pytest.raises(ValueError):
        tpf.build_era5_cds_requests(2020, variables=["nope"])

    # the download scripts differ only in the module named as their source
    got = tpf.write_era5_download_script(str(tmp_path / "t.py"), 2021,
                                         variables=["t2m", "ssrd"])
    ref = jpf.write_era5_download_script(str(tmp_path / "j.py"), 2021,
                                         variables=["t2m", "ssrd"])
    text = open(got).read()
    ast.parse(text)
    assert text.replace("aerobulk_tpu_torch.", "aerobulk_tpu.") == \
        open(ref).read()

    raw = str(tmp_path / "raw.npz")
    np.savez(raw, sst=d2[:24] - 273.15, d2m=d2[:24] - 5.0,
             msl=slp[:24] / 100.0, ssrd=3600.0 * 300.0 * mask[:24],
             strd=3600.0 * 350.0 * np.ones(24), time=np.arange(24) * 3600.)
    from aerobulk_tpu_torch.io import VAR_NAMES_ECMWF
    _equal(tpf.prepare_forcing_dict(raw, names=VAR_NAMES_ECMWF,
                                    accum_radiation=3600.0),
           jpf.prepare_forcing_dict(raw, names=VAR_NAMES_ECMWF,
                                    accum_radiation=3600.0))


def test_plots_from_the_port_cli(tmp_path):
    """Each of the six figures, from the artifacts the port's CLI writes."""
    def run(*argv):
        tcli.main(["--device", "cpu", *argv])

    art = {k: str(tmp_path / f"{k}.json") for k in ("cx", "cn", "psi",
                                                     "cdnf")}
    run("cx-vs-wind", "--algos", "ncar", "--dtheta=-2,2", "--out", art["cx"])
    run("coef-n10", "--algos", "ncar,andreas", "--out", art["cn"])
    run("psi-stab", "--out", art["psi"])
    run("cdnf", "--n", "21", "--out", art["cdnf"])

    nt = 8
    h = np.arange(nt)
    ocean = str(tmp_path / "ocean.npz")
    np.savez(ocean, sst=np.full(nt, 295.0), t_air=np.full(nt, 294.0),
             q_air=np.full(nt, 0.013), wndspd=4.0 + 0.3 * h,
             msl=np.full(nt, 101000.0), ssrd=np.full(nt, 400.0),
             strd=np.full(nt, 400.0), time=h * 3600.0)
    station = str(tmp_path / "station.nc")
    run("series", ocean, "--skin", "--niter", "4", "--out", station)
    ice = str(tmp_path / "ice.npz")
    np.savez(ice, sst=np.full(nt, 258.0), t_air=np.full(nt, 255.0),
             q_air=np.full(nt, 0.0008), wndspd=np.linspace(3, 10, nt),
             msl=np.full(nt, 100000.0), frice=np.full(nt, 0.85),
             time=h * 3600.0)
    ice_series = {}
    for algo in ("ice_nemo", "ice_lg15"):
        ice_series[algo] = str(tmp_path / f"{algo}.nc")
        run("series", ice, "--algo", algo, "--niter", "4", "--out",
            ice_series[algo])

    pngs = [
        plotting.plot_cx_wind(art["cx"], str(tmp_path / "cx.png")),
        plotting.plot_coef_n10(art["cn"], str(tmp_path / "cn.png")),
        plotting.plot_psi_profiles(art["psi"], str(tmp_path / "psi.png")),
        plotting.plot_ice_cdn(art["cdnf"], str(tmp_path / "cdnf.png")),
        plotting.plot_station_series(station, str(tmp_path / "st.png")),
        plotting.plot_ice_bulk_comp(ice_series, str(tmp_path / "ice.png")),
    ]
    for png in pngs:
        with open(png, "rb") as fh:
            assert fh.read(8) == b"\x89PNG\r\n\x1a\n", png
        assert os.path.getsize(png) > 10000, png


def test_profiler_stages_trace_and_slope(tmp_path):
    prof = profiling.Profiler(trace_dir=str(tmp_path / "traces"))
    x = torch.linspace(0.0, 1.0, 4096, dtype=torch.float64)
    for _ in range(3):
        with prof.stage("compute", block=True):
            y = torch.exp(x).sum()
    with prof.stage("write"):
        pass
    report = prof.report().splitlines()
    assert report[0].split() == ["stage", "calls", "total[s]", "mean[ms]"]
    rows = {ln.split()[0]: ln.split() for ln in report[1:]}
    assert rows["compute"][1] == "3" and rows["write"][1] == "1"

    with prof.device_trace():
        y = torch.exp(x).sum()
    assert len(prof.traces) == 1
    with open(prof.traces[0]) as fh:
        trace = json.load(fh)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("exp" in n for n in names), sorted(names)[:20]
    assert float(y) > 0

    def chained(m):
        z = x
        for _ in range(m):
            z = torch.sin(z) + x
        return z[:1]
    assert profiling.slope_time(chained, repeats=2) > 0.0

    prof.reset()
    assert prof.report().count("\n") == 0


def test_profiler_without_trace_dir_traces_nothing():
    prof = profiling.Profiler()
    with prof.device_trace():
        torch.ones(3).sum()
    assert prof.traces == []


def test_example_call_aerobulk_goldens(capsys):
    outs = example_call_aerobulk.main(device="cpu")
    printed = capsys.readouterr().out
    for algo, exp in EX_AB.items():
        out = outs[algo]
        assert f"*********** {algo.upper()} ***" in printed
        np.testing.assert_allclose(out.QH.numpy(), exp["QH"], rtol=1e-5)
        np.testing.assert_allclose(out.QL.numpy(), exp["QL"], rtol=1e-5)
        np.testing.assert_allclose(out.Evap.numpy() * 86400.0, exp["E"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out.Tau_x.numpy(), exp["Tx"], rtol=1e-5)
        if exp["skin"]:
            np.testing.assert_allclose(out.T_s.numpy() - 273.15, exp["Ts"],
                                       atol=2e-5)
    # the COARE 3.0 unstable point, as the C++ example prints it
    assert "-15.15530" in printed and "-81.38902" in printed

