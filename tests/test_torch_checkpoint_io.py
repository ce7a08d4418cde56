"""Checkpoints (``skin.save_skin_state``/``load_skin_state``), the ``io``
module and the streamed demo (``run_global_grid``) of aerobulk_tpu_torch,
against aerobulk_tpu on the CPU.

Checkpoint files and io files move between the two packages bitwise; a
resumed series equals the uninterrupted one bitwise (the same operations on
the same values: the reference's tests/test_checkpoint.py holds its own at
rtol 1e-12).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from aerobulk_tpu import io as jio
from aerobulk_tpu import skin as jskin
from aerobulk_tpu_torch import api as tapi
from aerobulk_tpu_torch import io as tio
from aerobulk_tpu_torch import pipeline as tpipe
from aerobulk_tpu_torch import run_global_grid
from aerobulk_tpu_torch import skin as tskin

CFG = tapi.AeroBulkConfig(algo="coare3p6", niter=5, use_skin=True)


def _state(rng, shape=(3, 5)):
    return tskin.SkinState(
        dT_wl=torch.as_tensor(1.5 * rng.random(shape)),
        Hz_wl=torch.as_tensor(0.5 + 19.0 * rng.random(shape)),
        Qnt_ac=torch.as_tensor(rng.normal(3e5, 3e5, shape)),
        Tau_ac=torch.as_tensor(800.0 * rng.random(shape)))


def _forcing(nt=10, npts=3, seed=1):
    """tests/test_checkpoint.py's forcing."""
    rng = np.random.default_rng(seed)
    return dict(
        sst=299.0 + rng.random((nt, npts)),
        t_zt=298.0 + rng.random((nt, npts)),
        hum_zt=np.full((nt, npts), 0.015),
        U_zu=2.0 + 5.0 * rng.random((nt, npts)),
        V_zu=np.zeros((nt, npts)),
        slp=np.full((nt, npts), 101000.0),
        rad_sw=700.0 * rng.random((nt, npts)),
        rad_lw=np.full((nt, npts), 420.0))


def _equal(a, b):
    for name, x, y in zip(tskin.SkinState._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=name)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_checkpoint_files_move_between_packages_bitwise(tmp_path, dtype):
    state = _state(np.random.default_rng(4))
    state = tskin.SkinState(*(x.to(torch.from_numpy(np.empty(0, dtype))
                                   .dtype) for x in state))
    port_file = str(tmp_path / "port.npz")
    tskin.save_skin_state(port_file, state)
    in_jax = jskin.load_skin_state(port_file)
    assert all(np.asarray(x).dtype == dtype for x in in_jax)
    _equal(in_jax, state)

    jax_file = str(tmp_path / "jax.npz")
    jskin.save_skin_state(jax_file, in_jax)
    back = tskin.load_skin_state(jax_file, device="cpu")
    assert all(x.device.type == "cpu" for x in back)
    _equal(back, state)
    with np.load(jax_file) as a, np.load(port_file) as b:
        assert sorted(a.files) == sorted(b.files) == sorted(
            tskin.SkinState._fields)


def test_load_skin_state_casts_and_needs_a_device(tmp_path, monkeypatch):
    path = str(tmp_path / "s.npz")
    tskin.save_skin_state(path, _state(np.random.default_rng(2)))
    st32 = tskin.load_skin_state(path, dtype=torch.float32, device="cpu")
    assert all(x.dtype == torch.float32 for x in st32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tskin.load_skin_state(path)


def test_series_checkpoint_resume(tmp_path):
    """The port of tests/test_checkpoint.py::test_series_checkpoint_resume:
    run half, checkpoint, restore, run the rest; equals one run."""
    f = {k: torch.as_tensor(v) for k, v in _forcing().items()}
    isd = np.arange(8, 18) * 3600
    full, state_full = tapi.run_series(
        CFG, f, isecday_utc=isd,
        skin_state=tapi.init_skin_state(CFG, (3,), device="cpu"))
    _, state_mid = tapi.run_series(
        CFG, {k: v[:5] for k, v in f.items()}, isecday_utc=isd[:5],
        skin_state=tapi.init_skin_state(CFG, (3,), device="cpu"))
    ckpt = str(tmp_path / "skin_state.npz")
    tskin.save_skin_state(ckpt, state_mid)
    restored = tskin.load_skin_state(ckpt, device="cpu")
    outs2, state_end = tapi.run_series(
        CFG, {k: v[5:] for k, v in f.items()}, skin_state=restored,
        isecday_utc=isd[5:])
    assert float(state_mid.dT_wl.max()) > 0.0
    np.testing.assert_array_equal(outs2.QL.numpy(), full.QL[5:].numpy())
    _equal(state_end, state_full)


def test_streamed_checkpoint_resume_matches_jax_checkpoint(tmp_path):
    """A streamed run of the port whose mid-way state is checkpointed by
    the reference's ``save_skin_state`` resumes exactly as one stream."""
    f = _forcing(nt=7, npts=4, seed=6)

    def records(lo, hi):
        for jt in range(lo, hi):
            rec = {k: v[jt] for k, v in f.items()}
            rec["isecday_utc"] = np.int32((9 + jt) * 3600)
            yield rec

    kw = dict(chunk=2, device="cpu")
    out_full, st_full = tpipe.run_series_pipelined(CFG, records(0, 7), **kw)
    _, st_mid = tpipe.run_series_pipelined(CFG, records(0, 3), **kw)
    path = str(tmp_path / "mid.npz")
    jskin.save_skin_state(path, jskin.SkinState(
        *(jnp.asarray(x.numpy()) for x in st_mid)))
    restored = tskin.load_skin_state(path, device="cpu")
    out_b, st_b = tpipe.run_series_pipelined(CFG, records(3, 7),
                                             skin_state=restored, **kw)
    _equal(st_b, st_full)
    np.testing.assert_array_equal(
        np.concatenate([r["QL"] for r in out_b]),
        np.concatenate([r["QL"] for r in out_full])[3:])


def _series_vars(rng, nt=4):
    return {"QL": rng.normal(-100.0, 30.0, (nt, 3, 5)),
            "QH": rng.normal(-10.0, 5.0, (nt, 3, 5)),
            "buoy": rng.random(nt), "stations": rng.random((nt, 7))}


@pytest.mark.parametrize("suffix", [".nc", ".npz"])
def test_io_round_trip_and_cross_package(tmp_path, suffix):
    rng = np.random.default_rng(8)
    tm = np.arange(4) * 3600.0
    variables = _series_vars(rng)
    for writer, name in ((tio.write_series, "port"),
                         (jio.write_series, "jax")):
        path = str(tmp_path / f"{name}{suffix}")
        writer(path, tm, variables, units={"QL": "W/m^2"})
        got, ref = tio.read_forcing(path), jio.read_forcing(path)
        assert sorted(got) == sorted(ref) == sorted(["time", *variables])
        for k, v in ref.items():
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        for k, v in variables.items():
            np.testing.assert_array_equal(got[k], v)
        np.testing.assert_array_equal(got["time"], tm)


def test_io_calendar_helpers_equal_reference():
    units = "hours since 2000-01-01 00:00:00"
    vals = np.array([0.0, 25.5, 8760.0])
    np.testing.assert_array_equal(tio.to_epoch(vals, units),
                                  jio.to_epoch(vals, units))
    np.testing.assert_array_equal(tio.time_to_date(vals, units),
                                  jio.time_to_date(vals, units))
    ep = tio.to_epoch(vals, units)
    np.testing.assert_array_equal(tio.seconds_of_day(ep),
                                  jio.seconds_of_day(ep))
    assert tio.VAR_NAMES_ECMWF == jio.VAR_NAMES_ECMWF


def test_run_global_grid_demo_on_cpu(tmp_path, capsys):
    out = str(tmp_path / "diagnostics" / "day.nc")    # a new directory
    pts = run_global_grid.main(["--ny", "4", "--nx", "8", "--nt", "4",
                                "--chunk", "2", "--device", "cpu",
                                "--out", out])
    assert pts > 0
    printed = capsys.readouterr().out
    assert "device: cpu" in printed and "points/s" in printed
    got = tio.read_forcing(out)
    assert got["QL"].shape == (2, 4, 8) and np.isfinite(got["QL"]).all()
    assert got["dT_wl"].shape == (2, 4, 8)


def test_run_global_grid_needs_a_device_without_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_global_grid.main(["--ny", "4", "--nx", "8", "--nt", "2",
                              "--out", str(tmp_path / "x.nc")])
