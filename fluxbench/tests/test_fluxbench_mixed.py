"""The mixed ocean + sea-ice deployment's files on the CPU: the plain
reference (``reference/mixed.py``) against the program's eager mixed step
in float64; kernel 5's census against the program's; the two kernel 5
wrapper readers on hand-built traces; the mixed cell's check, where a
sound run is correct and the control and each planted fault are not; and
both cells this deployment's change added, found by name."""

import json

import numpy as np
import pytest
import torch

import aerobulk_tpu_torch.kernels.fused as kfused
from aerobulk_tpu_torch import api, roofline
from fluxbench import forcing
from fluxbench import trace as tr
from fluxbench.reference import mixed
from fluxbench.run import HERE, ROOT, Cell, load_module, measure, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
MIXED_CELL = "mixed_lg15_ecmwf_era5_0p25.mixed_day"
NEW_CELLS = (MIXED_CELL, "ecmwf_skin_era5_0p25.grad_6h")
SHAPE = (24, 40)
SEED = 2 ** 31 + 321


def _mix_and_cfg():
    return (read_json(HERE / "traffic" / "mixed_day.json"),
            read_json(HERE / "configs" / "mixed_lg15_ecmwf_era5_0p25.json"))


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (5, 2 ** 31 + 77))
def test_reference_matches_the_programs_eager_step(seed):
    """Every net output of every record of the mix's forcing at 24 x 40,
    float64, rtol 1e-12 (atol 1e-12 * max|ref| for the fluxes, which
    change sign)."""
    mix, cfg = _mix_and_cfg()
    fields, _, _ = forcing.series(mix, seed, SHAPE)
    f = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in
         fields.items()}
    got = mixed.flux_step(cfg, *(f[k] for k in mixed.FORCING))
    net, _, _ = api.flux_step_mixed(
        cfg["zt"], cfg["zu"], *(f[k] for k in mixed.FORCING),
        ice_algo=cfg["ice_algo"], ocean_algo=cfg["algo"],
        niter=cfg["niter"], humidity=cfg["humidity"])
    for name, g in zip(mixed.OUTPUTS, got, strict=True):
        want = getattr(net, name)
        assert g.shape == (mix["records"], *SHAPE)
        torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12 * float(
            want.abs().max()), msg=name)


def test_reference_runs_in_bfloat16_and_refuses_other_pairs():
    mix, cfg = _mix_and_cfg()
    fields, _, _ = forcing.series(mix, 3, (3, 4))
    f = [torch.as_tensor(fields[k]).bfloat16() for k in mixed.FORCING]
    outs = mixed.flux_step(cfg, *f)
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x.float()).all()
               for x in outs)
    with pytest.raises(ValueError, match="no mixed step"):
        mixed.flux_step(dict(cfg, ice_algo="ice_nemo"), *f)


def test_the_mix_passes_ice_fields_through_its_records():
    """Ts_i and frice are each record's base draw; the SST ramps; the mix
    draws frice over [0, 1) and the ice below the melting point."""
    mix, _ = _mix_and_cfg()
    fields, lon, _ = forcing.series(mix, 11, (5, 6))
    base = forcing.base_fields(mix, 11, (5, 6))
    for k in range(mix["records"]):
        assert np.array_equal(fields["Ts_i"][k], base["Ts_i"])
        assert np.array_equal(fields["frice"][k], base["frice"])
    assert float(fields["sst"][-1].mean() - fields["sst"][0].mean()) > 0.2
    assert 0.0 <= fields["frice"].min() and fields["frice"].max() < 1.0
    assert fields["Ts_i"].max() < 273.15 + 1e-3 and lon.shape == (5, 6)


# ---------------------------------------------------------------------------
# kernel 5's census
# ---------------------------------------------------------------------------

def test_kernel5_census_is_the_programs():
    c = json.loads((HERE / "census" / "kernel5.ecmwf.niter5.json")
                   .read_text())
    want = roofline.CENSUS["mixed_ice_lg15_ecmwf"]
    assert (c["kernel"], c["algo"], c["niter"], c["dtype"]) == (
        "kernel5", "ecmwf", 5, "float32")
    assert c["ops_by_class"] == dict(want)
    assert c["ops_per_point"] == sum(want.values()) == 4059


def test_kernel5_census_bytes_are_its_arguments():
    """8 float32 fields in, the 5 net outputs out, and the kernel's name as
    its source defines it."""
    c = json.loads((HERE / "census" / "kernel5.ecmwf.niter5.json")
                   .read_text())
    x = [torch.full((2,), v, dtype=torch.float64) for v in
         (260.0, 272.0, 265.0, 0.001, 5.0, 1.0, 100000.0, 0.5)]
    n_out = len(kfused.fused_mixed_step(2.0, 10.0, *x))
    assert (c["fields_in"], c["fields_out"]) == (
        len(kfused._MIXED_INPUTS), n_out) == (8, 5)
    assert c["bytes_per_point"] == 4 * (8 + 5)
    src = (ROOT / "aerobulk_tpu_torch" / "kernels" / "csrc" /
           "mixed_step.cuh").read_text()
    assert f"{c['trace_name']}(" in src


# ---------------------------------------------------------------------------
# the kernel 5 wrapper readers
# ---------------------------------------------------------------------------

READERS = ("kernel5.wrapper_idle_share", "kernel5.wrapper_host_us")


def _trace(device, host, t0=0, t1=1000):
    t = tr.Trace.__new__(tr.Trace)
    t.t0, t.t1 = t0, t1
    t.window_s = (t1 - t0) * 1e-9
    t.dev_start, t.dev_end, t.dev_name = t._clip(
        [(s, e, "void mixed_step_kernel<float, 2, 4>") for s, e in device])
    t.host = [(t0, t1, tr.WINDOW_SPAN), *host]
    return t


class _Run:
    def __init__(self, trace):
        self.trace = trace


def _read(trace):
    return {m: load_module(HERE / "metrics" / f"{m}.py").read(_Run(trace))
            for m in READERS}


BUSY = [(0, 400), (600, 1000)]
CASES = {
    # the gap under kernel 5's wrapper; the record's part is not its
    "in_record": (BUSY, [
        (350, 700, "aerobulk.run_series.record"),
        (450, 650, "aerobulk.kernel5.wrapper"),
        (500, 640, "aerobulk.kernel5.launch")], 15.0, 0.2),
    # another kernel's wrapper counts for nothing
    "other_kernel": (BUSY, [
        (450, 650, "aerobulk.kernel1.wrapper")], None, None),
    # two wrappers, one crossing the window's end: clipped for the idle
    # share, left out of the mean
    "edges": (BUSY, [
        (380, 420, "aerobulk.kernel5.wrapper"),
        (550, 1200, "aerobulk.kernel5.wrapper")], 7.0, 0.04),
    # in busy time only
    "busy": (BUSY, [(100, 300, "aerobulk.kernel5.wrapper")], 0.0, 0.2),
}


@pytest.mark.parametrize("case", CASES)
def test_wrapper_readers_on_a_known_trace(case):
    device, host, share, host_us = CASES[case]
    got = _read(_trace(device, host))
    if share is None:
        assert got == dict.fromkeys(READERS)
        return
    assert got["kernel5.wrapper_idle_share"] == pytest.approx(share,
                                                             rel=1e-12)
    assert got["kernel5.wrapper_host_us"] == pytest.approx(host_us,
                                                          rel=1e-12)


def test_wrapper_readers_without_a_trace_read_none():
    assert _read(None) == dict.fromkeys(READERS)


# ---------------------------------------------------------------------------
# the mixed cell's check
# ---------------------------------------------------------------------------

def _run():
    result, lines = measure(Cell(BENCH, MIXED_CELL), SEED, 0.05, False,
                            torch.device("cpu"), shape=SHAPE,
                            log=lambda line: None)
    return result, "\n".join(lines)


def test_a_sound_mixed_run_is_correct():
    result, lines = _run()
    assert result["correct"], lines
    assert set(result["check"]) == {"sig_frac", "med_err"}
    assert result["failed"] == 0 and result["attempted"] >= 1


def _control(zt, zu, *fields, ice_algo="ice_lg15", ocean_algo="ecmwf",
             niter=5, humidity="sh", simultaneous=False):
    """The plain reference in bfloat16 in the kernel's place."""
    cfg = dict(zt=zt, zu=zu, niter=niter, algo=ocean_algo, ice_algo=ice_algo)
    outs = mixed.flux_step(cfg, *(x.bfloat16() for x in fields))
    return tuple(o.to(fields[0].dtype) for o in outs)


def _half_left_out(step):
    def broken(*args, **kw):
        def half(x):
            flat = x.reshape(-1)
            n = flat.numel() // 2
            rest = flat[:n].mean().expand(flat.numel() - n)
            return torch.cat([flat[:n], rest]).reshape(x.shape)
        return tuple(map(half, step(*args, **kw)))
    return broken


def _answer_altered(step):
    count = [0]

    def broken(*args, **kw):
        ql, *rest = step(*args, **kw)
        count[0] += 1
        if count[0] % 24 == 4:       # one record's latent heat
            ql = ql * 1.1
        return (ql, *rest)
    return broken


def _ice_dropped(step):
    def broken(zt, zu, *fields, simultaneous=False, **kw):
        _, _, ocean = api.flux_step_mixed(zt, zu, *fields, **kw)
        return ocean.QL, ocean.QH, ocean.Tau, ocean.Evap, ocean.T_s
    return broken


FAULTS = {"control": lambda step: _control,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "ice_dropped": _ice_dropped}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_mixed_step_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(kfused, "fused_mixed_step",
                        FAULTS[fault](kfused.fused_mixed_step))
    result, lines = _run()
    assert not result["correct"], lines
    assert any(c["value"] > c["limit"] for c in result["check"].values())


# ---------------------------------------------------------------------------
# the two cells, by name
# ---------------------------------------------------------------------------

#: the per-layer metrics each new cell reports
PER_LAYER = {
    MIXED_CELL: {"device.idle_share", "call_mfu", "kernel5_roofline",
                 "kernel5.wrapper_idle_share", "kernel5.wrapper_host_us"},
    "ecmwf_skin_era5_0p25.grad_6h": {
        "device.idle_share", "call_mfu", "kernel1_roofline",
        "kernel2_roofline", "grad.other_device_ms_per_record",
        "wrappers.idle_share", "loop.idle_share",
        "wrappers.host_us_per_launch"},
}


@pytest.mark.parametrize("workload", NEW_CELLS)
def test_the_new_cells_find_their_files_by_name(workload):
    cell = Cell(BENCH, workload)
    assert cell.chips == 1 and callable(cell.entry.Call)
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == PER_LAYER[workload]
    for traced in (False, True):
        for spec, reader in cell.readers(traced):
            assert callable(reader.read), spec["name"]
    limits = cell.limits()
    assert limits and all(v["limit"] is not None and
                          v["lower"] < v["limit"] < v["upper"]
                          for v in limits.values())
    for kernel in cell.entry.Call.kernels:
        algo, niter = cell.cfg["algo"], cell.cfg["niter"]
        assert (HERE / "census" / f"{kernel}.{algo}.niter{niter}.json") \
            .exists()


def test_the_mixed_config_is_the_programs():
    """The config builds the program's mixed config; a program without
    ``ice_algo`` fails in the entry's first statement."""
    _, cfg = _mix_and_cfg()
    entry = load_module(HERE / "entries" / "mixed_series.py")
    call = entry.Call(cfg, _mix_and_cfg()[0], 1, (2, 3), torch.device("cpu"))
    assert call.program_cfg == api.AeroBulkConfig(
        algo="ecmwf", ice_algo="ice_lg15", zt=2.0, zu=10.0, niter=5,
        use_skin=False, humidity="sh", rdt=3600.0, gdept=1.0)
    assert cfg["reduced"] == [] and cfg["grid"] == [721, 1440]
