"""The batched flux-product deployment's files on the CPU: the plain
reference (``reference/bulk.py``) against the program's eager batch in
float64; kernel 3's census against the program's; the three kernel 3
readers on hand-built traces; the cell found by name; and its check, where
a sound run is correct and the control and each planted fault are not."""

import json

import numpy as np
import pytest
import torch

import aerobulk_tpu_torch.kernels.fused as kfused
from aerobulk_tpu_torch import api, roofline
from fluxbench import forcing
from fluxbench import trace as tr
from fluxbench.entry import program_config
from fluxbench.reference import bulk
from fluxbench.run import HERE, ROOT, Cell, load_module, measure, read_json

BENCH = read_json(ROOT / "BENCHMARK.json")
CELL = "coare3p0_1deg_month.batched"
SHAPE = (8, 12)
SEED = 2 ** 31 + 326
CENSUS = HERE / "census" / "kernel3.coare3p0.niter5.json"


def _mix_and_cfg():
    return (read_json(HERE / "traffic" / "batched.json"),
            read_json(HERE / "configs" / "coare3p0_1deg_month.json"))


# ---------------------------------------------------------------------------
# the plain reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", (5, 2 ** 31 + 77))
def test_reference_matches_the_programs_eager_batch(seed):
    """Every output of every record of the mix's forcing at 8 x 12,
    float64, rtol 1e-12 (atol 1e-12 * max|ref| for the fluxes, which
    change sign)."""
    mix, cfg = _mix_and_cfg()
    fields, _, _ = forcing.series(mix, seed, SHAPE)
    f = {k: torch.as_tensor(fields[k], dtype=torch.float64)
         for k in bulk.FORCING}
    got = bulk.flux_step(cfg, *(f[k] for k in bulk.FORCING))
    out, _ = api.run_series(program_config(cfg), f, batch_records=True)
    for name, g in zip(bulk.OUTPUTS, got, strict=True):
        want = getattr(out, name)
        assert g.shape == (mix["records"], *SHAPE)
        torch.testing.assert_close(g, want, rtol=1e-12, atol=1e-12 * float(
            want.abs().max()), msg=name)


def test_reference_runs_in_bfloat16():
    mix, cfg = _mix_and_cfg()
    fields, _, _ = forcing.series(mix, 3, (3, 4))
    outs = bulk.flux_step(cfg, *(torch.as_tensor(fields[k]).bfloat16()
                                 for k in bulk.FORCING))
    assert all(x.dtype == torch.bfloat16 and torch.isfinite(x.float()).all()
               for x in outs)


def test_the_mix_is_a_month_of_the_resident_days_draws():
    """The same base fields as resident_day, so no third field set is
    drawn; the SST drifts 0.72 K over the month and the air wobbles
    0.3 K over a day."""
    mix, _ = _mix_and_cfg()
    day = read_json(HERE / "traffic" / "resident_day.json")
    assert mix["fields"] == day["fields"] and mix["records"] == 720
    fields, _, isd = forcing.series(mix, 11, (5, 6))
    base = forcing.base_fields(mix, 11, (5, 6))
    drift = fields["sst"][-1] - fields["sst"][0]
    assert np.allclose(drift, 0.719, atol=1e-3)
    assert np.array_equal(fields["sst"][0], base["sst"])
    wobble = fields["t_zt"][:24] - base["t_zt"]
    assert 0.29 < float(wobble.max()) <= 0.3 + 1e-4
    assert isd[:3] == [0, 3600, 7200] and isd[24] == 0


# ---------------------------------------------------------------------------
# kernel 3's census
# ---------------------------------------------------------------------------

def test_kernel3_census_is_the_programs():
    c = json.loads(CENSUS.read_text())
    want = roofline.CENSUS["coare3p0"]
    assert (c["kernel"], c["algo"], c["niter"], c["dtype"]) == (
        "kernel3", "coare3p0", 5, "float32")
    assert c["ops_by_class"] == dict(want)
    assert c["ops_per_point"] == sum(want.values()) == 2152


def test_kernel3_census_bytes_are_its_arguments():
    """6 float32 fields in, 6 out, and the kernel's name as its source
    defines it."""
    c = json.loads(CENSUS.read_text())
    x = [torch.full((2,), v, dtype=torch.float64) for v in
         (290.0, 288.0, 0.01, 5.0, 1.0, 100000.0)]
    n_out = len(kfused.fused_bulk_step(api.AeroBulkConfig(algo="coare3p0"),
                                       *x))
    assert (c["fields_in"], c["fields_out"]) == (
        len(kfused._BULK_INPUTS), n_out) == (6, 6)
    assert c["bytes_per_point"] == 4 * (6 + 6)
    src = (ROOT / "aerobulk_tpu_torch" / "kernels" / "csrc" /
           "bulk_step.cu").read_text()
    assert f"{c['trace_name']}(" in src


# ---------------------------------------------------------------------------
# the kernel 3 readers
# ---------------------------------------------------------------------------

READERS = ("kernel3_roofline", "kernel3.wrapper_idle_share",
           "kernel3.wrapper_host_us")
KERNEL = "void (anonymous namespace)::bulk_step_kernel<float, 0>"


def _trace(device, host, t0=0, t1=1000, name=KERNEL):
    t = tr.Trace.__new__(tr.Trace)
    t.t0, t.t1 = t0, t1
    t.window_s = (t1 - t0) * 1e-9
    t.dev_start, t.dev_end, t.dev_name = t._clip(
        [(s, e, name) for s, e in device])
    t.host = [(t0, t1, tr.WINDOW_SPAN), *host]
    return t


class _Run:
    """What the readers read of a run of the cell: one call is one launch
    over ``points`` points of 720 records."""

    def __init__(self, trace, points=720 * 65160, kernels=("kernel3",)):
        self.trace = trace
        self.cfg = _mix_and_cfg()[1]
        self.kernels = kernels
        self.device_kind = "NVIDIA H100 80GB HBM3"
        self.points_per_call = points
        self.points_per_record = points // 720


def _read(run):
    return {m: load_module(HERE / "metrics" / f"{m}.py").read(run)
            for m in READERS}


BUSY = [(0, 400), (600, 1000)]
CASES = {
    # the gap under kernel 3's wrapper; the call's part is not its
    "in_call": (BUSY, [
        (350, 700, "aerobulk.run_series"),
        (450, 650, "aerobulk.kernel3.wrapper"),
        (500, 640, "aerobulk.kernel3.launch")], 15.0, 0.2),
    # another kernel's wrapper counts for nothing
    "other_kernel": (BUSY, [
        (450, 650, "aerobulk.kernel5.wrapper")], None, None),
    # two wrappers, one crossing the window's end: clipped for the idle
    # share, left out of the mean
    "edges": (BUSY, [
        (380, 420, "aerobulk.kernel3.wrapper"),
        (550, 1200, "aerobulk.kernel3.wrapper")], 7.0, 0.04),
    # in busy time only
    "busy": (BUSY, [(100, 300, "aerobulk.kernel3.wrapper")], 0.0, 0.2),
}


@pytest.mark.parametrize("case", CASES)
def test_wrapper_readers_on_a_known_trace(case):
    device, host, share, host_us = CASES[case]
    got = _read(_Run(_trace(device, host)))
    assert got["kernel3.wrapper_idle_share"] == (
        None if share is None else pytest.approx(share, rel=1e-12))
    assert got["kernel3.wrapper_host_us"] == (
        None if host_us is None else pytest.approx(host_us, rel=1e-12))


def test_the_roofline_prices_a_launch_as_a_whole_call():
    """Two launches of 8.358 ms over a month at 720 x 181 x 360: the census
    bound of a launch is 46,915,200 points x 2152 ops over 67 TFLOP/s
    (1.5069 ms, operations bind), 18.03% of the kernel's time."""
    ms = 8_358_000
    run = _Run(_trace([(0, ms), (ms + 100, 2 * ms + 100)], [],
                      t1=3 * ms))
    least = 720 * 65160 * 2152 / 67e12
    assert least == pytest.approx(1.5069e-3, rel=1e-4)
    got = _read(run)["kernel3_roofline"]
    assert got == pytest.approx(100.0 * least / 8.358e-3, rel=1e-9)
    assert got == pytest.approx(18.03, abs=0.01)


def test_the_roofline_reads_none_where_there_is_nothing():
    launches = [(0, 400)]
    assert _read(_Run(None))["kernel3_roofline"] is None
    assert _read(_Run(_trace(launches, []), kernels=("kernel5",)))[
        "kernel3_roofline"] is None
    assert _read(_Run(_trace(launches, [], name="mixed_step_kernel")))[
        "kernel3_roofline"] is None
    run = _Run(_trace(launches, []))
    run.device_kind = "another card"
    assert _read(run)["kernel3_roofline"] is None


def test_readers_without_a_trace_read_none():
    assert _read(_Run(None)) == dict.fromkeys(READERS)


# ---------------------------------------------------------------------------
# the cell
# ---------------------------------------------------------------------------

def test_the_cell_finds_its_files_by_name():
    cell = Cell(BENCH, CELL)
    assert cell.chips == 1 and cell.entry.Call.kernels == ("kernel3",)
    assert {m["name"] for m in cell.end_to_end} == {"points_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "device.idle_share", "call_mfu", *READERS}
    for traced in (False, True):
        for spec, reader in cell.readers(traced):
            assert callable(reader.read), spec["name"]
    limits = cell.limits()
    assert set(limits) == {"sig_frac", "med_err"}
    assert all(v["lower"] < v["limit"] < v["upper"] for v in limits.values())
    assert CENSUS.exists()


def test_the_config_is_the_programs_and_nothing_is_cut():
    mix, cfg = _mix_and_cfg()
    assert program_config(cfg) == api.AeroBulkConfig(
        algo="coare3p0", zt=2.0, zu=10.0, niter=5, use_skin=False,
        humidity="sh", rdt=3600.0, gdept=1.0)
    assert cfg["reduced"] == [] and cfg["grid"] == [181, 360]
    spec = {c["name"]: c for c in BENCH["configs"]}[cfg["name"]]
    assert spec["file"] == "fluxbench/configs/coare3p0_1deg_month.json"


def test_only_the_six_read_fields_go_to_the_device():
    """The entry holds the six fields the kernel reads, and one call
    launches the batched series once."""
    mix, cfg = _mix_and_cfg()
    call = Cell(BENCH, CELL).entry.Call(cfg, mix, 1, (2, 3),
                                        torch.device("cpu"))
    assert tuple(call.forcing) == bulk.FORCING
    assert call.points == 720 * 6 and call.records == 720
    out = call()
    assert out.QL.shape == (720, 2, 3) and out.Tau is None
    answers = call.answers(out)
    assert len(answers) == 6 * 720
    assert all(float(answers[f"dT_s[{k}]"].abs().max()) == 0.0
               for k in range(720))


def _run():
    result, lines = measure(Cell(BENCH, CELL), SEED, 0.05, False,
                            torch.device("cpu"), shape=SHAPE,
                            log=lambda line: None)
    return result, "\n".join(lines)


def test_a_sound_run_is_correct():
    result, lines = _run()
    assert result["correct"], lines
    assert set(result["check"]) == {"sig_frac", "med_err"}
    assert result["failed"] == 0 and result["attempted"] >= 1


def _control(cfg, *fields):
    """The plain reference in bfloat16 in the kernel's place."""
    outs = bulk.flux_step(dict(algo=cfg.algo, zt=cfg.zt, zu=cfg.zu,
                               niter=cfg.niter, use_skin=cfg.use_skin),
                          *(x.bfloat16() for x in fields))
    return tuple(o.to(fields[0].dtype) for o in outs)


def _half_left_out(step):
    def broken(*args):
        def half(x):
            flat = x.reshape(-1)
            n = flat.numel() // 2
            rest = flat[:n].mean().expand(flat.numel() - n)
            return torch.cat([flat[:n], rest]).reshape(x.shape)
        return tuple(map(half, step(*args)))
    return broken


def _answer_altered(step):
    def broken(*args):
        ql, *rest = step(*args)
        ql = ql.clone()
        ql[3] *= 1.1             # one record's latent heat
        return (ql, *rest)
    return broken


def _records_shifted(step):
    """Each record's answers one record late, the first repeated: an
    off-by-one between the batch's records and their forcing."""
    def broken(*args):
        return tuple(torch.cat([x[:1], x[:-1]]) for x in step(*args))
    return broken


FAULTS = {"control": lambda step: _control,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered,
          "records_shifted": _records_shifted}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_batch_is_not_correct(fault, monkeypatch):
    monkeypatch.setattr(kfused, "fused_bulk_step",
                        FAULTS[fault](kfused.fused_bulk_step))
    result, lines = _run()
    assert not result["correct"], lines
    assert any(c["value"] > c["limit"] for c in result["check"].values())
