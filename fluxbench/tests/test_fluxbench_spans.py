"""The readers of the program's spans (``fluxbench/spans.py`` and the
metrics wrappers.idle_share, loop.idle_share, wrappers.host_us_per_launch)
on hand-built traces with known intervals, where every share is exact; and
on a real CPU trace of ``run_series``, that the trace's host events hold
the program's spans."""

import pytest
import torch

from aerobulk_tpu_torch import api
from fluxbench import spans
from fluxbench import trace as tr
from fluxbench.run import HERE, load_module

METRICS = ("wrappers.idle_share", "loop.idle_share",
           "wrappers.host_us_per_launch")


def _trace(device, host, t0=0, t1=1000):
    """A Trace of the window [t0, t1] (ns) with the device's operations
    ``device`` [(start, end)] and the host's ``host`` [(start, end,
    name)]."""
    t = tr.Trace.__new__(tr.Trace)
    t.t0, t.t1 = t0, t1
    t.window_s = (t1 - t0) * 1e-9
    t.dev_start, t.dev_end, t.dev_name = t._clip(
        [(s, e, "fused_step_kernel") for s, e in device])
    t.host = [(t0, t1, tr.WINDOW_SPAN), *host]
    return t


class _Run:
    def __init__(self, trace):
        self.trace = trace


def _read(trace):
    return {m: load_module(HERE / "metrics" / f"{m}.py").read(_Run(trace))
            for m in METRICS}


#: device busy [0, 400] and [600, 1000]: one gap, [400, 600]
BUSY = [(0, 400), (600, 1000)]

CASES = {
    # the gap under a wrapper inside a record: the wrapper's part is the
    # wrappers', the record's part before it the loop's
    "wrapper_in_record": (BUSY, [
        (350, 700, "aerobulk.run_series.record"),
        (450, 650, "aerobulk.kernel1.wrapper"),
        (500, 640, "aerobulk.kernel1.launch"),
        (455, 470, "aten::empty_like")], 15.0, 5.0, 0.2),
    # under a record alone: no wrapper span, so no wrapper metric
    "record_only": (BUSY, [
        (300, 550, "aerobulk.run_series.record"),
        (320, 340, "aten::select")], None, 15.0, None),
    # under a record's backward pass, which runs on autograd's thread and
    # holds kernel 2's wrapper; the harness's own spans count for nothing
    "backward": (BUSY, [
        (0, 1000, "fluxbench.backward"),
        (420, 580, "aerobulk.kernel1.backward"),
        (500, 560, "aerobulk.kernel2.wrapper")], 6.0, 10.0, 0.06),
    # outside every program span: the spans lie in busy time
    "outside": (BUSY, [
        (0, 1000, "fluxbench.call"),
        (410, 420, "aten::zeros"),
        (0, 390, "aerobulk.run_series.record"),
        (100, 300, "aerobulk.kernel1.wrapper")], 0.0, 0.0, 0.2),
    # spans crossing the window's edges are clipped to it; a wrapper that
    # crosses an edge is left out of the mean
    "edges": ([(100, 900)], [
        (-300, 50, "aerobulk.run_series"),
        (200, 260, "aerobulk.kernel1.wrapper"),
        (940, 1300, "aerobulk.run_series.record"),
        (950, 1200, "aerobulk.kernel1.wrapper")], 5.0, 6.0, 0.06),
}


@pytest.mark.parametrize("case", CASES)
def test_shares_of_a_known_trace(case):
    device, host, wrappers, loop, host_us = CASES[case]
    got = _read(_trace(device, host))
    assert got["wrappers.idle_share"] == wrappers
    assert got["loop.idle_share"] == loop
    if host_us is None:
        assert got["wrappers.host_us_per_launch"] is None
    else:
        assert got["wrappers.host_us_per_launch"] == pytest.approx(
            host_us, rel=1e-12)


def test_the_cases_together_stay_within_the_idle_time():
    """Every case's intervals in one window of 5000 ns, each case shifted
    into its own 1000 ns: the shares add up, and sum to at most the
    device's idle share."""
    device, host = [], []
    for i, (dev, hst, *_) in enumerate(CASES.values()):
        off = 1000 * i
        device += [(s + off, e + off) for s, e in dev]
        host += [(max(s + off, off - 100), e + off, n) for s, e, n in hst]
    t = _trace(device, host, 0, 5000)
    got = _read(t)
    assert got["wrappers.idle_share"] == 100.0 * (150 + 60 + 50) / 5000
    assert got["loop.idle_share"] == 100.0 * (50 + 150 + 100 + 60) / 5000
    idle = load_module(HERE / "metrics" / "device.idle_share.py").read(
        _Run(t))
    assert got["wrappers.idle_share"] + got["loop.idle_share"] <= idle
    assert idle == pytest.approx(100.0 * 1000 / 5000, rel=1e-12)


def test_a_program_without_spans_reads_none():
    got = _read(_trace(BUSY, [(400, 600, "_FusedStep"),
                              (0, 1000, "fluxbench.call")]))
    assert got == dict.fromkeys(METRICS)


def test_a_cpu_trace_holds_the_programs_spans():
    """A real ``torch.profiler`` trace of a CPU ``run_series`` in the
    harness's window: the Trace keeps the program's spans as host events,
    and the loop's spans cover its idle time (no device runs here)."""
    cfg = api.AeroBulkConfig(algo="coare3p6", use_skin=True, niter=2)
    g = torch.Generator().manual_seed(3)

    def field(lo, hi):
        return lo + (hi - lo) * torch.rand((2, 2, 3), generator=g,
                                           dtype=torch.float64)
    forcing = dict(sst=field(285, 300), t_zt=field(283, 298),
                   hum_zt=field(0.005, 0.015), U_zu=field(-8, 8),
                   V_zu=field(-8, 8), slp=field(1e5, 1.02e5),
                   rad_sw=field(0, 800), rad_lw=field(300, 400))
    with tr.profiled(True, False) as prof:
        with torch.profiler.record_function(tr.WINDOW_SPAN):
            api.run_series(cfg, forcing, isecday_utc=[0, 3600],
                           backend="fused")
    t = tr.Trace(prof)
    names = [n for _, _, n in t.host if n.startswith("aerobulk.")]
    assert names.count("aerobulk.run_series") == 1
    assert names.count("aerobulk.run_series.record") == 2
    assert 0.0 < spans.loop_idle_share(t) <= 100.0
    assert spans.wrappers_idle_share(t) is None
