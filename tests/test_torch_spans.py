"""The port's spans (``profiling.span``): what a ``torch.profiler`` trace
of ``run_series`` holds, that nothing reaches the profiler's record
functions while no profiler runs, the CLI stages' spans, and, on the card,
the wrapper and backward spans and the clock check (each kernel's launch
span opens before the kernel starts on the device, on the trace's one
clock).  No JAX: the ``cuda`` tests run on the card with ``--noconftest``.
"""

import threading

import numpy as np
import pytest
import torch

from aerobulk_tpu_torch import api, profiling

CFG = api.AeroBulkConfig(algo="coare3p6", use_skin=True, niter=3)
NAMES = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw")


def _forcing(nt=4, shape=(3, 5), dtype=torch.float64, device="cpu"):
    rng = np.random.default_rng(19)
    sst = 285.0 + 15.0 * rng.random((nt, *shape))
    arrays = (sst, sst + rng.normal(0, 2, sst.shape),
              0.004 + 0.012 * rng.random(sst.shape),
              rng.normal(0, 6, sst.shape), rng.normal(0, 6, sst.shape),
              98000 + 4000 * rng.random(sst.shape),
              500 * rng.random(sst.shape), 250 + 150 * rng.random(sst.shape))
    forcing = {n: torch.as_tensor(a, dtype=dtype, device=device)
               for n, a in zip(NAMES, arrays)}
    lon = torch.as_tensor(360 * rng.random(shape), dtype=dtype, device=device)
    return forcing, lon, [3600 * k for k in range(nt)]


def _traced(fn, cuda=False):
    """Run ``fn`` under ``torch.profiler`` (recording args); returns its
    result and the trace's kineto events."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts, record_shapes=True) as prof:
        result = fn()
        if cuda:
            torch.cuda.synchronize()
    return result, list(prof.profiler.kineto_results.events())


def _spans(events, name=None):
    """The program's spans, by start: (name, start, end, args, thread)."""
    out = [(e.name(), e.start_ns(), e.end_ns(), e.kwinputs(),
            e.start_thread_id()) for e in events
           if e.name().startswith("aerobulk.")
           and e.device_type() == torch.autograd.DeviceType.CPU]
    out.sort(key=lambda s: s[1])
    return [s for s in out if name is None or s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("fresh", [True, False], ids=["fresh", "given"])
@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_run_series_spans(backend, fresh):
    """One ``aerobulk.run_series`` (backend, nt, call), ``nt`` records in
    order with their call and k, one ``.init_state`` only for a fresh
    state, one ``.stack`` after the last record, all nested in the call."""
    forcing, lon, isd = _forcing()
    nt = len(isd)
    state = None if fresh else api.init_skin_state(
        CFG, forcing["sst"].shape[1:], torch.float64, "cpu")
    _, events = _traced(lambda: api.run_series(
        CFG, forcing, skin_state=state, isecday_utc=isd, lon=lon,
        backend=backend))
    (call,) = _spans(events, "aerobulk.run_series")
    assert call[3]["backend"] == backend and call[3]["nt"] == nt
    records = _spans(events, "aerobulk.run_series.record")
    assert [r[3] for r in records] == [
        {"call": call[3]["call"], "k": k} for k in range(nt)]
    inits = _spans(events, "aerobulk.run_series.init_state")
    assert len(inits) == int(fresh)
    (stack,) = _spans(events, "aerobulk.run_series.stack")
    for s in records + inits + [stack]:
        assert _inside(s, call), s
    for a, b in zip(records, records[1:]):
        assert a[2] <= b[1]
    assert all(i[2] <= records[0][1] for i in inits)
    assert records[-1][2] <= stack[1]
    # the CPU path launches no kernel, so it opens no wrapper span
    assert not [s for s in _spans(events) if ".kernel" in s[0]]


def test_run_series_call_ids_differ():
    forcing, lon, isd = _forcing(nt=2)

    def two():
        for _ in range(2):
            api.run_series(CFG, forcing, isecday_utc=isd, lon=lon)
    _, events = _traced(two)
    ids = [s[3]["call"] for s in _spans(events, "aerobulk.run_series")]
    assert len(ids) == 2 and ids[0] != ids[1]


class _Counting:
    """Stands in for a record-function class and counts its uses."""

    def __init__(self, real):
        self.real, self.n = real, 0

    def __call__(self, *a, **kw):
        self.n += 1
        return self.real(*a, **kw)


def _series_and_grad(backend):
    forcing, lon, isd = _forcing(nt=3)
    forcing["sst"].requires_grad_()
    out, state = api.run_series(CFG, forcing, isecday_utc=isd, lon=lon,
                                backend=backend)
    (g,) = torch.autograd.grad((out.QL + out.QH).sum(), forcing["sst"])
    return g


@pytest.mark.parametrize("backend", ["eager", "fused"])
def test_no_record_function_without_a_profiler(monkeypatch, backend):
    """With no profiler running, a series and a gradient through it enter
    no record function of any kind; under a profiler the same counters see
    every span, so the count reaches the spans."""
    counters = {}
    for owner, attr in ((torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (torch._C._profiler, "_RecordFunctionFast")):
        counters[attr, owner.__name__] = c = _Counting(getattr(owner, attr))
        monkeypatch.setattr(owner, attr, c)
    assert not torch.autograd.profiler._is_profiler_enabled
    _series_and_grad(backend)
    assert sum(c.n for c in counters.values()) == 0, counters
    _, events = _traced(lambda: _series_and_grad(backend))
    assert sum(c.n for c in counters.values()) == len(_spans(events)) > 0


def test_span_is_shared_and_inert_without_a_profiler():
    assert profiling.span("aerobulk.x") is profiling.span("aerobulk.y", {})
    with profiling.span("aerobulk.x", {"k": 1}):
        assert profiling.open_args() is None


def test_open_args_follow_the_innermost_span_with_args():
    seen = {}

    def other_thread():
        seen["thread"] = profiling.open_args()

    def nested():
        with profiling.span("aerobulk.a", {"call": 1}):
            seen["outer"] = profiling.open_args()
            with profiling.span("aerobulk.b"):
                seen["no_args"] = profiling.open_args()
                with profiling.span("aerobulk.c", {"call": 1, "k": 2}):
                    seen["inner"] = profiling.open_args()
                    t = threading.Thread(target=other_thread)
                    t.start()
                    t.join(timeout=30)
                    assert not t.is_alive()
                seen["after"] = profiling.open_args()
        seen["closed"] = profiling.open_args()
    _, events = _traced(nested)
    assert seen == {"outer": {"call": 1}, "no_args": {"call": 1},
                    "inner": {"call": 1, "k": 2}, "thread": None,
                    "after": {"call": 1}, "closed": None}
    assert [s[0] for s in _spans(events)] == ["aerobulk.a", "aerobulk.b",
                                              "aerobulk.c"]


@pytest.mark.parametrize("block", [False, True])
def test_profiler_stage_emits_its_span(block):
    prof = profiling.Profiler()

    def staged():
        with prof.stage("read", block=block):
            torch.ones(3).sum()
    _, events = _traced(staged)
    assert [s[0] for s in _spans(events)] == ["aerobulk.stage.read"]
    assert prof.counts["read"] == 1
    staged()                    # and without a profiler, the timer alone
    assert prof.counts["read"] == 2


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def _card_series_and_grad(nt=3, shape=(64, 128)):
    forcing, lon, isd = _forcing(nt, shape, torch.float32, "cuda")
    forcing["sst"].requires_grad_()

    def run():
        out, _ = api.run_series(CFG, forcing, isecday_utc=isd, lon=lon,
                                backend="fused", fused_grad_backend="kernel")
        return torch.autograd.grad((out.QL + out.QH).sum(), forcing["sst"])
    run()                                   # build and load the kernels
    torch.cuda.synchronize()
    return run


@pytest.mark.cuda
def test_wrapper_and_backward_spans_on_the_card():
    """Each record's kernel 1 wrapper holds its check, alloc and launch in
    that order inside the record; each backward span, on autograd's device
    thread, names its forward's call and k and holds kernel 2's wrapper
    with its own check, alloc and launch."""
    _cuda_or_skip()
    nt = 3
    _, events = _traced(_card_series_and_grad(nt), cuda=True)
    (call,) = _spans(events, "aerobulk.run_series")
    records = _spans(events, "aerobulk.run_series.record")
    assert len(records) == nt
    for n in (1, 2):
        wrappers = _spans(events, f"aerobulk.kernel{n}.wrapper")
        assert len(wrappers) == nt, n
        parts = [_spans(events, f"aerobulk.kernel{n}.{p}")
                 for p in ("check", "alloc", "launch")]
        for w, check, alloc, launch in zip(wrappers, *parts, strict=True):
            for s in (check, alloc, launch):
                assert _inside(s, w), (w, s)
            assert check[2] <= alloc[1] and alloc[2] <= launch[1]
    for r, w in zip(records, _spans(events, "aerobulk.kernel1.wrapper")):
        assert _inside(w, r)
    backward = _spans(events, "aerobulk.kernel1.backward")
    assert sorted(b[3]["k"] for b in backward) == list(range(nt))
    assert {b[3]["call"] for b in backward} == {call[3]["call"]}
    assert {b[4] for b in backward} != {call[4]}
    for b, w in zip(backward, _spans(events, "aerobulk.kernel2.wrapper")):
        assert _inside(w, b) and w[4] == b[4]


#: how far the card's clock may stand from the host's in a trace: kineto's
#: device stamps were seen up to 0.54 ms early from a profiler's start, and
#: drifting 155 us a second in a 10 s trace; within 12 us in most traces
#: (NVIDIA H100, torch 2.11)
CLOCK_DRIFT_NS = 1_000_000


@pytest.mark.cuda
def test_launch_spans_open_before_their_kernels_start():
    """The clock check: every kernel 1 and kernel 2 launch, paired with its
    runtime call by correlation id, lies in an ``aerobulk.kernelN.launch``
    span that opened no later than the kernel started on the device, to
    within the drift of the card's clock (``CLOCK_DRIFT_NS``)."""
    _cuda_or_skip()
    _, events = _traced(_card_series_and_grad(), cuda=True)
    lags = launch_lags(events)
    assert sorted(lags) == ["kernel1", "kernel2"]
    for n, (span_lead, _) in lags.items():
        assert len(span_lead) == 3, (n, span_lead)
        assert min(span_lead) >= -CLOCK_DRIFT_NS, (n, lags)


def launch_lags(events):
    """{"kernel1"/"kernel2": (span_lead_ns, runtime_lead_ns)}: for each of
    the kernel's device events, the device start less the start of the
    launch span that holds its runtime call, and less the runtime call's
    own start."""
    kernels = {"fused_step_kernel": "kernel1", "fused_grad_kernel": "kernel2"}
    cpu = torch.autograd.DeviceType.CPU
    runtime = {e.correlation_id(): e for e in events
               if e.device_type() == cpu and "LaunchKernel" in e.name()}
    spans = {n: _spans(events, f"aerobulk.{n}.launch")
             for n in kernels.values()}
    lags = {}
    for e in events:
        n = next((v for k, v in kernels.items() if k in e.name()), None)
        if n is None or e.device_type() == cpu:
            continue
        call = runtime.get(e.correlation_id()) or runtime.get(
            e.linked_correlation_id())
        assert call is not None, e.name()
        (holder,) = [s for s in spans[n]
                     if s[1] <= call.start_ns() <= s[2]]
        lead = lags.setdefault(n, ([], []))
        lead[0].append(e.start_ns() - holder[1])
        lead[1].append(e.start_ns() - call.start_ns())
    return lags
