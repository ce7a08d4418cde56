"""Lightweight observability: per-stage timers + torch.profiler hooks.

The reference has no tracing at all (its closest analogue is a handful of
debug PRINT flags, SURVEY.md §5).  Here: a ``stage`` context manager that
wall-times named stages (forcing host reads, device put, step, writeback),
an optional ``torch.profiler`` trace of a region (CPU and CUDA activity,
exported as a Chrome trace into ``trace_dir``), and a tiny report.  The
counterpart of ``aerobulk_tpu.profiling``.

:func:`span` marks a region of the program (the time loop, a kernel
wrapper, a backward pass) in whatever ``torch.profiler`` trace is being
taken, on the trace's own clock beside the device's operations.  With no
profiler running it returns a shared no-op context and costs one flag
read: the program's spans are on exactly when a profiler is.  Every span
name starts with ``aerobulk.`` and is a fixed string; a record index or a
call id goes in ``args`` (kept in the trace when the profiler records
shapes, ``record_shapes=True``).

For device time alone, ``measure.slope_cuda`` and ``measure.graph_ms``
replay launches from a CUDA graph and time them with CUDA events;
:func:`slope_time` here keeps the reference's host-clock contract.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Profiler", "slope_time", "span"]

#: what :func:`span` returns while no profiler runs
_OFF = contextlib.nullcontext()
#: the args of the innermost open span that has args, per thread
_OPEN = threading.local()
#: ids of the calls that open spans with an ``args["call"]``
_CALL_IDS = itertools.count()


def span(name: str, args: Optional[dict] = None):
    """A context that marks ``name`` in the running profiler's trace, with
    ``args`` (a dict of numbers and strings), or a shared no-op context
    when no profiler runs.

    The span is a ``RecordFunction`` of its own (``_RecordFunctionFast``:
    ``record_function`` drops its ``args`` string from the trace, and
    passes through the dispatcher), recorded on the trace's clock by
    whichever thread opens it, autograd's device thread included.  The
    flag it reads is True from a profiler's start to its stop."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


def open_args() -> Optional[dict]:
    """The ``args`` of the innermost open span that has any, on this
    thread (None while no profiler runs): what a span opened later, or on
    another thread, can name as its cause."""
    return getattr(_OPEN, "args", None)


def call_id() -> int:
    """A new id for a call's spans (``args["call"]``), unique in the
    process."""
    return next(_CALL_IDS)


class _Span:
    """One open span: the profiler's record of it, and its ``args`` left
    for :func:`open_args` while it is open."""

    __slots__ = ("_record", "_args", "_outer")

    def __init__(self, name, args):
        # it takes a tuple and a dict, never None
        self._record = torch._C._profiler._RecordFunctionFast(
            name, (), {} if args is None else args)
        self._args = args

    def __enter__(self):
        self._outer = open_args()
        if self._args is not None:
            _OPEN.args = self._args
        self._record.__enter__()
        return self

    def __exit__(self, *exc):
        self._record.__exit__(*exc)
        _OPEN.args = self._outer


def _host(x):
    """``x`` read back to the host: the completion sync of a device
    result."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _sync():
    """Wait for the work queued on the CUDA device, if CUDA is in use."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def slope_time(chained_run, m1: int = 1, m2: int = 5,
               repeats: int = 3) -> float:
    """Marginal wall time of one dispatch, by SLOPE.

    The fixed per-dispatch and per-sync overhead of a host clock dwarfs
    small workloads, so sustained throughput is measured as
    (t(m2) - t(m1)) / (m2 - m1) over chained dispatches: fixed overheads
    cancel exactly.

    ``chained_run(m)`` must issue m argument-distinct, serially-dependent
    dispatches and return a small tensor (or array) whose value depends on
    all of them; the host read-back (``.cpu()``) here is the completion
    sync.
    """
    # warm every distinct path (builds and caches outside the timed region)
    _host(chained_run(m2))
    slopes = []
    for _ in range(repeats):
        t = {}
        for m in (m1, m2):
            t0 = time.perf_counter()
            _host(chained_run(m))
            t[m] = time.perf_counter() - t0
        slopes.append((t[m2] - t[m1]) / (m2 - m1))
    # median: a transient host-contention spike skews one repeat's slope
    return max(float(np.median(slopes)), 1e-9)


class Profiler:
    """Accumulating wall-clock stage timer.

    >>> prof = Profiler()
    >>> with prof.stage("compute", block=True):
    ...     out = step(x)
    >>> print(prof.report())
    """

    def __init__(self, trace_dir: Optional[str] = None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.trace_dir = trace_dir
        #: the Chrome trace files :meth:`device_trace` wrote, in order
        self.traces: List[str] = []

    @contextlib.contextmanager
    def stage(self, name: str, block: bool = False):
        """Time the block as stage ``name``; in a profiler's trace it is
        the span ``aerobulk.stage.<name>``."""
        t0 = time.perf_counter()
        with span(f"aerobulk.stage.{name}"):
            try:
                yield
            finally:
                if block:
                    # include the stage's queued device work in its time
                    _sync()
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1

    @contextlib.contextmanager
    def device_trace(self):
        """Trace a region with ``torch.profiler`` (CPU activity, and CUDA
        activity where a GPU is present) and write it as a Chrome trace
        into ``trace_dir`` (its path appended to :attr:`traces`).  Does
        nothing when ``trace_dir`` is None."""
        if self.trace_dir is None:
            yield
            return
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.trace_dir, exist_ok=True)
        with torch.profiler.profile(activities=activities) as prof:
            try:
                yield
            finally:
                # the region's kernels complete inside the trace
                _sync()
        path = os.path.join(self.trace_dir,
                            f"trace_{os.getpid()}_{len(self.traces)}.json")
        prof.export_chrome_trace(path)
        self.traces.append(path)

    def report(self) -> str:
        lines = [f"{'stage':<24s} {'calls':>6s} {'total[s]':>10s} "
                 f"{'mean[ms]':>10s}"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            tot = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:<24s} {n:>6d} {tot:>10.3f} "
                         f"{tot / n * 1e3:>10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()
