"""The program's own spans in a traced window, and the share of the
device's idle time that each of its layers covers.

The program opens its spans (``aerobulk_tpu_torch.profiling.span``) only
while a profiler runs; they are host events of the same trace as the
device's operations, so they share its clock.  Spans are picked by name:

* wrappers: ``aerobulk.kernel1.wrapper`` and ``aerobulk.kernel2.wrapper``,
  from the fields' checks to the return of a launch's wrapper;
* the time loop: every ``aerobulk.run_series`` span (the call, its fresh
  state, each record, the stack) and ``aerobulk.kernel1.backward`` (a
  record's backward pass, on autograd's device thread).

A span is clipped to the window, and spans of one layer are merged into
the union of their intervals, so nesting and threads count once.  Idle
time covered by a wrapper is the wrappers'; idle time covered by the loop
and by no wrapper is the loop's.  A program without these spans (an
earlier version) gives None.
"""

from __future__ import annotations

import numpy as np

WRAPPERS = ("aerobulk.kernel1.wrapper", "aerobulk.kernel2.wrapper")
LOOP_PREFIX = "aerobulk.run_series"
BACKWARD = "aerobulk.kernel1.backward"


def is_wrapper(name: str) -> bool:
    return name in WRAPPERS


def is_loop(name: str) -> bool:
    return name == BACKWARD or name == LOOP_PREFIX or name.startswith(
        LOOP_PREFIX + ".")


def union(trace, pick):
    """The union of the host spans whose name ``pick`` accepts, clipped to
    the window: sorted disjoint (starts, ends), or None if there is no such
    span in the window."""
    iv = sorted((max(s, trace.t0), min(e, trace.t1))
                for s, e, name in trace.host
                if pick(name) and e > trace.t0 and s < trace.t1)
    if not iv:
        return None
    starts, ends = [], []
    for s, e in iv:
        if starts and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return np.array(starts, np.int64), np.array(ends, np.int64)


def _covered_before(starts, ends, t):
    """The length of the union (starts, ends) that lies before each time of
    ``t``."""
    cum = np.concatenate([[0], np.cumsum(ends - starts)])
    i = np.searchsorted(starts, t, "right")       # intervals begun by t
    last = np.maximum(i - 1, 0)
    part = np.where(i > 0, np.minimum(ends[last], t) - starts[last], 0)
    return cum[last] + part


def idle_covered_ns(trace, intervals) -> int:
    """The idle time of the window (``trace.gaps()``) that the disjoint
    ``intervals`` cover, in ns."""
    gs, ge = trace.gaps()
    if intervals is None or not len(gs):
        return 0
    starts, ends = intervals
    return int((_covered_before(starts, ends, ge)
                - _covered_before(starts, ends, gs)).sum())


def wrappers_idle_share(trace):
    """The window's idle time under a wrapper span, in % of the window."""
    w = union(trace, is_wrapper)
    if w is None:
        return None
    return 100.0 * idle_covered_ns(trace, w) / (trace.t1 - trace.t0)


def loop_idle_share(trace):
    """The window's idle time under a time-loop span and under no wrapper
    span, in % of the window."""
    if union(trace, is_loop) is None:
        return None
    both = union(trace, lambda n: is_loop(n) or is_wrapper(n))
    wrappers = union(trace, is_wrapper)
    return 100.0 * (idle_covered_ns(trace, both) - idle_covered_ns(
        trace, wrappers)) / (trace.t1 - trace.t0)


def wrapper_host_us(trace):
    """The mean duration of the wrapper spans that lie wholly in the
    window, in microseconds."""
    d = [e - s for s, e, name in trace.host
         if is_wrapper(name) and s >= trace.t0 and e <= trace.t1]
    return 1e-3 * sum(d) / len(d) if d else None
