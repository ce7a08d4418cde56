"""kernel3.wrapper_idle_share (%, device trace): the traced window's idle
time (no kernel, copy or set on the card) that falls under one of the
program's ``aerobulk.kernel3.wrapper`` spans, over the window: the device
waiting on the host's checks, output allocation and ctypes launch of the
stateless kernel.  Read from the profiler's trace, whose per-op overhead slows
the host: it compares versions under the same tracing, not untraced host
time.  A program without the span gives None."""

from fluxbench.spans import idle_covered_ns, union

WRAPPER = "aerobulk.kernel3.wrapper"


def read(run):
    trace = run.trace
    if trace is None or not len(trace.dev_start):
        return None
    spans = union(trace, lambda name: name == WRAPPER)
    if spans is None:
        return None
    return 100.0 * idle_covered_ns(trace, spans) / (trace.t1 - trace.t0)
