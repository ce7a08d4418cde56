"""wrappers.idle_share (%, device trace): the traced window's idle time
(no kernel, copy or set on the card) that falls under one of the program's
``aerobulk.kernel{1,2}.wrapper`` spans, over the window: the device waiting
on the host's checks, output allocation and ctypes launch of kernels 1 and
2.  Read from the profiler's trace, whose per-op overhead slows the host:
it compares versions under the same tracing, not untraced host time."""

from fluxbench.spans import wrappers_idle_share


def read(run):
    if run.trace is None or not len(run.trace.dev_start):
        return None
    return wrappers_idle_share(run.trace)
