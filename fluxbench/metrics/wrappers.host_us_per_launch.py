"""wrappers.host_us_per_launch (us, device trace): the mean duration of
the program's ``aerobulk.kernel{1,2}.wrapper`` spans in the traced window,
the host's cost of a wrapper for each launch of kernel 1 or 2, under the
profiler's per-op overhead."""

from fluxbench.spans import wrapper_host_us


def read(run):
    if run.trace is None:
        return None
    return wrapper_host_us(run.trace)
