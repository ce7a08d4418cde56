"""kernel3.wrapper_host_us (us, device trace): the mean duration of the
program's ``aerobulk.kernel3.wrapper`` spans that lie wholly in the traced
window, the host's cost of the stateless kernel's wrapper for each launch,
under the profiler's per-op overhead.  A program without the span gives
None."""

WRAPPER = "aerobulk.kernel3.wrapper"


def read(run):
    trace = run.trace
    if trace is None:
        return None
    d = [e - s for s, e, name in trace.host
         if name == WRAPPER and s >= trace.t0 and e <= trace.t1]
    return 1e-3 * sum(d) / len(d) if d else None
