"""kernel3_roofline (%, device trace): kernel 3's (the stateless step's)
least time by its census (ops per point over the fp32 peak, or bytes per
point over the memory bandwidth, whichever is larger, times the points of a
launch) over its device time in the traced window, summed over the
launches in it.  One launch solves every record of a call, so a launch's
points are a call's, where ``roofline.kernel_roofline`` takes a record's."""

from fluxbench.roofline import census, peaks

KERNEL = "kernel3"


def read(run):
    if run.trace is None or KERNEL not in run.kernels:
        return None
    c, p = census(run, KERNEL), peaks(run)
    if c is None or p is None:
        return None
    seconds, launches = run.trace.device_seconds(c["trace_name"])
    if not launches:
        return None
    least = run.points_per_call * max(
        c["ops_per_point"] / p["fp32_flops"],
        c["bytes_per_point"] / p["bytes_per_s"])
    return 100.0 * launches * least / seconds
