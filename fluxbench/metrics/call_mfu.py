"""call_mfu (%, device trace): the census operations of every point the
traced window completed, over what the card's fp32 peak gives in the
window: the whole call's share of the chip's peak, which bounds any gain a
kernel's roofline share claims even where a change takes that kernel off
the path."""

from fluxbench.roofline import census, peaks


def read(run):
    counts = [census(run, k) for k in run.kernels]
    p = peaks(run)
    if run.trace is None or not run.calls or p is None or None in counts:
        return None
    ops = sum(c["ops_per_point"] for c in counts)
    return 100.0 * run.calls * run.points_per_call * ops / (
        p["fp32_flops"] * run.trace.window_s)
