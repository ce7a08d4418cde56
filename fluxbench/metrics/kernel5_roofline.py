"""kernel5_roofline (%, device trace): kernel 5's (the mixed ocean + ice
cell's) least time by its census (ops per point over the fp32 peak, or
bytes per point over the memory bandwidth, whichever is larger, times the
points of a launch) over its device time in the traced window, summed over
the launches in it."""

from fluxbench.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "kernel5")
