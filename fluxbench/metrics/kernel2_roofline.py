"""kernel2_roofline (%, device trace): kernel 2's (the fused gradient's)
least time by its census, the VJP's ops and bytes per point, over its
device time in the traced window."""

from fluxbench.roofline import kernel_roofline


def read(run):
    return kernel_roofline(run, "kernel2")
