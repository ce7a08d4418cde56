"""device.idle_share (%, device trace): the traced window less the union
of the intervals in which a kernel, copy or set ran on the card, over the
window."""


def read(run):
    if run.trace is None or not len(run.trace.dev_start):
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
