"""loop.idle_share (%, device trace): the traced window's idle time that
falls under the program's time loop (an ``aerobulk.run_series`` span: the
call, its fresh state, a record's forcing indexing and step, the stack; or
a record's ``aerobulk.kernel1.backward``) and under no wrapper span, over
the window.  With wrappers.idle_share it is at most device.idle_share; the
rest is idle time outside the program (the caller's Python and sync, the
autograd engine between backward passes).  Traced, as wrappers.idle_share
is."""

from fluxbench.spans import loop_idle_share


def read(run):
    if run.trace is None or not len(run.trace.dev_start):
        return None
    return loop_idle_share(run.trace)
