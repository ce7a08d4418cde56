"""points_per_s (end to end, host clock): grid points completed over the
window, every point of every record of every call that ended in it (in a
value+grad call a point counts once its value and gradient are done),
over the window's seconds, from the first call's start to the end of the
call in progress when the window's time ran out."""


def read(run):
    return run.calls * run.points_per_call / run.window_s if run.calls \
        else None
