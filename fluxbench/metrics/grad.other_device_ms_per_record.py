"""grad.other_device_ms_per_record (ms, device trace): the device time of
every operation other than kernels 1 and 2 in the traced window (autograd's
materialized zero cotangents, the stacking of outputs, the loss, the
gradient's accumulation), per record completed in it.  Read in cells whose
calls run kernel 2."""

from fluxbench.roofline import census


def read(run):
    counts = [census(run, k) for k in run.kernels]
    records = run.calls * run.records_per_call
    if (run.trace is None or "kernel2" not in run.kernels or not records
            or None in counts or not len(run.trace.dev_name)):
        return None
    total, _ = run.trace.device_seconds()
    own = sum(run.trace.device_seconds(c["trace_name"])[0] for c in counts)
    return 1e3 * (total - own) / records
