"""The yardstick of the roofline metrics: the census of each kernel
(``census/<kernel>.<algo>.niter<n>.json``: operations and bytes a point,
the name the kernel has in a trace) and the card's published peaks
(``peaks.json``), found by name."""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def census(run, kernel: str):
    """The census of ``kernel`` for the run's config, or None."""
    cfg = run.cfg
    path = HERE / "census" / f"{kernel}.{cfg['algo']}.niter{cfg['niter']}.json"
    return json.loads(path.read_text()) if path.exists() else None


def peaks(run):
    """The published peaks of the run's card, or None for another card."""
    for kind, p in json.loads((HERE / "peaks.json").read_text()).items():
        if kind in run.device_kind:
            return p
    return None


def kernel_roofline(run, kernel: str):
    """``kernel``'s least time by its census over its device time in the
    traced window, in %: launches in the window x max(ops / fp32 peak,
    bytes / bandwidth) x points a launch, over the sum of their device
    times.  None where the cell does not run it or nothing is known."""
    if run.trace is None or kernel not in run.kernels:
        return None
    c, p = census(run, kernel), peaks(run)
    if c is None or p is None:
        return None
    seconds, launches = run.trace.device_seconds(c["trace_name"])
    if not launches:
        return None
    least = run.points_per_record * max(
        c["ops_per_point"] / p["fp32_flops"],
        c["bytes_per_point"] / p["bytes_per_s"])
    return 100.0 * launches * least / seconds
