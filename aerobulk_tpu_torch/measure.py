"""Seeded synthetic forcing and CUDA-event timing for the scripts that
measure the kernels on the card (chip_smoke.py, grad_stage_cost.py,
``python3 -m aerobulk_tpu_torch.launch_sweep``) and for the roofline's
microbenchmark.

The forcing has the distributions of the JAX package's bench.py, drawn in
the same order from numpy's generator, so every script times the same
points.
"""

from __future__ import annotations

import numpy as np
import torch

#: the six inputs of the stateless step, in the kernel's order
BULK_INPUTS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def grid_forcing(shape, device, dtype, seed=42):
    """bench.py's forcing of the stateful step: (sst, t_zt, hum_zt, U_zu,
    V_zu, slp, rad_sw, rad_lw, lon) of ``shape``."""
    rng = np.random.default_rng(seed)
    sst = 285.0 + 15.0 * rng.random(shape)
    t = sst + rng.normal(0.0, 2.0, shape)
    q = 0.004 + 0.012 * rng.random(shape)
    u = rng.normal(0.0, 6.0, shape)
    v = rng.normal(0.0, 6.0, shape)
    slp = 98000.0 + 4000.0 * rng.random(shape)
    rsw = 500.0 * rng.random(shape)
    rlw = 250.0 + 150.0 * rng.random(shape)
    lon = 360.0 * rng.random(shape)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (sst, t, q, u, v, slp, rsw, rlw, lon))


def month_forcing(shape, device, dtype, seed=7):
    """bench.py::_mk_inputs over ``shape`` (records first): the six inputs
    of the stateless step by name."""
    rng = np.random.default_rng(seed)
    sst = 285.0 + 15.0 * rng.random(shape)
    arrays = (sst, sst + rng.normal(0.0, 2.0, shape),
              0.0005 + 0.012 * rng.random(shape), rng.normal(0.0, 6.0, shape),
              rng.normal(0.0, 6.0, shape), 98000.0 + 4000.0 * rng.random(shape))
    return {name: torch.as_tensor(a, dtype=dtype, device=device)
            for name, a in zip(BULK_INPUTS, arrays)}


def cold_forcing(shape, device, dtype, seed=42):
    """The forcing of bench.py::_mk_inputs(shape, seed=42, cold=True) (same
    distributions, same order) as (Ts_i, sst, t, q, u, v, slp, frice), with
    the ice surface at Ts_i = min(sst, 271 K) as bench.py sets it: BASELINE
    config 5's sea-ice and mixed cells."""
    rng = np.random.default_rng(seed)
    sst = 250.0 + 25.0 * rng.random(shape)
    t = sst + rng.normal(0.0, 2.0, shape)
    q = 0.0005 + 0.012 * rng.random(shape)
    u = rng.normal(0.0, 6.0, shape)
    v = rng.normal(0.0, 6.0, shape)
    slp = 98000.0 + 4000.0 * rng.random(shape)
    rng.random(shape), rng.random(shape), rng.random(shape)  # rsw rlw lon
    frice = rng.random(shape)
    arrays = (np.minimum(sst, 271.0), sst, t, q, u, v, slp, frice)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in arrays)


def cuda_ms(fn, inner, reps=7):
    """Median over ``reps`` of the mean time of ``inner`` calls of ``fn``,
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(inner):
            fn()
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1) / inner)
    return float(np.median(times))


#: device cycles the stream sleeps before each timed interval (~1 ms on an
#: H100): the host queues the event and all replays meanwhile, so the
#: interval holds device work only, not the host's launch latency
_SLEEP_CYCLES = 2_000_000
#: back-to-back replays of a graph per timed interval
_REPLAYS = 10


def slope_cuda(run, x0, m1, m2, repeats):
    """Marginal device seconds of one ``run`` by slope: ``m`` chained runs
    (each consumes the previous output) are captured into a CUDA graph, and
    (t(m2) - t(m1)) / (m2 - m1) over replays timed with CUDA events, median
    of ``repeats``.  Replaying the graph keeps the host's per-launch cost
    out of the time; each t(m) is the mean of ``_REPLAYS`` replays queued
    behind a sleep on the stream, so that a kernel of a few microseconds is
    not timed against the host's latency."""
    run(x0)                                    # build, load and warm
    torch.cuda.synchronize()
    graphs = {}
    for m in (m1, m2):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            x = x0
            for _ in range(m):
                x = run(x)
        graphs[m] = g
    for g in graphs.values():
        g.replay()
    torch.cuda.synchronize()
    slopes = []
    for _ in range(repeats):
        t = {}
        for m, g in graphs.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(_SLEEP_CYCLES)
            e0.record()
            for _ in range(_REPLAYS):
                g.replay()
            e1.record()
            e1.synchronize()
            t[m] = 1e-3 * e0.elapsed_time(e1) / _REPLAYS
        slopes.append((t[m2] - t[m1]) / (m2 - m1))
    return max(float(np.median(slopes)), 1e-12)


def graph_ms(launch, m1=1, m2=9, repeats=7):
    """Device milliseconds of one ``launch()`` by slope over CUDA-graph
    replays (:func:`slope_cuda`, with the launches independent rather than
    chained): the kernel alone, without the host work of a wrapper call.
    ``launch`` must write into buffers allocated beforehand, as
    ``kernels.fused.ice_step_launch``'s does."""
    return 1e3 * slope_cuda(lambda x: (launch(), x)[1], None, m1, m2,
                            repeats)
