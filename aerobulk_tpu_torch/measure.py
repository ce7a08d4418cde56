"""Seeded synthetic forcing and CUDA-event timing for the scripts that
measure the kernels on the card (chip_smoke.py, grad_stage_cost.py,
``python3 -m aerobulk_tpu_torch.launch_sweep``).

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
