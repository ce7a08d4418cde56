"""Seeded synthetic forcing and CUDA-event timing for the scripts that
measure the kernels on the card (chip_smoke.py, grad_stage_cost.py,
``python3 -m aerobulk_tpu_torch.launch_sweep``) and for the roofline's
microbenchmark.

The forcing has the distributions of the JAX package's bench.py, drawn in
the same order from numpy's generator, so every script times the same
points.  The long runs and the validity envelope are those of the JAX
package's tests (tests/test_long_series.py, tests/test_fuzz_robustness.py),
drawn the same way, with the port's ``thermo.q_sat``.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from . import constants as c
from . import thermo

#: the six inputs of the stateless step, in the kernel's order
BULK_INPUTS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp")


def bench_draws(shape, seed=42, cold=False, q_low=0.0005, sst_fp32=False):
    """Yield bench.py's forcing draws of ``shape`` as (name, numpy array),
    in its order from numpy's generator: sst, t, q, u, v, slp, rsw, rlw,
    lon, frice.  A caller takes as many as it needs.  ``cold`` is the
    sea-ice forcing (sst 250-275 K); ``q_low`` the humidity's least value
    (bench.py ``main`` draws from 0.004, ``_mk_inputs`` from 0.0005);
    ``sst_fp32`` rounds the SST to fp32 before the air temperature is drawn
    around it, as bench.py ``main`` does."""
    rng = np.random.default_rng(seed)
    base, spread = (250.0, 25.0) if cold else (285.0, 15.0)
    sst = base + spread * rng.random(shape)
    if sst_fp32:
        sst = sst.astype(np.float32)
    yield "sst", sst
    yield "t", sst + rng.normal(0.0, 2.0, shape)
    yield "q", q_low + 0.012 * rng.random(shape)
    yield "u", rng.normal(0.0, 6.0, shape)
    yield "v", rng.normal(0.0, 6.0, shape)
    yield "slp", 98000.0 + 4000.0 * rng.random(shape)
    yield "rsw", 500.0 * rng.random(shape)
    yield "rlw", 250.0 + 150.0 * rng.random(shape)
    yield "lon", 360.0 * rng.random(shape)
    yield "frice", rng.random(shape)


def first_tensors(draws, n, device, dtype):
    """The first ``n`` of ``draws`` as tensors, by name."""
    return {name: torch.as_tensor(a, dtype=dtype, device=device)
            for name, a in itertools.islice(draws, n)}


def grid_forcing(shape, device, dtype, seed=42):
    """bench.py's forcing of the stateful step: (sst, t_zt, hum_zt, U_zu,
    V_zu, slp, rad_sw, rad_lw, lon) of ``shape``."""
    draws = bench_draws(shape, seed, q_low=0.004)
    return tuple(first_tensors(draws, 9, device, dtype).values())


def mk_inputs(shape, device, dtype):
    """bench.py::_mk_inputs(shape) (seed 42): its ten fields (sst, t, q, u,
    v, slp, rsw, rlw, lon, frice) by its names."""
    return first_tensors(bench_draws(shape), 10, device, dtype)


def month_forcing(shape, device, dtype, seed=7):
    """bench.py::_mk_inputs over ``shape`` (records first): the six inputs
    of the stateless step by name."""
    f = first_tensors(bench_draws(shape, seed), 6, device, dtype)
    return dict(zip(BULK_INPUTS, f.values()))


def cold_forcing(shape, device, dtype, seed=42):
    """The forcing of bench.py::_mk_inputs(shape, seed=42, cold=True) as
    (Ts_i, sst, t, q, u, v, slp, frice), with the ice surface at
    Ts_i = min(sst, 271 K) as bench.py sets it: BASELINE config 5's sea-ice
    and mixed cells."""
    f = dict(bench_draws(shape, seed, cold=True))
    arrays = (np.minimum(f["sst"], 271.0),
              *(f[k] for k in ("sst", "t", "q", "u", "v", "slp", "frice")))
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in arrays)


def streamed_forcing(nrec, seed=42, shape=(721, 1440)):
    """bench.py --streamed's forcing: the base fields and lon (seed 42, the
    same distributions in the same order) as fp32 host arrays, and the
    per-record evolution factors of ``nrec`` records, precomputed in fp32
    so that the host records and the device-resident reference apply the
    same arithmetic: a slow SST ramp, a diurnal air-temperature wobble and a
    full diurnal shortwave cycle."""
    rng = np.random.default_rng(seed)
    base = {
        "sst": (285.0 + 15.0 * rng.random(shape)).astype(np.float32),
        "t_zt": (283.0 + 17.0 * rng.random(shape)).astype(np.float32),
        "hum_zt": (0.004 + 0.012 * rng.random(shape)).astype(np.float32),
        "U_zu": rng.normal(0.0, 6.0, shape).astype(np.float32),
        "V_zu": rng.normal(0.0, 6.0, shape).astype(np.float32),
        "slp": (98000.0 + 4000.0 * rng.random(shape)).astype(np.float32),
        "rad_sw": (500.0 * rng.random(shape)).astype(np.float32),
        "rad_lw": (250.0 + 150.0 * rng.random(shape)).astype(np.float32),
    }
    lon = (360.0 * rng.random(shape)).astype(np.float32)
    jts = np.arange(nrec)
    offs = {"sst": (0.01 * jts).astype(np.float32),
            "t_zt": (0.3 * np.sin(2 * np.pi * jts / 24.0)).astype(np.float32),
            "rad_sw": np.clip(np.sin(2 * np.pi * jts / 24.0), 0.0,
                              1.0).astype(np.float32)}
    return base, lon, offs


def stream_records(base, offs, stop, start=0):
    """Host records ``start`` to ``stop`` of the streamed base fields
    (:func:`streamed_forcing`'s, of the whole grid or of a slab)."""
    for jt in range(start, stop):
        rec = dict(base)
        rec["sst"] = base["sst"] + offs["sst"][jt]
        rec["t_zt"] = base["t_zt"] + offs["t_zt"][jt]
        rec["rad_sw"] = base["rad_sw"] * offs["rad_sw"][jt]
        rec["isecday_utc"] = np.int32((jt * 3600) % 86400)
        yield rec


def median(x):
    """numpy's median (the mean of the two middle values) of a tensor."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return float((s[(n - 1) // 2] + s[n // 2]) / 2)


def field_scale(ref):
    """The significance rule of the fp32 gate (docs/PARITY.md "The fp32
    tail") for a reference field ``ref`` (a tensor, any shape, no NaN):
    ``(scale, threshold, zero_field)``.  The scale is the median magnitude
    over the nonzero points (the warm-layer state is exactly 0 wherever no
    layer is built, often at most points); a difference is significant above
    10% of it, or above 1e-6 in a field that is zero everywhere."""
    ref = ref.reshape(-1)
    nonzero = ref[ref != 0].abs()
    scale = median(nonzero) if nonzero.numel() else 0.0
    zero_field = scale < 1e-20
    return scale, 1e-6 if zero_field else 0.1 * scale, zero_field


def grad_sig(got, ref):
    """The significance rule of an fp32 gradient ``got`` against an fp64
    one ``ref`` (tensors of one shape): a point is significant where
    |got - ref| > 0.1 max(|ref|, m), m the median magnitude of ``ref`` over
    its nonzero finite points, or where ``got`` is not finite and ``ref``
    is.  Points where ``ref`` is not finite are not compared.  In a field
    that is 0 everywhere (m = 0) any nonzero ``got`` is significant.

    :func:`field_scale`'s rule does not fit a gradient: a gradient field
    spans six decades where a flux field does not, so 10% of its median is
    fp32's rounding at its heavy-tailed points (3e3 to 8e5 times the
    median), and that rule calls 0.1-18% of a COARE gradient's points
    significant where the relative error is 4e-7 to 1e-4.  Scaling by the
    point's own magnitude, with the median as a floor, leaves the points
    whose gradient fp32 does not resolve.

    Returns ``(sig, thr, m)``: flat fp64 ``sig`` (bool) and ``thr`` (the
    per-point threshold), and ``m``."""
    got, ref = got.double().reshape(-1), ref.double().reshape(-1)
    finite = torch.isfinite(ref)
    mag = torch.where(finite, ref.abs(), 0.0)
    nonzero = mag[mag != 0]
    m = median(nonzero) if nonzero.numel() else 0.0
    thr = 0.1 * torch.clamp(mag, min=m)
    sig = finite & (((got - ref).abs() > thr) | ~torch.isfinite(got))
    return sig, thr, m


#: the gate of an fp32 gradient's significant fraction against fp64 under
#: :func:`grad_sig`, in the form of the fp32 month's gate (F5): at most
#: GRAD_SIG_ALONE, or, where the plain fp32 gradient shows as much, at most
#: GRAD_SIG_MULT times its fraction and GRAD_SIG_CEILING
GRAD_SIG_ALONE, GRAD_SIG_MULT, GRAD_SIG_CEILING = 1e-4, 2.0, 1e-2


def grad_sig_ok(frac, plain_frac):
    """Whether a gradient's significant fraction ``frac`` passes the gate
    beside the plain fp32 gradient's ``plain_frac``."""
    return frac <= GRAD_SIG_ALONE or (frac <= GRAD_SIG_MULT * plain_frac
                                      and frac <= GRAD_SIG_CEILING)


def timed_call(fn):
    """``(fn(), ms)``: its result and the milliseconds between CUDA events
    recorded before and after it."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def cuda_ms(fn, inner, reps=7):
    """Median over ``reps`` of the mean time of ``inner`` calls of ``fn``,
    CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = [timed_call(lambda: [fn() for _ in range(inner)])[1] / inner
             for _ in range(reps)]
    return float(np.median(times))


#: device cycles the stream sleeps before each timed interval (~1 ms on an
#: H100): the host queues the event and all replays meanwhile, so the
#: interval holds device work only, not the host's launch latency
_SLEEP_CYCLES = 2_000_000
#: back-to-back replays of a graph per timed interval
_REPLAYS = 10


def slopes_cuda(run, x0, m1, m2, repeats):
    """Marginal device seconds of one ``run`` by slope, one per repeat: ``m``
    chained runs (each consumes the previous output) are captured into a
    CUDA graph, and (t(m2) - t(m1)) / (m2 - m1) over replays timed with
    CUDA events, ``repeats`` times.  Replaying the graph keeps the host's
    per-launch cost out of the time; each t(m) is the mean of ``_REPLAYS``
    replays queued behind a sleep on the stream, so that a kernel of a few
    microseconds is not timed against the host's latency."""
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
        slopes.append(max((t[m2] - t[m1]) / (m2 - m1), 1e-12))
    return slopes


def slope_cuda(run, x0, m1, m2, repeats):
    """The median of :func:`slopes_cuda`."""
    return float(np.median(slopes_cuda(run, x0, m1, m2, repeats)))


def graph_ms(launch, m1=1, m2=9, repeats=7):
    """Device milliseconds of one ``launch()`` by slope over CUDA-graph
    replays (:func:`slope_cuda`, with the launches independent rather than
    chained): the kernel alone, without the host work of a wrapper call.
    ``launch`` must write into buffers allocated beforehand, as
    ``kernels.fused.ice_step_launch``'s does."""
    return 1e3 * slope_cuda(lambda x: (launch(), x)[1], None, m1, m2,
                            repeats)


def weather_forcing(nt, npts, seed, seasonal=False):
    """``nt`` hourly records of the reference's weather machine
    (tests/test_long_series.py::_weather_forcing, same draws in the same
    order) at ``npts`` points: clear days that build the warm layer, an
    overcast day in four that drains it, two-day wind bursts, and with
    ``seasonal`` an annual SST and solar cycle.  ``hum_zt`` is 0.6 of the
    port's ``thermo.q_sat`` in fp64.  Returns (dict of numpy fields,
    isecday, lon)."""
    rng = np.random.default_rng(seed)
    lon = np.linspace(0.0, 325.0, npts)
    sst0 = 287.0 + 10.0 * rng.random(npts)
    ndays = -(-nt // 24)
    hours = np.arange(nt)
    day = hours // 24
    isecday = ((hours % 24) * 3600 + 1800).astype(int)
    season_sst = (2.5 * np.sin(2 * np.pi * hours / 8760.0)[:, None]
                  if seasonal else 0.0)
    season_amp = (1.0 - 0.35 * np.cos(2 * np.pi * day / 365.0)
                  if seasonal else 1.0)
    amp = (850.0 - 700.0 * (day % 4 == 3)
           + 80.0 * rng.standard_normal(ndays)[day]) * season_amp
    amp = np.maximum(amp, 60.0)
    wind_base = 2.0 + 9.0 * (day % 7 >= 5) + 2.0 * rng.random(nt)
    f = {}
    f["sst"] = (sst0[None, :] + 0.8 * np.sin(hours / 96.0)[:, None]
                + season_sst + 0.05 * rng.normal(size=(nt, npts)))
    f["t_zt"] = (f["sst"] + 1.5 * np.sin(2 * np.pi * hours / 24.0)[:, None]
                 + rng.normal(0.0, 1.0, (nt, npts)))
    f["slp"] = 99000.0 + 3000.0 * rng.random((nt, npts))
    f["hum_zt"] = 0.6 * thermo.q_sat(torch.as_tensor(f["t_zt"]),
                                     torch.as_tensor(f["slp"])).numpy()
    f["U_zu"] = wind_base[:, None] + 1.5 * rng.random((nt, npts))
    f["V_zu"] = rng.normal(0.0, 2.0, (nt, npts))
    loc_h = (hours[:, None] + lon[None, :] / 15.0) % 24.0
    f["rad_sw"] = amp[:, None] * np.maximum(
        0.0, np.sin(np.pi * (loc_h - 6.0) / 12.0))
    f["rad_lw"] = 260.0 + 140.0 * rng.random((nt, npts))
    return f, isecday, lon


def ocean_envelope(n=20000, seed=77):
    """The reference's validity envelope (tests/test_fuzz_robustness.py::
    _fuzz_inputs, same draws in the same order; q_sat the port's, fp64):
    (sst, t_zt, hum_zt, U_zu, V_zu, slp, rad_sw, rad_lw, lon) as numpy,
    with the corners u = 0 (t = sst and t = sst + 25 K), 50 m/s (t = sst -
    25 K) and u = 0.001 at the first four points."""
    rng = np.random.default_rng(seed)
    sst = rng.uniform(c.ref_sst_min, c.ref_sst_max, n)
    t = np.clip(sst + rng.uniform(-25.0, 25.0, n), c.ref_taa_min,
                c.ref_taa_max)
    slp = rng.uniform(c.ref_slp_min, c.ref_slp_max, n)
    qs = thermo.q_sat(torch.as_tensor(t), torch.as_tensor(slp)).numpy()
    q = np.minimum(rng.uniform(0.0, 1.0, n) * qs, c.ref_sha_max - 1e-6)
    wnd = rng.uniform(c.ref_wnd_min, c.ref_wnd_max, n)
    ang = rng.uniform(0, 2 * np.pi, n)
    u, v = wnd * np.cos(ang), wnd * np.sin(ang)
    u[:4] = [0.0, 0.0, 50.0, 0.001]
    v[:4] = [0.0, 0.0, 0.0, 0.0]
    t[1] = sst[1] + 25.0
    t[2] = sst[2] - 25.0
    rsw = rng.uniform(c.ref_rsw_min, c.ref_rsw_max, n)
    rlw = rng.uniform(c.ref_rlw_min, c.ref_rlw_max, n)
    lon = rng.uniform(-180.0, 360.0, n)
    return sst, t, q, u, v, slp, rsw, rlw, lon


def ice_envelope(n=8000, seed=13):
    """The reference's ice envelope (tests/test_fuzz_robustness.py::
    test_ice_algos_finite_over_validity_envelope, same draws): (Ts_i, sst,
    t_zt, hum_zt, U_zu, V_zu, slp, frice) as numpy, wind 0 and 50 m/s and
    frice 0 and 1 at the first two points.  The leads' sst (the mixed
    kernel's) is drawn after, from ``seed + 1``: t_zt + U(-25, 25) K in
    the ocean's range."""
    rng = np.random.default_rng(seed)
    Ts_i = rng.uniform(230.0, 273.15, n)
    t = np.clip(Ts_i + rng.uniform(-20.0, 20.0, n), 180.0, 330.0)
    slp = rng.uniform(c.ref_slp_min, c.ref_slp_max, n)
    qs = thermo.q_sat(torch.as_tensor(t), torch.as_tensor(slp),
                      l_ice=True).numpy()
    q = rng.uniform(0.0, 1.0, n) * qs
    wnd = rng.uniform(0.0, 50.0, n)
    wnd[:2] = [0.0, 50.0]
    fr = rng.uniform(0.0, 1.0, n)
    fr[:2] = [0.0, 1.0]
    sst = np.clip(t + np.random.default_rng(seed + 1).uniform(-25.0, 25.0, n),
                  c.ref_sst_min, c.ref_sst_max)
    return Ts_i, sst, t, q, wnd, np.zeros(n), slp, fr
