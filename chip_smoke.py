"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — the card (nvidia-smi name and power limit, torch's name);
  2. build   — nvcc builds the kernels from the sources in this checkout,
     one nvcc per source, all at once (the whole build's wall-clock
     seconds, each source's flags and nvcc seconds, each kernel
     instantiation's registers and spills, the ice and mixed kernels'
     among them);
  3. parity  — one fused_flux_step through the CUDA kernel against its plain
     PyTorch version on the card, in fp64 and fp32, on the 0.25-degree grid
     (721x1440) with COARE 3.6 + cool skin + warm layer, niter=5;
  4. series  — the forward main path: run_series(backend="fused") over 24
     hourly records in fp32, which must launch the kernel once per record,
     stay finite, build and reset the warm layer, and match the eager
     series;
  5. timing  — one step of the kernel and of the plain version, CUDA events,
     in fp32 and fp64, and of the kernel at niter=20 (bench.py --niter 20's
     setting, which phase 18 prices with the port's traced census);
  6. grad_parity — the gradient kernel against autograd of the plain step
     (fused_flux_step_vjp_plain) on the card, all 13 input gradients for
     seeded cotangents on all 10 outputs, fp64 and fp32, from a fresh state
     (Hz_wl == HWL_MAX everywhere: the tie of wl_coare's clamp) and from the
     state phase 4 ends with; in fp32 also the kernel and the plain fp32
     VJP against the plain VJP in fp64 at the same fp32 inputs, per
     gradient under the gradient's rule (measure.grad_sig): sig_frac,
     plain_sig_frac, unwitnessed_sig_frac (significant points where no
     input moved one ulp alone moves the gradient past the threshold) and
     the plain VJP's, max_rel and max_abs against fp64 of both, gated at
     1e-4 or twice the plain VJP's (ROADMAP.md section 3, F8); then one
     ``worst_point`` line for each of the 5 points of the largest fp32
     error: its inputs, 1/L and u* in fp32 and fp64, the 13 gradients of
     the kernel, the plain fp32 VJP and fp64, whether it is witnessed;
  7. grad_series — the gradient main path: d(sum of QL + QH + Tau_x over
     the 24 records of phase 4) / d(sst forcing, initial state) through
     run_series(backend="fused", fused_grad_backend="kernel"), which must
     launch the gradient kernel once per record, against
     run_series(backend="eager", remat=True); both against the same
     records upcast through kernels 1 and 2 in fp64 with phase 6's fields
     (reported, not gated);
  8. grad_timing — one value+grad step (forward kernel + gradient kernel,
     against forward + autograd of the plain step), and the gradient kernel
     alone against the bound of its jax.vjp census, CUDA events, fp32 and
     fp64;
  9. bulk_parity — the stateless kernel (fused_bulk_step) against its plain
     version on the card for the five ocean algorithms, fp64 and fp32, on a
     month of hourly records of the 1-degree grid (720 x 181 x 360 =
     46,915,200 points in one launch); then, at NCAR's first significant
     fp32 QH points, the six inputs and the point stepped three ways
     (fp32 kernel, fp32 plain, fp64: stab, zeta_u per iteration, QH per
     niter); then the stateless main path,
     run_series(batch_records=True, backend="fused") on the fp32 month,
     which must launch the kernel once per series and match
     backend="eager"; then a year of hourly records at one buoy, shape
     (8760,), with a Python-float slp;
 10. bulk_timing — one launch of the stateless kernel and of its plain
     version on the month, CUDA events, per algorithm, fp32 and fp64;
 11. ice_parity — the ice kernel (fused_ice_step) against its plain version
     on the card for the seven sea-ice algorithms (ice_easy with non-default
     CdN, ChN, CeN), fp64 and fp32, on the 0.25-degree grid with the cold
     forcing of bench.py (BASELINE config 5, Ts_i = min(sst, 271 K)); then
     one ``sig_point`` line for each fp32 significant point that is not a
     reference blow-up (the first 20 of each field): its index, its inputs,
     and every output from the fp32 kernel, the fp32 plain version and the
     plain version in fp64;
 12. mixed_parity — the mixed ocean+ice kernel (fused_mixed_step) against
     its plain version, fp64 and fp32: LG15 ice + ECMWF leads (BASELINE
     config 5), the simultaneous LG15_IO solve, every other ice algorithm
     with ECMWF and every other ocean algorithm with LG15, with the
     ``sig_point`` lines of phase 11; then the main path of this workload,
     one fused_mixed_step of config 5 and one fused_ice_step of its
     ice-only companion (ice_lg15), which must launch each kernel exactly
     once;
 13. ice_timing — fp32 and fp64, every ice algorithm and LG15 ice with
     each ocean algorithm and LG15_IO: the kernel alone (its launch into
     outputs allocated once, replayed from a CUDA graph and timed by slope,
     measure.graph_ms) and the wrapper call (CUDA events), each with its
     launch shape; the plain versions of the main path's three (ice_lg15;
     mixed LG15 + ECMWF and LG15_IO), with points/s and the bound;
 14. ecmwf_parity — BASELINE config 4, ECMWF + cool skin + warm layer:
     the ECMWF build of kernel 1 against the plain step, fp64 and fp32,
     on phase 3's forcing, with config 4's own cross-check (the fp64
     median |ECMWF - COARE 3.6| per field, not gated);
 15. ecmwf_series — config 4's main path: 24 hourly fp32 records through
     run_series(backend="fused"), 24 launches, finite, the warm layer
     builds, matches the eager series;
 16. ecmwf_grad_parity — the ECMWF gradient kernel against autograd of the
     plain step, all 13 gradients, fp64 and fp32, from a fresh state
     (dT_wl == 0: the ties of wl_ecmwf's MAX) and from phase 15's final
     state, with phase 6's fp32 fields, gates and worst points; then the
     value+grad series through fused_grad_backend="kernel" (24 gradient
     launches) against the eager remat=True series;
 17. ecmwf_timing — step, gradient and value+grad, kernel and plain, fp32
     and fp64, with points/s and the bounds;
 18. roofline — kernel 6 (primitive_chain.cu, and primitive_chain_
     forward.cu for the forms kernels 1-5 run: pow_pos in fp32
     and fp64, div.full.f32 and sqrt.approx.f32) against its plain version
     for every (op class or form, P, K) it is built for; then the
     roofline's main path, measure_primitive_throughput: the per-class and
     per-form rates in fp32 and fp64 at (1024, 1024) with a P sweep at K=64
     (and ptxas registers and spills beside each P), the FMA ceiling at
     (2048, 2048), and for every kernel timed above its census priced at
     its own build's forms (_build.flags of its source: the fp32 pow,
     div and sqrt of every kernel built with FORWARD_FLAGS, kernels 1-5,
     at pow_pos, div_approx and sqrt_approx; every fp64 build's pow at
     pow_pos, div and sqrt IEEE): the serial-issue floor
     (points_per_s_serial_issue; above 1 the kernel overlaps classes), the
     ceiling (points_per_s_ceiling: the larger time of each transcendental
     class alone at its best rate over P and of every op at twice the FMA
     ceiling) and the kernel's share of it, implied op rate and fraction of
     twice the FMA ceiling.  Fails if a cheap-class rate exceeds the data
     sheet's FMA rate (the chain was folded), or a kernel reads above 1.05
     of its ceiling (the ceiling prices the wrong ops);
 19. streamed — the streamed host feed of bench.py --streamed (BASELINE
     config 3 fed from host numpy records, seed 42, fp32, chunks of 8):
     the pinned link's H2D and D2H bandwidth (slope from 8 to 64 MB) and
     the host seconds a chunk's collected fields cost the consumer (copied
     out of the collector's pinned ring, against fresh pinned memory); then
     per run of pipeline.run_series_pipelined(backend="fused") — 48
     records through the wires (f32, f32), (i16, f32), (i8d, f32), (f32,
     i16), 48 ECMWF + skin records (f32, f32) and 24 records one at a time
     (chunk=None) — which must launch kernel 1 once per record: streamed
     and compute-only points/s (the same chunk program on device-resident
     forcing), the transfer bound, overlap_efficiency(_vs_bound), the
     producer's seconds per chunk, the host staging, link and kernel
     seconds per chunk, and the collected outputs of every record against
     run_series(backend="fused") on forcing built on the device,
     at bench.py's streamed gates (median relative < 1e-6 and significant
     fraction < 1e-5 for the exact wire, 1e-3 and 1e-3 where a wire
     quantizes); then a 24-record stream
     checkpointed after 12 (save_skin_state / load_skin_state), which must
     resume bitwise;
 20. long_series — kernel 1 over long runs of the reference's weather
     machine (tests/test_long_series.py, copied here): (a) its month (seed
     405, 6 points, 720 records), COARE 3.6 and ECMWF + skin, through
     run_series one record a call (720 launches each), kernel 1 fp32, the
     eager port fp32 and kernel 1 fp64 against the eager port fp64, each
     held to the reference's asserted fp32 drift budgets (the two eager
     runs on the host's CPU, kernel 1's on the card); (b) its year
     (seed 406, 4 points, 8760 records, seasonal), kernel 1 fp32 against
     kernel 1 fp64 at the reference's year assertions (no compounding,
     median QL drift, regime-flip fraction); (c) the month at 721x1440,
     the fields made on the card record by record from a seeded generator,
     kernel 1 fp32 and the eager port fp32 against kernel 1 fp64 for both
     algorithms: in every record and field kernel 1 fp32 at most 1e-4
     significant or, where fp32 itself leaves that (the eager port; COARE's
     dT_wl, ROADMAP.md section 3, F5), at most twice the eager port's
     fraction and 1e-2; the flips (QL or QH apart by more than 0.5 W/m^2)
     counted and the first listed;
 21. envelope — the reference's validity envelope (tests/
     test_fuzz_robustness.py: 20,000 ocean points with the corners u = 0,
     t = sst +- 25 K, 50 m/s; 8,000 ice points) through kernel 1 (COARE
     3.6 and ECMWF + skin, niter=10), kernel 3 (five algorithms, niter=10),
     kernel 4 (seven, niter=8) and kernel 5 (LG15 with each ocean, each ice
     algorithm with ECMWF, LG15_IO; niter=8), fp32 and fp64: every output
     finite wherever the eager port in fp64 is, with the points that are
     not listed (inputs; kernel, fp32 plain and fp64 values);
 22. linearized — at 721x1440 on phase 3's forcing, flux_step_linearized
     for COARE 3.6 and ECMWF + skin in each of its eight fields, and
     flux_step_ice_linearized in Ts_i for ice_lg15 on phase 11's forcing:
     fp64 against central differences with steps h and h/2 away from
     branch switches, fp32 against fp64 at 1e-4 significant (points where
     only fp32 is not finite count) over the points whose derivative fp32
     can resolve (F6: a significant point where the derivative moves past
     the threshold within one ulp of the inputs is witnessed and listed),
     ms a call; then
     aerobulk_model over 24 records of phase 4 with numpy inputs, bitwise
     equal to run_series(backend="eager"), its registry empty after the
     last; then implicit_coupling.main(days=8) on the card;
 23. host_surfaces — (a) the CLI's main path: 24 hourly records of phase
     4's forcing in an .npz (fp32, read as float64) through
     ``cli.main(["series", ..., "--skin", "--backend", "fused"])`` for
     COARE 3.6 and ECMWF, which must launch kernel 1 24 times and write
     columns bitwise equal to run_series(backend="fused") on the same
     float64 tensors; with ``--chunk 8`` (the streamed feed), 24 launches
     and the resident run's columns at rtol 1e-12; ``--backend eager``'s
     columns, and the whole grid of the fused series against the eager
     one, at the fp64 gate; each run's stage seconds (read, put, series,
     write) from ``profiling.Profiler``; (b) ``Profiler.device_trace``
     around one record, whose trace must name kernel 1's function; (c)
     ``capi.model_buffers`` from numpy buffers over the 24 records at
     1,038,240 points (COARE 3.6 + skin), bitwise equal to the eager
     series with isecday_utc=12, its registry empty after jt == Nt; (d)
     the C++ binding (``cpp_torch``) built with g++ and run on the card,
     printing the golden lines (or one ``skipped`` line naming what the
     machine lacks); (e) toy, cx-vs-wind, coef-n10 and psi-stab on the
     card against the CPU (the table equal, the files at rtol 1e-10 with
     atol 1e-10 of each array's largest magnitude), and
     three days of ``validation.run_idealized`` for the five algorithms on the
     card, within 1e-10 of the CPU's runs and accepted by their bands.
 24. sharded — multiple devices at 721x1440, fp32, 24 records, the ranks
     processes of ``aerobulk_tpu_torch.distributed_worker`` (kernels built
     here first): one direct call of kernels 1 and 2 on an empty block (no
     launch); then two ranks sharing the card over gloo on a (2, 1) mesh
     (rows 361 / 360), each reading only its slab of the forcing files:
     ``sharding.sharded_run_series(backend="fused")`` for COARE 3.6 and
     ECMWF + skin (24 launches of kernel 1 a rank), its value+grad (24
     launches of kernel 2 a rank), the sharded streamed feed
     (``run_series_pipelined(chunk=8, sharding=...)``, wires f32 and i16,
     phase 19's records) and a DCP checkpoint after 12 records resumed on
     (2, 1); outputs, states and gradients gathered from the ranks bitwise
     equal to one process on the whole grid, the feed within phase 19's
     gates; then one rank over NCCL on (1, 1): bitwise
     ``run_series(backend="fused")`` (24 launches an algorithm), and the
     checkpoint resumed bitwise; seconds per rank beside the single
     process (two ranks time-slicing one card, not a scaling figure).
 25. bench — ``cli.main(["bench", ...])`` (``aerobulk_tpu_torch.bench``)
     on the card with parity on: the headline, ``--all`` (six rows, kernels
     3, 1, 1, 5, 4), ``--grad`` (kernels 1 and 2, and the plain variants),
     ``--bf16`` (eager, no kernel) and ``--streamed`` (f32); every line must
     carry its checks true (parity_ok, the gradient and streamed checks),
     the launches of its row a run (which the bench checks over its timed
     runs) and this card's name and power limit; kernels 1-5's counters over
     the phase must cover every row's timed runs.

Every phase's line carries ``phase_seconds``, the seconds since its phase
began; a ``total`` line gives the whole run's seconds.  Then a
``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}`` line.  Any failure raises: no ok line and a non-zero exit.  Without a GPU
it exits non-zero before doing anything.
"""

import contextlib
import functools
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

import aerobulk_tpu_torch as abt
from aerobulk_tpu_torch import (capi, cli, cxx, measure, profiling, roofline,
                                validation)
from aerobulk_tpu_torch import distributed_worker as dw
from aerobulk_tpu_torch import io as tio
from aerobulk_tpu_torch import pipeline as tpipe
from aerobulk_tpu_torch.bench import (CHUNK, LINK_BYTES, NREC,
                                      STREAMED_FIELDS, STREAMED_GATES,
                                      launch_counts, link_gbps,
                                      resident_reference, source_s,
                                      staging_s)
from aerobulk_tpu_torch.ice import ICE_ALGOS as ICE_REGISTRY
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as kfused
from aerobulk_tpu_torch.kernels import roofline as kchain
from aerobulk_tpu_torch.skin import (HWL_MAX, RD0_ECMWF, load_skin_state,
                                     save_skin_state)

NY, NX = 721, 1440
NITER = 5
NT = 24
FIELDS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s",
          "dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
# gates of docs/PARITY.md "The fp32 tail": the median relative difference
# and the fraction of points whose error exceeds 10% of the field's median
# magnitude
GATES = {torch.float64: (1e-10, 0.0), torch.float32: (2e-4, 1e-4)}
GRADS = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw", "rad_lw",
         "lon", "dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
# the stateless path: a 30-day month of hourly records on the 1-degree grid
NT_MONTH, NY1, NX1 = 720, 181, 360
BUOY_RECORDS = 8760
ALGOS = ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas")
BULK_FIELDS = FIELDS[:6]
BULK_INPUTS = measure.BULK_INPUTS

# Bounds: the least time the card could take, the larger of operations over
# the peak rate and bytes (each input read once, each output written once)
# over the memory rate.  NVIDIA's data sheet for the H100 SXM at 700 W:
# 67 TFLOP/s fp32 and 34 TFLOP/s fp64 outside the tensor cores, 3.35 TB/s.
PEAK_OPS = {torch.float32: 67e12, torch.float64: 34e12}
HBM_BYTES_PER_S = 3.35e12
# operations per point of each step with niter=5: the totals of
# roofline.CENSUS, the census of the JAX graph (held equal to
# aerobulk_tpu/roofline.py by tests/test_torch_kernels.py); a gradient
# kernel's work is the census of jax.vjp of its step ("grad_skin_<algo>")
OPS_PER_POINT = {k: sum(c.values()) for k, c in roofline.CENSUS.items()}
# the bound the forward-mode design of kernel 2 was held to (13 tangents
# beside each value of the forward step, one operation each), reported
# beside the VJP's own bound
FORWARD_MODE_FACTOR = 1 + 13
# the data sheet's FMA rates (half its FLOP rates): a cheap-class reading
# above them means the chain was folded
FMA_PER_S = {torch.float32: PEAK_OPS[torch.float32] / 2,
             torch.float64: PEAK_OPS[torch.float64] / 2}
EASY_KW = {"CdN": 1.6e-3, "ChN": 1.5e-3, "CeN": 1.5e-3}
# significant points that are not reference blow-ups listed per field
SIG_LISTED = 20
# the mixed cells timed in phase 13: LG15 ice with each ocean algorithm,
# and LG15_IO
TIMED_MIXED = ([("ice_lg15", o, False) for o in ALGOS]
               + [("ice_lg15", "ecmwf", True)])
# the steps of phase 13 on the main path of config 5 (census keys)
MAIN_ICE_STEPS = ("ice_lg15", "mixed_ice_lg15_ecmwf", "mixed_lg15_io")
# phase 19, the streamed feed (bench.py --streamed's workload, its records
# per run and per chunk): the runs as (algorithm, wire, collect_wire,
# chunk, records)
STREAMED_RUNS = (("coare3p6", "f32", "f32", CHUNK, NREC),
                 ("coare3p6", "i16", "f32", CHUNK, NREC),
                 ("coare3p6", "i8d", "f32", CHUNK, NREC),
                 ("coare3p6", "f32", "i16", CHUNK, NREC),
                 ("ecmwf", "f32", "f32", CHUNK, NREC),
                 ("coare3p6", "f32", "f32", None, NT))

# phase 20, long runs: the reference's month and year of hourly records
# (tests/test_long_series.py), its asserted fp32 drift budgets over the
# month (:205-210), the size of a QL or QH drift it calls a regime flip,
# and the flips listed
NT_LONG, NT_YEAR = 720, 8760
MONTH_BUDGET = {"Qnt_ac_final": 4e3, "Tau_ac_final": 0.1,
                "dT_wl_final": 1e-5, "dT_wl_over_run": 1e-4,
                "QL_over_run": 0.5, "QH_over_run": 0.5}
FLIP_WM2 = 0.5
FLIPS_LISTED = 5
# 20(c)'s gate in a record where fp32 itself leaves 1e-4: kernel 1 fp32
# may show at most this multiple of the eager fp32 port's significant
# fraction against the same fp64 run, and never more than the ceiling
# (tests/test_torch_fp32_flips.py asserts it of the JAX package's fp32)
FP32_SELF_MULT, FP32_SIG_CEILING = 2.0, 1e-2
# phases 6 and 16, kernel 2's fp32 gradient against the fp64 gradient at
# the same fp32 inputs (F8, ROADMAP.md section 3): the worst points of each
# algorithm listed
GRAD_LISTED = 5
# phase 21, the validity envelope (tests/test_fuzz_robustness.py): the
# iterations of its ocean and ice runs, and the points listed per field
ENVELOPE_NITER, ICE_ENVELOPE_NITER = 10, 8
ENVELOPE_LISTED = 5
# phase 22, the linearizations: the outputs checked, the finite-difference
# step of each input field (small enough to resolve the solve's narrowest
# smooth features, large against fp64 rounding), the agreement of the
# central differences with steps h and h/2 and of the one-sided slopes
# over h/2 within which a point counts as smooth, and the gate of the fp64
# derivative there
LIN_OUTPUTS = ("QL", "QH", "Tau", "Evap", "T_s")
LIN_STEPS = {"sst": 1e-5, "t_zt": 1e-5, "hum_zt": 1e-8, "U_zu": 1e-5,
             "V_zu": 1e-5, "slp": 1e-2, "rad_sw": 1e-4, "rad_lw": 1e-4,
             "Ts_i": 1e-5}
FD_AGREE, FD_KINK, FD_RTOL = 1e-4, 1e-3, 1e-3
# the inputs of flux_step_ice_linearized by name
ICE_LIN_INPUTS = ("Ts_i", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "frice")
# phase 23, the host surfaces: the forcing file's variable names (the names
# io.read_forcing maps to the CLI's), the C API's outputs, the lines the
# C++ example must print (tests/test_capi.py's) and the CLI's table tools
# held on the card against the CPU
FILE_NAMES = {"sst": "sst", "t_zt": "t_air", "hum_zt": "q_air",
              "U_zu": "u10", "V_zu": "v10", "slp": "msl", "rad_sw": "ssrd",
              "rad_lw": "strd"}
CAPI_OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
CXX_GOLDEN = ("-15.15530", "-81.38902", "interleaved series_id OK")
HOST_TOOLS = ("cx-vs-wind", "coef-n10", "psi-stab")
# the days of hourly records of validation.run_idealized's runs
VALIDATION_DAYS = 3


#: when the run started, the phase of the last line and when it began, and
#: when the last line was printed
_CLOCK = {"start": time.perf_counter(), "phase": None, "began": None,
          "last": None}


def emit(obj):
    """Print one JSON line; a phase's line gets ``phase_seconds``, the
    seconds since its phase began (a phase begins when the line before its
    first is printed)."""
    if "phase" in obj:
        now = time.perf_counter()
        if obj["phase"] != _CLOCK["phase"]:
            _CLOCK["phase"] = obj["phase"]
            _CLOCK["began"] = _CLOCK["last"] or _CLOCK["start"]
        obj = {**obj, "phase_seconds": now - _CLOCK["began"]}
        _CLOCK["last"] = now
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def make_inputs(device, dtype):
    """The forcing of bench.py (seed 42, same distributions, same order)."""
    return measure.grid_forcing((NY, NX), device, dtype)


def series_forcing(device):
    """24 hourly fp32 records of phase 3's forcing: the solar forcing
    follows each point's local day (so the warm layer builds and resets)
    and the wind varies by 10% over the day (``distributed_worker.
    series_forcing``, which phase 24's ranks apply to their slabs).
    Returns (forcing, lon)."""
    return dw.series_forcing(make_inputs(device, torch.float32), NT)


def grad_parity(got, ref, names, dtype, yard=None, witness=None, gate=True,
                listed=0):
    """Compare gradients; raise unless each passes the gate of ``dtype``.

    fp64 (tests/test_grad.py's bar for two backward schedules of one
    computation): every point within rtol 1e-5 and atol 1e-10 * max|ref|,
    median relative difference <= 1e-10.  fp32 (bench.py's on-device
    gradient gate): relative difference against max(|ref|, 1e-3 *
    median|ref|), median < 1e-3 and p99 < 5e-2.  Both: every value finite
    and the NaN masks identical.  A gradient that is 0 everywhere in the
    reference (lon reaches the step only through trunc and comparisons)
    must be 0 everywhere in the kernel's.  With ``yard``, the fp64
    gradient at the same fp32 inputs, each gradient's fields also hold
    :func:`grad_tail`'s (``witness``, ``gate``, ``listed`` are its), and
    the result its ``listed`` worst points under ``worst_points``."""
    report, worst = {}, 0.0
    for name, a, b in zip(names, got, ref):
        a = a.double().cpu().numpy().ravel()
        b = b.double().cpu().numpy().ravel()
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            fail(f"grad {name}: kernel and plain NaN masks differ")
        if not (np.isfinite(a).all() and np.isfinite(b).all()):
            fail(f"grad {name}: non-finite values")
        d = np.abs(a - b)
        worst = max(worst, float(d.max()))
        med = float(np.median(np.abs(b)))
        if not np.any(b):
            if np.any(a):
                fail(f"grad {name}: the reference is 0, the kernel is not")
            report[name] = {"zero": True}
            continue
        rel = d / np.maximum(np.abs(b), 1e-3 * med) if med > 0 else \
            d / np.abs(b).max()
        r = {"median_rel": float(np.median(rel)),
             "p99_rel": float(np.percentile(rel, 99)),
             "max_rel": float(rel.max()), "max_abs": float(d.max()),
             "scale": float(np.abs(b).max())}
        if dtype == torch.float64:
            r["outside_rtol"] = int(np.sum(d > 1e-10 * r["scale"]
                                           + 1e-5 * np.abs(b)))
            ok = r["outside_rtol"] == 0 and r["median_rel"] <= 1e-10
        else:
            ok = r["median_rel"] < 1e-3 and r["p99_rel"] < 5e-2
        if not ok:
            fail(f"{dtype} grad {name} outside the gate: {json.dumps(r)}")
        report[name] = r
    res = {"max_abs_err": worst, "fields": report}
    if yard is not None:
        tail, res["worst_points"] = grad_tail(got, ref, yard, names, witness,
                                              gate, listed)
        for name, r in tail.items():
            report[name].update(r)
    return res


def grad_tail(got, plain, yard, names, witness=None, gate=True, listed=0):
    """Kernel 2's fp32 gradients ``got`` and the plain fp32 VJP's ``plain``
    against ``yard``, the fp64 gradient at the same fp32 inputs, by the
    gradient's significance rule (``measure.grad_sig``; ROADMAP.md section
    3, F8), for each gradient that is not 0 everywhere in ``yard``:
    ``sig_frac`` and ``plain_sig_frac``, the largest relative and absolute
    errors of both, and with ``witness(kind, idx)`` (``kind`` "kernel" or
    "plain"; :func:`lin_witness` of the VJP, :func:`vjp_at`) the fraction
    of the points significant and not witnessed (:func:`fp32_check`) of
    both.  ``gate``: per gradient, ``sig_frac`` at most 1e-4, or at most
    twice ``plain_sig_frac`` and 1e-2 (``measure.grad_sig_ok``, F5's form),
    and ``unwitnessed_sig_frac`` at most 1e-4 or twice the plain VJP's.
    Returns (the fields by gradient, the ``listed`` points of the largest
    relative error of ``got`` over the gradients: [(that error, flat index,
    the gradients significant there, whether the point is witnessed)])."""
    as_ns = lambda gs: types.SimpleNamespace(**dict(zip(names, gs)))
    live = [n for n, y in zip(names, yard) if bool(torch.any(y != 0))]
    k, p, y = as_ns(got), as_ns(plain), as_ns(yard)
    sigs, score, top = {}, None, None
    for n in live if listed else ():
        sigs[n], thr, _ = measure.grad_sig(getattr(k, n), getattr(y, n))
        err = torch.nan_to_num((getattr(k, n).double().reshape(-1)
                                - getattr(y, n).double().reshape(-1)).abs()
                               / (10.0 * thr), nan=float("inf"))
        score = err if score is None else torch.maximum(score, err)
    if listed:
        top = torch.topk(score, listed)
    verdicts = dict.fromkeys(top.indices.tolist() if listed else ())
    rp = fp32_check("the plain VJP", p, y, functools.partial(
        witness, "plain") if witness else None, live, "grad", {})
    allowed = {n: max(measure.GRAD_SIG_ALONE, measure.GRAD_SIG_MULT
                      * rp[n]["unwitnessed_sig_frac"])
               for n in live} if gate else {}
    rk = fp32_check("kernel 2", k, y, functools.partial(witness, "kernel")
                    if witness else None, live, "grad", allowed, verdicts)
    fields = {}
    for n in live:
        r = {"sig_frac": rk[n]["sig_frac"],
             "plain_sig_frac": rp[n]["sig_frac"],
             "sig_points": rk[n]["sig_points"],
             "plain_sig_points": rp[n]["sig_points"],
             "max_rel_vs_fp64": rk[n]["max_rel"],
             "max_abs_vs_fp64": rk[n]["max_abs"],
             "plain_max_rel_vs_fp64": rp[n]["max_rel"],
             "plain_max_abs_vs_fp64": rp[n]["max_abs"]}
        if witness:
            r.update({"unwitnessed_sig_frac": rk[n]["unwitnessed_sig_frac"],
                      "plain_unwitnessed_sig_frac":
                          rp[n]["unwitnessed_sig_frac"],
                      "witnessed_sig_points": rk[n]["witnessed_sig_points"],
                      "unwitnessed_first_flat":
                          rk[n]["unwitnessed_first_flat"]})
        if gate and not measure.grad_sig_ok(r["sig_frac"],
                                            r["plain_sig_frac"]):
            fail(f"fp32 grad {n}: significant against fp64 outside the gate "
                 f"(1e-4, or twice the plain VJP's and 1e-2): "
                 f"{json.dumps(r)}")
        fields[n] = r
    worst = [] if not listed else [
        (float(e), j, [n for n in live if bool(sigs[n][j])], verdicts[j])
        for e, j in zip(top.values.tolist(), top.indices.tolist())]
    return fields, worst


#: the names of the gradient kernel's 10 cotangents, by output
COTANGENTS = tuple(f"ct_{f}" for f in FIELDS)


def vjp_at(cfg, isd, kernel):
    """The VJP of one step as a function of its 13 inputs (GRADS) and 10
    cotangents (COTANGENTS) by name, returning the 13 gradients by name:
    kernel 2 in fp32 where ``kernel``, else (and in fp64 always) autograd
    of the plain step, the function of the fp64 yardstick."""
    def vjp(g):
        ins, cts = [g[n] for n in GRADS], [g[n] for n in COTANGENTS]
        if kernel and ins[0].dtype == torch.float32:
            out = kfused.fused_flux_step_grad(cfg, ins, cts, isd)
        else:
            out = kfused.fused_flux_step_vjp_plain(
                cfg, ins[:9], abt.SkinState(*ins[9:]), cts, isd)
        return types.SimpleNamespace(**dict(zip(GRADS, out)))
    return vjp


def cotangents(shape, dtype, device, seed):
    """10 fields of standard normals from a seeded generator on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float64).to(dtype) for _ in range(10)]


def bound(ops_per_point, fields, points, dtype):
    """``(bound_ms, bound_by)`` of a kernel over ``points`` that reads and
    writes ``fields`` fields of ``dtype`` and does ``ops_per_point``."""
    ops_ms = 1e3 * ops_per_point * points / PEAK_OPS[dtype]
    bytes_ms = 1e3 * fields * points * dtype.itemsize / HBM_BYTES_PER_S
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def month_forcing(device, dtype, nt=NT_MONTH, shape=(NY1, NX1), seed=7):
    """The forcing of bench.py::_mk_inputs (seed 7, same distributions,
    same order) over ``nt`` records of ``shape``."""
    return measure.month_forcing((nt, *shape), device, dtype, seed)


median = measure.median


def diff_stats(a, b, nonfinite="fail", what="", rule="field"):
    """One field of ``a`` against the reference ``b`` (any shape), in fp64
    on the card, by the significance rule of the fp32 gate
    (``measure.field_scale``): a point is significant where the difference
    exceeds 10% of the median magnitude of ``b`` over its nonzero points,
    or 1e-6 in a field that is zero everywhere.  ``rule="grad"`` takes a
    gradient's rule instead (``measure.grad_sig``: 10% of max(|b|, that
    median), with ``nonfinite="significant"``).  ``nonfinite="fail"``
    raises unless the NaN masks are identical; ``"significant"`` counts a
    point where ``a`` is not finite and ``b`` is as significant.  Returns
    a dict of flat tensors over every point (``d`` the difference, 0 where
    not compared; ``keep`` the points compared; ``lost`` those where only
    ``a`` is not finite; ``sig``; ``rel`` the relative difference against
    max(|b|, 1e-3 of the median), or under the gradient's rule against
    max(|b|, the median), over ``keep``, the difference itself in a zero
    field) and floats (``med``, ``thr`` (under the gradient's rule a flat
    tensor, per point), ``sig_frac`` over the points where ``b`` is not
    NaN)."""
    a, b = a.double().reshape(-1), b.double().reshape(-1)
    if nonfinite == "fail":
        if not torch.equal(torch.isnan(a), torch.isnan(b)):
            fail(f"{what}: kernel and plain NaN masks differ")
        keep, lost = ~torch.isnan(b), torch.zeros_like(b, dtype=torch.bool)
    else:
        keep = torch.isfinite(a) & torch.isfinite(b)
        lost = torch.isfinite(b) & ~torch.isfinite(a)
    d = torch.where(keep, a - b, 0.0).abs()
    bk = b[keep]
    if rule == "grad":
        sig, thr, med = measure.grad_sig(a, b)
        zero_field = med == 0.0
        rel = d[keep] if zero_field else d[keep] / (10.0 * thr[keep])
    else:
        med, thr, zero_field = measure.field_scale(bk)
        sig = (d > thr) | lost
        rel = d[keep] if zero_field else \
            d[keep] / torch.clamp(bk.abs(), min=1e-3 * med)
    return {"d": d, "keep": keep, "lost": lost, "sig": sig, "rel": rel,
            "med": med, "thr": thr, "zero_field": zero_field,
            "sig_frac": float(sig.sum()) / max(int((keep | lost).sum()), 1)}


def fields_stats(a, b, what, med=None):
    """:func:`diff_stats` of every field at once, with the statistics
    phase 20(c) keeps: ``a`` and ``b`` are (fields, points) fp64 tensors on
    the card, ``med`` the reference's per-field scale where another pair
    already took it.  The same numbers as diff_stats and its callers'
    reductions (the medians of a sort that puts the points left out after
    the rest, the 99.99th percentile of a topk), in a few launches and
    three host reads.  Returns ({"sig_frac", "max_abs", "p9999_abs",
    "median_rel": one float per field}, med)."""
    if not torch.equal(torch.isnan(a), torch.isnan(b)):
        fail(f"{what}: kernel and plain NaN masks differ")
    keep = ~torch.isnan(b)
    d = torch.where(keep, a - b, 0.0).abs()
    rows = torch.arange(b.shape[0], device=b.device)[:, None]

    def middle(values, n):
        """numpy's median of the first ``n`` of each sorted row."""
        s = torch.sort(values, dim=1).values
        lo = torch.clamp((n - 1) // 2, min=0)[:, None]
        return ((s[rows, lo] + s[rows, (n // 2)[:, None]]) / 2)[:, 0]

    inf = torch.tensor(float("inf"), dtype=b.dtype, device=b.device)
    if med is None:
        nonzero = keep & (b != 0)
        med = torch.where(nonzero.sum(1) > 0, middle(
            torch.where(nonzero, b.abs(), inf), nonzero.sum(1)), 0.0)
    zero_field = med < 1e-20
    thr = torch.where(zero_field, 1e-6, 0.1 * med)
    m = keep.sum(1)
    sig_frac = (d > thr[:, None]).sum(1).double() / torch.clamp(m, min=1)
    rel = torch.where(zero_field[:, None], d,
                      d / torch.maximum(b.abs(), (1e-3 * med)[:, None]))
    median_rel = middle(torch.where(keep, rel, inf), m)
    kept = torch.where(keep, d, -inf)
    counts = m.tolist()
    ks = [n - int(0.9999 * n) for n in counts]
    top = torch.topk(kept, max(ks), dim=1).values
    p9999 = top[rows[:, 0], torch.tensor(ks, device=b.device) - 1]
    out = torch.stack([sig_frac, kept.max(1).values, p9999,
                       median_rel]).tolist()
    return dict(zip(("sig_frac", "max_abs", "p9999_abs", "median_rel"),
                    out)), med


def parity(got, ref, dtype, names=FIELDS, gate=None):
    """Compare the fields ``names`` that ``got`` holds (by default the
    step's 10, or the first 6: the stateless outputs), in fp64 on the card
    (:func:`diff_stats`); raise unless they pass ``gate`` (median relative
    difference, fraction of significant points), by default the gate of
    ``dtype``."""
    rels, report = [], {}
    for name, a, b in zip(names, got, ref):
        shape = tuple(b.shape)
        s = diff_stats(a, b, what=name)
        if not s["zero_field"]:
            rels.append(s["rel"])
        a, b = a.double().reshape(-1), b.double().reshape(-1)
        sig_pts, med = s["sig"], s["med"]
        # significant points where the plain value itself exceeds 100 times
        # the field's median magnitude (where the solve itself blew up)
        big = s["keep"] & (b.abs() > 100.0 * med)
        sig_big = int((sig_pts & big).sum())
        report[name] = {"median_rel": median(s["rel"]),
                        "max_abs": float(s["d"].max()),
                        "sig_frac": s["sig_frac"],
                        "sig_points": int(sig_pts.sum()),
                        "sig_points_plain_over_100x_median": sig_big,
                        "scale": med}
        if report[name]["sig_points"]:
            # the first two significant points, as indices into the field,
            # with the kernel's and the plain value there
            first = torch.nonzero(sig_pts).reshape(-1)[:2]
            report[name]["sig_first_points"] = [
                [int(i) for i in np.unravel_index(int(j), shape)]
                for j in first]
            report[name]["sig_first_kernel_plain"] = [
                [float(a[j]), float(b[j])] for j in first]
            # the first SIG_LISTED significant points that are not blow-ups,
            # as flat indices into the field
            report[name]["sig_not_blow_up_flat"] = [
                int(j) for j in torch.nonzero(sig_pts & ~big).reshape(-1)[
                    :SIG_LISTED]]
        del a, b, s, sig_pts, big
    median_rel = median(torch.cat(rels))
    worst_sig = max(r["sig_frac"] for r in report.values())
    max_med, max_sig = GATES[dtype] if gate is None else gate
    res = {"median_rel": median_rel, "worst_sig_frac": worst_sig,
           "max_abs_err": max(r["max_abs"] for r in report.values()),
           "gate": {"median_rel": max_med, "sig_frac": max_sig},
           "fields": report}
    if not (median_rel <= max_med and worst_sig <= max_sig):
        fail(f"{dtype} parity outside the gate: {json.dumps(res)}")
    return res


def ncar_f3(dev, point, vals):
    """NCAR at one point of the month with inputs ``vals`` (sst, t_zt,
    hum_zt, U_zu, V_zu, slp; fp64), stepped three ways on the card: the
    fp32 kernel, the fp32 plain version and fp64.  For the two eager ways,
    the first guess's stab and zeta_u = zu / L after each of the 5
    iterations (turb_ncar with niter = 1..5); for all three, QH of the
    step at each niter.  The kernel's own zeta is not an output: where its
    QH(niter) departs from the plain version's by the factor of the
    switched neutral Stanton number (32.7 / 18), its stab differs there."""
    from aerobulk_tpu_torch import thermo
    from aerobulk_tpu_torch.algos.ncar import turb_ncar
    out = {"point": point, "inputs": dict(zip(BULK_INPUTS, vals))}
    qh = {}
    for way, dtype in (("fp32_plain", torch.float32),
                       ("fp64", torch.float64)):
        sst, t, q, u, v, slp = (torch.tensor([x], dtype=dtype, device=dev)
                                for x in vals)
        wnd = torch.sqrt(u * u + v * v)
        ssq = 0.98 * thermo.q_sat(sst, slp)
        theta = thermo.theta_from_z_p0_t_q(2.0, slp, t, q)
        zeta = [float(10.0 / turb_ncar(2.0, 10.0, sst, theta, ssq, q, wnd,
                                       niter=k).L) for k in range(1, 6)]
        stab0 = thermo.step(thermo.virt_temp(theta, q)
                            - thermo.virt_temp(sst, ssq))
        for name, step in (("fp32_kernel", kfused.fused_bulk_step),
                           (way, kfused.fused_bulk_step_plain)):
            if name == "fp32_kernel" and dtype != torch.float32:
                continue
            qh[name] = [float(step(abt.AeroBulkConfig(
                algo="ncar", zt=2.0, zu=10.0, niter=k), sst, t, q, u, v,
                slp)[1]) for k in range(1, 6)]
        out[way] = {"stab0": float(stab0), "zeta_by_iteration": zeta,
                    "zeta_sign_by_iteration": [int(np.sign(z)) for z in zeta],
                    "QH_by_niter": qh[way]}
    out["fp32_kernel"] = {"QH_by_niter": qh["fp32_kernel"],
                          "same_regime_as_fp32_plain_by_niter": [
                              abs(a / b - 1.0) < 0.2 for a, b in
                              zip(qh["fp32_kernel"], qh["fp32_plain"])],
                          "same_regime_as_fp64_by_niter": [
                              abs(a / b - 1.0) < 0.2 for a, b in
                              zip(qh["fp32_kernel"], qh["fp64"])]}
    return out


def cold_forcing(device, dtype):
    """BASELINE config 5's cold forcing on the 0.25-degree grid (bench.py's,
    seed 42): (Ts_i, sst, t, q, u, v, slp, frice)."""
    return measure.cold_forcing((NY, NX), device, dtype)


def ice_call(step, algo, f):
    """``step`` (fused_ice_step or its plain version) of ``algo`` on the
    cold forcing ``f`` (an algorithm without needs_frice ignores frice);
    ice_easy with the non-default EASY_KW."""
    Ts_i, _, t, q, u, v, slp, frice = f
    kw = EASY_KW if algo == "ice_easy" else {}
    return step(algo, 2.0, 10.0, Ts_i, t, q, u, v, slp, frice=frice,
                niter=NITER, **kw)


def mixed_call(step, f, **kw):
    """``step`` (fused_mixed_step or its plain version) on the cold forcing
    ``f``: BASELINE config 5 unless ``kw`` picks other algorithms."""
    return step(2.0, 10.0, *f, niter=NITER, **kw)


def sig_point_lines(res, names, got, ref, f64, step):
    """For each fp32 significant point of the parity result ``res`` that is
    not a reference blow-up: its index, its inputs (the fp64 forcing
    ``f64``), the fields where it is significant, and every field's value
    from the fp32 kernel (``got``), the fp32 plain version (``ref``) and
    ``step`` (the plain version) on the fp64 inputs at that point."""
    shape = tuple(got[0].shape)
    flat = {}
    for name in names:
        for j in res["fields"][name].get("sig_not_blow_up_flat", []):
            flat.setdefault(j, []).append(name)
    lines = []
    for j, fields in flat.items():
        pt = [x.reshape(-1)[j:j + 1] for x in f64]
        lines.append({
            "index": [int(i) for i in np.unravel_index(j, shape)],
            "significant_in": fields,
            "inputs": [float(x) for x in pt],
            "fp32_kernel": {n: float(g.reshape(-1)[j])
                            for n, g in zip(names, got)},
            "fp32_plain": {n: float(r.reshape(-1)[j])
                           for n, r in zip(names, ref)},
            "fp64": {n: float(v) for n, v in zip(names, step(pt))}})
    return lines


cuda_ms = measure.cuda_ms


def vjp_plain_chunked(cfg, args, state, cts, isd, chunks=2):
    """fused_flux_step_vjp_plain over blocks of rows: the step is pointwise,
    so the blocks give the same gradients in a fraction of autograd's
    memory."""
    parts = []
    for rows in torch.arange(args[0].shape[0]).chunk(chunks):
        sl = slice(int(rows[0]), int(rows[-1]) + 1)
        parts.append(kfused.fused_flux_step_vjp_plain(
            cfg, [a[sl] for a in args], abt.SkinState(*(x[sl] for x in state)),
            [c[sl] for c in cts], isd))
    return [torch.cat(g) for g in zip(*parts)]


def grad_step_check(phase, cfg, args, st, cts, isd, sname):
    """Phases 6 and 16 at one state: kernel 2 against autograd of the plain
    step (:func:`vjp_plain_chunked`) on ``args`` (the 9 forcing fields),
    the state ``st`` and the cotangents ``cts``, at :func:`grad_parity`'s
    gate of their dtype; in fp32 also both against the fp64 yardstick, the
    plain step's autograd at the same fp32 inputs, state and cotangents
    upcast (``x.double()``: the inputs' own rounding is not error), by
    :func:`grad_tail`, its significant points witnessed
    (:func:`lin_witness` of :func:`vjp_at`, each forcing field nudged
    alone, the state and cotangents held: a fresh state's exact ties would
    witness any point).  The plain step, not kernel 2's fp64 build, is the
    yardstick, so that no fault the kernel's two builds share can hide in
    it.  Emits the line and returns the result, whose ``worst_points``
    carry what :func:`worst_grad_points` steps."""
    dtype = args[0].dtype
    g = kfused.fused_flux_step_grad(cfg, (*args, *st), cts, isd)
    ref = vjp_plain_chunked(cfg, args, st, cts, isd)
    kw = {}
    if dtype == torch.float32:
        kw["yard"] = vjp_plain_chunked(
            cfg, [a.double() for a in args],
            abt.SkinState(*(x.double() for x in st)),
            [c.double() for c in cts], isd)
        forcing = dict(zip(GRADS[:9], args))
        held = {**dict(zip(GRADS[9:], st)), **dict(zip(COTANGENTS, cts))}
        kw["witness"] = lambda kind, idx: lin_witness(
            vjp_at(cfg, isd, kind == "kernel"), forcing, idx, GRADS, held,
            each=True)
        kw["listed"] = GRAD_LISTED
    torch.cuda.synchronize()
    res = grad_parity(g, ref, GRADS, dtype, **kw)
    worst = res.pop("worst_points", [])
    emit({"phase": phase, "dtype": str(dtype), "state": sname, **res})
    if worst:
        ins = (*args, *st)
        res["worst_points"] = [
            {"state": sname, "max_rel_vs_fp64": e, "flat": j,
             "significant_in": sig, "witnessed": w,
             "inputs": {n: float(x.reshape(-1)[j])
                        for n, x in zip(GRADS, ins)},
             "grad": {way: {n: float(x.reshape(-1)[j])
                            for n, x in zip(GRADS, gs)}
                      for way, gs in (("fp32_kernel", g),
                                      ("fp32_plain", ref),
                                      ("fp64", kw["yard"]))}}
            for e, j, sig, w in worst]
    return res


def worst_grad_points(cfg, isd, gpar, dev):
    """The GRAD_LISTED points of the largest fp32 gradient error against
    fp64 over both states of ``gpar`` (:func:`grad_step_check`'s results),
    stepped as :func:`ncar_f3` steps NCAR's: each with its inputs, 1/L and
    u* of the plain step at them in fp32 and in fp64 (the fp32 inputs
    upcast), the 13 gradients of kernel 2 in fp32, the plain VJP in fp32
    and fp64, and whether the point is witnessed (None where it is not
    significant in any gradient)."""
    points = sorted((p for (dt, _), r in gpar.items()
                     if dt == torch.float32
                     for p in r.pop("worst_points", [])),
                    key=lambda p: -p["max_rel_vs_fp64"])[:GRAD_LISTED]
    for p in points:
        x = p["inputs"]
        p["index"] = [int(i) for i in np.unravel_index(p.pop("flat"),
                                                       (NY, NX))]
        for way, dtype in (("fp32", torch.float32), ("fp64", torch.float64)):
            v = {n: torch.tensor([x[n]], dtype=torch.float32).to(
                dtype).to(dev) for n in GRADS}
            out, _ = abt.flux_step(
                cfg, *(v[n] for n in GRADS[:6]), rad_sw=v["rad_sw"],
                rad_lw=v["rad_lw"], lon=v["lon"], isecday_utc=isd,
                skin_state=abt.SkinState(*(v[n] for n in GRADS[9:])))
            p.setdefault("one_on_L", {})[way] = float(1.0 / out.diag.L)
            p.setdefault("u_star", {})[way] = float(out.diag.u_star)
    return points


def ecmwf_phases(dev, card, coare_cfg):
    """Phases 14-17: BASELINE config 4, ECMWF + cool skin + warm layer
    through kernels 1 and 2 (fused_step_ecmwf.cu, fused_grad_ecmwf.cu) on
    the forcing of phases 3-8.  Returns what the kernels line and the
    roofline phase read."""
    cfg = abt.AeroBulkConfig(algo="ecmwf", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    isd0 = 43200
    out = {"par": {}, "gpar": {}, "times": {}}

    # --- 14. kernel vs plain, one step, fp64 and fp32; config 4's own
    # cross-check against COARE 3.6 (information, not a gate)
    for dtype in (torch.float64, torch.float32):
        args = make_inputs(dev, dtype)
        state = abt.init_skin_state(cfg, (NY, NX), dtype, dev)
        if not bool((state.Hz_wl == RD0_ECMWF).all()):
            fail("a fresh ECMWF state does not hold Hz_wl = 3 m")
        kw = dict(lon=args[8], isecday_utc=isd0, skin_state=state)
        outs, st = kfused.fused_flux_step(cfg, *args[:8], **kw)
        pouts, pst = kfused.fused_flux_step_plain(cfg, *args[:8], **kw)
        torch.cuda.synchronize()
        out["par"][dtype] = parity((*outs, *st), (*pouts, *pst), dtype)
        rec = {"phase": "ecmwf_parity", "dtype": str(dtype),
               **out["par"][dtype]}
        if dtype == torch.float64:
            coare, _ = kfused.fused_flux_step(
                coare_cfg, *args[:8], lon=args[8], isecday_utc=isd0,
                skin_state=abt.init_skin_state(coare_cfg, (NY, NX), dtype,
                                               dev))
            rec["vs_coare3p6_median_abs"] = {
                name: median((a - b).abs())
                for name, a, b in zip(FIELDS[:6], outs, coare)}
            del coare
        emit(rec)
        del args, state, outs, st, pouts, pst

    # --- 15. the main path of config 4: 24 hourly records, fp32 -------------
    forcing, lon = series_forcing(dev)
    state0 = abt.init_skin_state(cfg, (NY, NX), torch.float32, dev)
    kfused.LAUNCHES = 0
    t0 = time.perf_counter()
    f_out, f_state = abt.run_series(cfg, forcing, skin_state=state0, lon=lon,
                                    backend="fused")
    torch.cuda.synchronize()
    series_s = time.perf_counter() - t0
    out["launches"] = kfused.LAUNCHES
    if out["launches"] != NT:
        fail(f"config 4's main path launched the kernel {out['launches']} "
             f"times, not {NT}")
    for fname, x in zip(FIELDS, (f_out.QL, f_out.QH, f_out.Tau_x, f_out.Tau_y,
                                 f_out.Evap, f_out.T_s, *f_state)):
        if not bool(torch.isfinite(x).all()):
            fail(f"config 4's main path: {fname} is not finite everywhere")
    max_dT = float(f_state.dT_wl.max())
    if not max_dT > 0:
        fail("config 4's main path: the warm layer never built")
    if not all(torch.equal(a, b) for a, b in zip(f_state[1:], state0[1:])):
        fail("config 4's main path: Hz_wl, Qnt_ac or Tau_ac changed")
    e_out, e_state = abt.run_series(cfg, forcing, skin_state=state0, lon=lon,
                                    backend="eager")
    torch.cuda.synchronize()
    last = lambda o: (o.QL[-1], o.QH[-1], o.Tau_x[-1], o.Tau_y[-1],
                      o.Evap[-1], o.T_s[-1])
    emit({"phase": "ecmwf_series", "records": NT,
          "launches": out["launches"], "seconds_fused_series": series_s,
          "max_dT_wl_fused_final": max_dT,
          "wl_built_points_fused_final": int((f_state.dT_wl > 0).sum()),
          "vs_eager": parity((*last(f_out), *f_state),
                             (*last(e_out), *e_state), torch.float32)})
    del f_out, e_out, e_state

    # --- 16. the gradient kernel vs autograd of the plain step (fp32 also
    # against fp64, its worst points stepped), then the value+grad series --
    for dtype in (torch.float64, torch.float32):
        args = make_inputs(dev, dtype)
        cts = cotangents((NY, NX), dtype, dev, seed=7)
        states = {"fresh": abt.init_skin_state(cfg, (NY, NX), dtype, dev),
                  "series_final": abt.SkinState(*(x.to(dtype)
                                                  for x in f_state))}
        if bool(states["fresh"].dT_wl.any()):
            fail("a fresh ECMWF state does not sit at the dT_wl == 0 tie")
        for sname, st in states.items():
            res = grad_step_check("ecmwf_grad_parity", cfg, args, st, cts,
                                  isd0, sname)
            if res["fields"]["lon"] != {"zero": True} or \
                    res["fields"]["Hz_wl"].get("zero"):
                fail("ECMWF gradient: lon's is not 0 everywhere or Hz_wl's "
                     "is")
            out["gpar"][(dtype, sname)] = res
        del args, cts, states, st
    for line in worst_grad_points(cfg, isd0, out["gpar"], dev):
        emit({"phase": "ecmwf_grad_parity", "part": "worst_point", **line})

    loss_of = lambda o: (o.QL + o.QH + o.Tau_x).sum()
    grads = {}
    for path, kw in (("fused", dict(backend="fused",
                                    fused_grad_backend="kernel")),
                     ("eager_remat", dict(backend="eager", remat=True))):
        sst_series = forcing["sst"].clone().requires_grad_()
        st0 = abt.SkinState(*(x.clone().requires_grad_() for x in state0))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kfused.GRAD_LAUNCHES = 0
        t0 = time.perf_counter()
        o, _ = abt.run_series(cfg, {**forcing, "sst": sst_series},
                              skin_state=st0, lon=lon, **kw)
        # Qnt_ac and Tau_ac pass through the ECMWF step untouched, so the
        # loss does not reach them: their gradients are zeros
        g = torch.autograd.grad(loss_of(o), (sst_series, *st0),
                                allow_unused=True, materialize_grads=True)
        torch.cuda.synchronize()
        grads[path] = (g, time.perf_counter() - t0, kfused.GRAD_LAUNCHES,
                       torch.cuda.max_memory_allocated())
        del o, sst_series, st0
    out["grad_launches"] = grads["fused"][2]
    if out["grad_launches"] != NT or grads["eager_remat"][2] != 0:
        fail(f"config 4's gradient main path launched the gradient kernel "
             f"{out['grad_launches']} times, not {NT}")
    emit({"phase": "ecmwf_grad_parity", "state": "series_value_grad",
          "records": NT, "grad_launches": out["grad_launches"],
          "seconds_fused": grads["fused"][1],
          "seconds_eager_remat": grads["eager_remat"][1],
          "max_memory_allocated_fused": grads["fused"][3],
          "max_memory_allocated_eager_remat": grads["eager_remat"][3],
          "vs_eager_remat": grad_parity(grads["fused"][0],
                                        grads["eager_remat"][0],
                                        ("sst",) + GRADS[9:],
                                        torch.float32)})
    del grads, forcing, f_state, state0

    # --- 17. timing: step and value+grad, fp32 (the main path) and fp64 -----
    ops = OPS_PER_POINT["skin_ecmwf"]
    grad_ops = OPS_PER_POINT["grad_skin_ecmwf"]
    for dtype in (torch.float32, torch.float64):
        ins = (*make_inputs(dev, dtype),
               *abt.init_skin_state(cfg, (NY, NX), dtype, dev))
        cts = cotangents((NY, NX), dtype, dev, seed=8)
        leaves = [x.clone().requires_grad_() for x in ins]
        step_kw = dict(lon=ins[8], isecday_utc=isd0,
                       skin_state=abt.SkinState(*ins[9:]))

        def value_and_grad():
            outs, _ = kfused.fused_flux_step(
                cfg, *leaves[:8], lon=leaves[8], isecday_utc=isd0,
                skin_state=abt.SkinState(*leaves[9:]))
            return torch.autograd.grad((outs[0] + outs[1]).sum(), leaves,
                                       materialize_grads=True)

        rec = {"kernel_ms": cuda_ms(lambda: kfused.fused_flux_step(
                   cfg, *ins[:8], **step_kw), 20),
               "plain_ms": cuda_ms(lambda: kfused.fused_flux_step_plain(
                   cfg, *ins[:8], **step_kw), 3),
               "grad_kernel_ms": cuda_ms(lambda: kfused.fused_flux_step_grad(
                   cfg, ins, cts, isd0), 5),
               "value_grad_kernel_ms": cuda_ms(value_and_grad, 5)}
        if dtype == torch.float32:
            rec["plain_vjp_ms"] = cuda_ms(
                lambda: kfused.fused_flux_step_vjp_plain(
                    cfg, ins[:9], abt.SkinState(*ins[9:]), cts, isd0), 2)
        for key in ("kernel_ms", "plain_ms", "value_grad_kernel_ms"):
            rec[key.replace("_ms", "_points_per_s")] = \
                NY * NX / (rec[key] * 1e-3)
        rec["bound_ms"], rec["bound_by"] = bound(ops, 23, NY * NX, dtype)
        rec["grad_bound_ms"], rec["grad_bound_by"] = bound(
            grad_ops, 36, NY * NX, dtype)
        rec["grad_bound_forward_mode_ms"] = bound(
            ops * FORWARD_MODE_FACTOR, 36, NY * NX, dtype)[0]
        rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
        rec["grad_share_of_bound"] = rec["grad_bound_ms"] / \
            rec["grad_kernel_ms"]
        out["times"][dtype] = rec
        emit({"phase": "ecmwf_timing", "dtype": str(dtype),
              "shape": [NY, NX], "card": card,
              "mode": "reverse", **rec})
        del ins, cts, leaves, step_kw
    return out


_CHAIN_ENTRY = re.compile(r"chain_kernelILi(\d+)ELi(\d+)ELi(\d+)E([fd])E")
_CHAIN_SOURCES = ("primitive_chain.cu", "primitive_chain_forward.cu")
#: the census classes priced alone by the ceiling (cheap is priced by the
#: FMA ceiling)
TRANSCENDENTAL = tuple(c for c in kchain.CLASSES if c != "cheap")


def chain_ptxas():
    """Registers and spill stores of each primitive-chain instantiation,
    from nvcc's reports: {(op, P, K, dtype name): (registers, spill
    bytes)}."""
    found = {}
    ops = kchain.CLASSES + kchain.FORMS
    for source in _CHAIN_SOURCES:
        log = _build.library_path(source).with_suffix(".log")
        report = _build.ptxas_report(log.read_text() if log.exists() else "")
        for entry, (regs, spill, _) in report.items():
            if m := _CHAIN_ENTRY.search(entry):
                op, P, K, t = m.groups()
                found[(ops[int(op)], int(P), int(K),
                       "float32" if t == "f" else "float64")] = (regs, spill)
    return found


def kernel_rates(best, dtype, source):
    """The per-class rates that price the census of a kernel built from
    ``source``: every power at pow_pos (common.cuh), division and square
    root at the fp32 forms of FORWARD_FLAGS where ``source`` builds with
    them (kernels 1-5: kernel 2 recomputes kernel 1's forward with its
    flags) and IEEE otherwise and for every fp64 build; the other classes
    as measured."""
    r = {op: best[(dtype, op)] for op in kchain.CLASSES}
    approx = dtype == torch.float32 and \
        _build.SOURCE_FLAGS.get(source) == _build.FORWARD_FLAGS
    forms = kchain.FORMS if approx else ("pow_pos",)
    for form in forms:
        r[kchain.FORM_CLASS[form]] = best[(dtype, form)]
    return r, {kchain.FORM_CLASS[form]: form for form in forms}


def ceiling(counts, rates, fma_per_s):
    """The most points/s a kernel of census ``counts`` can reach: the
    largest of (i) each transcendental class alone at its best rate over
    the P sweep and (ii) every op of the census at twice the measured FMA
    ceiling (one FFMA carries two census ops, and an SM issues one warp
    instruction a cycle per scheduler whatever its class).  Returns
    (points/s, what binds, the seconds a point of each term)."""
    terms = {cls: counts.get(cls, 0) / rates[cls] for cls in TRANSCENDENTAL}
    terms["fma_issue"] = sum(counts.values()) / (2 * fma_per_s)
    by = max(terms, key=terms.get)
    return 1.0 / terms[by], by, terms


def roofline_phase(dev, card, timed):
    """Phase 18: kernel 6 (primitive_chain.cu and, for the forms kernels
    1, 3, 4 and 5 run, primitive_chain_forward.cu) against its plain
    version, then the roofline of tools/run_roofline.py on the card: the
    per-class and per-form rates with a P sweep, the FMA ceiling, and for
    each kernel timed in this run its census priced at its own build's
    forms: the serial-issue floor and the ceiling, with the kernel's share
    of each.  ``timed`` maps a kernel to (its census: a key of
    roofline.CENSUS or the counts, its source in csrc/, {dtype:
    points/s})."""
    shape, K = (1024, 1024), 64
    dtypes = (torch.float64, torch.float32)
    ops = kchain.CLASSES + kchain.FORMS
    x = np.random.default_rng(5).random(shape)
    worst, tols, worst_abs = {}, {}, 0.0
    for dtype in dtypes:
        xd = torch.as_tensor(x, dtype=dtype, device=dev)
        for op in ops:
            for P in kchain.CHAINS:
                for k in kchain.DEPTHS:
                    if not kchain.instantiated(op, P, k, dtype):
                        continue
                    got = kchain.primitive_chain(xd, op, k, P)
                    ref = kchain.primitive_chain_plain(xd, op, k, P)
                    rel = float(((got - ref).abs() / ref.abs()).max())
                    tol = kchain.plain_rtol(dtype, k, P, op)
                    tols[f"{op}_P{P}_K{k}_{str(dtype)[6:]}"] = tol
                    if not rel <= tol:
                        fail(f"primitive_chain {op} P={P} K={k} {dtype}: "
                             f"max relative {rel} above {tol}")
                    worst[(dtype, op)] = max(worst.get((dtype, op), 0.0), rel)
                    if dtype == torch.float32:
                        worst_abs = max(worst_abs,
                                        float((got - ref).abs().max()))
    emit({"phase": "roofline", "part": "parity", "shape": list(shape),
          "max_rel": {f"{op}_{str(dt)[6:]}": v
                      for (dt, op), v in worst.items()},
          "tolerance": tols})

    regs = chain_ptxas()
    kchain.LAUNCHES = 0
    rates, fma, best = {}, {}, {}
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype)[6:]
        measured = tuple(op for op in ops
                         if kchain.instantiated(op, 1, K, dtype))
        for P in kchain.CHAINS:
            r = roofline.measure_primitive_throughput(
                shape=shape, K=K, P=P, dtype=dtype, ops=measured)
            rates[(dtype, P)] = r
            for op, v in r.items():
                best[(dtype, op)] = max(best.get((dtype, op), 0.0), v)
            emit({"phase": "roofline", "part": "rates", "dtype": str(dtype),
                  "shape": list(shape), "K": K, "P": P, "card": card,
                  "applications_per_s": r,
                  "ptxas_registers_spill_bytes": {
                      op: regs.get((op, P, K, dname)) for op in r}})
            if r["cheap"] > FMA_PER_S[dtype]:
                fail(f"{dtype} cheap-class rate {r['cheap']:.4g}/s above the "
                     f"data sheet's {FMA_PER_S[dtype]:.4g} FMA/s: the chain "
                     f"was folded")
        probes = {f"P{P}_K{k}": roofline.measure_primitive_throughput(
                      shape=(2048, 2048), K=k, P=P, dtype=dtype,
                      ops=("cheap",))["cheap"]
                  for P, k in ((2, 256), (4, 128))}
        fma[dtype] = max(probes.values())
        if fma[dtype] > FMA_PER_S[dtype]:
            fail(f"{dtype} FMA ceiling {fma[dtype]:.4g}/s above the data "
                 f"sheet's {FMA_PER_S[dtype]:.4g}")
        emit({"phase": "roofline", "part": "fma_ceiling", "dtype": str(dtype),
              "shape": [2048, 2048], "card": card, "probes": probes,
              "fma_per_s": fma[dtype],
              "share_of_data_sheet": fma[dtype] / FMA_PER_S[dtype],
              "best_applications_per_s_over_P": {
                  op: v for (dt, op), v in best.items() if dt == dtype},
              "ptxas_registers_spill_bytes": {
                  "P2_K256": regs.get(("cheap", 2, 256, dname)),
                  "P4_K128": regs.get(("cheap", 4, 128, dname))}})
    launches = kchain.LAUNCHES
    if launches == 0:
        fail("the roofline path never launched the primitive-chain kernel")

    over = []
    for name, (key, source, pps) in timed.items():
        for dtype, points_per_s in pps.items():
            counts = roofline.CENSUS[key] if isinstance(key, str) else key
            r, forms = kernel_rates(best, dtype, source)
            floor = roofline.speed_of_light(counts, r)
            top, top_by, terms = ceiling(counts, r, fma[dtype])
            implied = points_per_s * sum(counts.values())
            rec = {"phase": "roofline", "part": "kernel", "kernel": name,
                   "source": source,
                   "census": key if isinstance(key, str) else dict(key),
                   "ops_per_point": sum(counts.values()),
                   "dtype": str(dtype), "card": card,
                   "priced_forms": forms,
                   "points_per_s": points_per_s,
                   "points_per_s_serial_issue":
                       floor["points_per_s_bound"],
                   "points_per_s_over_serial_issue":
                       points_per_s / floor["points_per_s_bound"],
                   "serial_issue_breakdown": floor["breakdown"],
                   "points_per_s_ceiling": top, "ceiling_bound_by": top_by,
                   "ceiling_seconds_per_point": terms,
                   "share_of_ceiling": points_per_s / top,
                   "implied_ops_per_s": implied,
                   "share_of_data_sheet_ops": implied / PEAK_OPS[dtype],
                   "fraction_of_2x_fma_ceiling": implied / (2 * fma[dtype])}
            emit(rec)
            if points_per_s > 1.05 * top:
                over.append(f"{name} {dtype}: {points_per_s:.4g} points/s "
                            f"above 1.05 x its ceiling {top:.4g}")
    if over:
        fail("kernels above their ceiling (the ceiling prices the wrong "
             "ops): " + "; ".join(over))

    n = shape[0] * shape[1]
    x0 = torch.full(shape, 0.37, dtype=torch.float32, device=dev)
    rel = lambda dt: max(v for (d, _), v in worst.items()       # noqa: E731
                         if d == dt)
    return {"launches": launches, "rates": rates, "ceiling": fma,
            "max_abs_err": worst_abs,
            "max_rel_fp32": rel(torch.float32),
            "max_rel_fp64": rel(torch.float64),
            "ms": 1e3 * n * K * 2 / rates[(torch.float32, 2)]["cheap"],
            "plain_ms": cuda_ms(lambda: kchain.primitive_chain_plain(
                x0, "cheap", K, 2), 2, reps=3),
            # K * P FMA of 2 operations each at P = 2; one read, one write
            "bound": bound(2 * K * 2, 2, n, torch.float32)}


# ---------------------------------------------------------------------------
# phase 19: the streamed host feed
# ---------------------------------------------------------------------------

#: phase 19's host records (phase 24's ranks make their slabs' alike)
streamed_records = measure.stream_records


def d2h_leg_s():
    """Host seconds one chunk's collected fields (STREAMED_FIELDS, CHUNK
    records, fp32) cost the consumer, median of 3, each result kept as a
    caller keeps it: copied out of pinned buffers into fresh pageable
    arrays (the collector's ring), and, for the design the ring replaced,
    fresh pinned memory allocated for them (page-locked while kept)."""
    shape = (CHUNK, NY, NX)
    pinned = [torch.zeros(shape, pin_memory=True) for _ in STREAMED_FIELDS]
    designs = {"ring_copy_out": lambda: [p.numpy().copy() for p in pinned],
               "fresh_pinned": lambda: [torch.empty(shape, pin_memory=True)
                                        for _ in STREAMED_FIELDS]}
    out = {}
    for name, fn in designs.items():
        kept, times = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            kept.append(fn())
            times.append(time.perf_counter() - t0)
        out[name] = float(np.median(times))
        del kept
    return out


def streamed_run(dev, card, stream_in, link, run):
    """One streamed run of phase 19: run_series_pipelined(backend="fused")
    over the run's records, which must launch kernel 1 once per record;
    the same chunk program on device-resident forcing (compute-only); and
    the collected outputs of every record against
    run_series(backend="fused") over the same forcing built on the device,
    at bench.py's streamed gates.  Returns the phase's line."""
    algo, wire, collect_wire, chunk, nrec = run
    base, lon, offs, base_dev, lon_dev = stream_in
    cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    kw = dict(chunk=chunk, backend="fused", lon=lon_dev, inflight=2,
              wire=wire, collect_wire=collect_wire, device=dev)
    # warm-up: one chunk (the kernel is built), then the measured run
    tpipe.run_series_pipelined(cfg, streamed_records(base, offs, chunk or 1),
                               **kw)
    torch.cuda.synchronize()
    kfused.LAUNCHES = 0
    producer = []
    t0 = time.perf_counter()
    results, state = tpipe.run_series_pipelined(
        cfg, streamed_records(base, offs, nrec), producer_seconds=producer,
        **kw)
    state.dT_wl.sum().item()                # the final true sync
    streamed_s = time.perf_counter() - t0
    launches = kfused.LAUNCHES
    if launches != nrec:
        fail(f"streamed {run}: kernel 1 launched {launches} times, not "
             f"{nrec}")
    if len(results) != (nrec if chunk is None else -(-nrec // chunk)):
        fail(f"streamed {run}: {len(results)} collected items")

    # compute-only: the same chunk program, forcing resident on the device
    ch = chunk or 1
    fc = {k: v.expand(ch, NY, NX).contiguous() for k, v in base_dev.items()}
    isd = [(jt * 3600) % 86400 for jt in range(ch)]
    state0 = abt.init_skin_state(cfg, (NY, NX), torch.float32, dev)
    abt.run_series(cfg, fc, skin_state=state0, isecday_utc=isd, lon=lon_dev,
                   backend="fused")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = state0
    for _ in range(nrec // ch):
        _, st = abt.run_series(cfg, fc, skin_state=st, isecday_utc=isd,
                               lon=lon_dev, backend="fused")
    st.dT_wl.sum().item()
    compute_s = time.perf_counter() - t0
    del fc, st, state0

    points = NY * NX
    streamed_pts = nrec * points / streamed_s
    compute_pts = nrec * points / compute_s
    h2d, d2h = link
    # bytes per value on the wire: i8d ships one int16 base and (chunk-1)
    # int8 deltas per chunk
    in_width = {"f32": 4.0, "i16": 2.0, "i8d": (ch + 1) / ch}[wire]
    out_width = 2 if collect_wire == "i16" else 4
    bytes_in = int(len(base) * in_width * points)
    bytes_out = len(STREAMED_FIELDS) * out_width * points
    transfer_pts = points / (bytes_in / h2d + bytes_out / d2h)
    bound_pts = min(compute_pts, transfer_pts)

    join = np.stack if chunk is None else np.concatenate
    got = [torch.as_tensor(join([r[k] for r in results]), device=dev)
           for k in STREAMED_FIELDS]
    ref = resident_reference(cfg, base_dev, offs, nrec, lon_dev)
    quantized = wire != "f32" or collect_wire == "i16"
    check = parity(got, ref, torch.float32, names=STREAMED_FIELDS,
                   gate=STREAMED_GATES[quantized])
    del got, ref, results

    stage = staging_s(dev, base, offs, wire, chunk)
    per = "chunk" if chunk else "record"
    paces = {"record_source": source_s(base, offs, ch),
             "host_staging": stage,
             "link": ch * (bytes_in / h2d + bytes_out / d2h),
             "kernel": compute_s / (nrec // ch)}
    return {
        "phase": "streamed", "algo": algo, "wire": wire,
        "collect_wire": collect_wire, "chunk": chunk, "records": nrec,
        "launches": launches, "card": card,
        "streamed_s": streamed_s, "streamed_points_per_s": streamed_pts,
        "compute_only_s": compute_s,
        "compute_only_points_per_s": compute_pts,
        "h2d_gbps": h2d / 1e9, "d2h_gbps": d2h / 1e9,
        "bytes_h2d_per_record": bytes_in, "bytes_d2h_per_record": bytes_out,
        "transfer_bound_points_per_s": transfer_pts,
        "bound_points_per_s": bound_pts,
        "overlap_efficiency": streamed_pts / compute_pts,
        "overlap_efficiency_vs_bound": streamed_pts / bound_pts,
        f"producer_s_per_{per}": {
            "median": float(np.median(producer)),
            "max": float(np.max(producer)), "all": producer},
        f"s_per_{per}_by_stage": paces,
        "paced_by": max(paces, key=paces.get),
        "check": {"records": nrec, "median_rel": check["median_rel"],
                  "worst_sig_frac": check["worst_sig_frac"],
                  "max_abs_err": check["max_abs_err"],
                  "gate": check["gate"]}}


def checkpoint_check(dev, stream_in):
    """24 streamed records in chunks of 8, against 12, a checkpoint
    written with save_skin_state and read back with load_skin_state, and
    the other 12: the outputs and the final state must be bitwise equal."""
    base, lon, offs, base_dev, lon_dev = stream_in
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    names = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
    kw = dict(chunk=CHUNK, backend="fused", lon=lon_dev, device=dev,
              collect=lambda o: {n: getattr(o, n) for n in names})

    def run(start, stop, state=None):
        res, st = tpipe.run_series_pipelined(
            cfg, streamed_records(base, offs, stop, start), skin_state=state,
            **kw)
        return {n: np.concatenate([r[n] for r in res]) for n in names}, st

    full, st_full = run(0, NT)
    _, st_mid = run(0, NT // 2)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "skin_state.npz")
        save_skin_state(path, st_mid)
        restored = load_skin_state(path, device=dev)
    rest, st_end = run(NT // 2, NT, restored)
    for n in names:
        if not np.array_equal(rest[n], full[n][NT // 2:], equal_nan=True):
            fail(f"checkpoint: resumed {n} differs from the uninterrupted "
                 "run")
    for n, a, b in zip(st_end._fields, st_end, st_full):
        if not torch.equal(a, b):
            fail(f"checkpoint: resumed final {n} differs")
    if not all(torch.equal(a, b) for a, b in zip(restored, st_mid)):
        fail("checkpoint: the restored state differs from the saved one")
    return {"phase": "streamed_checkpoint", "records": NT,
            "saved_after": NT // 2, "chunk": CHUNK, "bitwise_equal": True,
            "wl_built_points_mid": int((st_mid.dT_wl > 0).sum())}


def streamed_phase(dev, card):
    """Phase 19: the D2H leg's host costs, the streamed feed on every run
    of STREAMED_RUNS, and the checkpoint resume.  Returns each
    run's kernel-1 launches by label."""
    base, lon, offs = measure.streamed_forcing(NREC)
    base_dev = {k: torch.as_tensor(v, device=dev) for k, v in base.items()}
    lon_dev = torch.as_tensor(lon, device=dev)
    stream_in = (base, lon, offs, base_dev, lon_dev)
    link = link_gbps(dev)
    emit({"phase": "streamed", "part": "link", "card": card,
          "h2d_gbps": link[0] / 1e9, "d2h_gbps": link[1] / 1e9,
          "bytes": list(LINK_BYTES), "d2h_leg_s_per_chunk": d2h_leg_s()})
    launches = {}
    for run in STREAMED_RUNS:
        rec = streamed_run(dev, card, stream_in, link, run)
        emit(rec)
        algo, wire, collect_wire, chunk, _ = run
        launches[f"{algo} {wire}/{collect_wire} chunk {chunk}"] = \
            rec["launches"]
    emit(checkpoint_check(dev, stream_in))
    return launches


# ---------------------------------------------------------------------------
# phases 20-22: long runs, the validity envelope, linearizations
# ---------------------------------------------------------------------------

def record_by_record(cfg, forcing, isd, lon, backend, dtype, dev):
    """``run_series`` over the records of ``forcing`` (numpy, records
    first) one record a call, carrying the state: the same steps as one
    call, with the state after each record kept.  Returns (stacked
    outputs, dT_wl after each record, final state), fp64 on the host."""
    f = {k: torch.as_tensor(v, dtype=dtype, device=dev)
         for k, v in forcing.items()}
    lon_t = torch.as_tensor(lon, dtype=dtype, device=dev)
    state = abt.init_skin_state(cfg, f["sst"].shape[1:], dtype, dev)
    outs, dT_wl = [], []
    for k in range(f["sst"].shape[0]):
        out, state = abt.run_series(
            cfg, {n: x[k:k + 1] for n, x in f.items()}, skin_state=state,
            isecday_utc=[int(isd[k])], lon=lon_t, backend=backend)
        outs.append(torch.stack([out.QL[0], out.QH[0]]))
        dT_wl.append(state.dT_wl)
    to_host = lambda x: x.double().cpu().numpy()     # noqa: E731
    return (to_host(torch.stack(outs)), to_host(torch.stack(dT_wl)),
            abt.SkinState(*(to_host(x) for x in state)))


def drift(run, ref):
    """The reference test's drift quantities of ``run`` against ``ref``
    (each a record_by_record result)."""
    (o, dT, s), (o_r, dT_r, s_r) = run, ref
    return {"Qnt_ac_final": float(np.abs(s.Qnt_ac - s_r.Qnt_ac).max()),
            "Tau_ac_final": float(np.abs(s.Tau_ac - s_r.Tau_ac).max()),
            "dT_wl_final": float(np.abs(s.dT_wl - s_r.dT_wl).max()),
            "dT_wl_over_run": float(np.abs(dT - dT_r).max()),
            "QL_over_run": float(np.abs(o[:, 0] - o_r[:, 0]).max()),
            "QH_over_run": float(np.abs(o[:, 1] - o_r[:, 1]).max())}


def check_budget(what, d):
    over = {k: v for k, v in d.items() if not v < MONTH_BUDGET[k]}
    if over:
        fail(f"{what}: over the reference's fp32 drift budget "
             f"{MONTH_BUDGET}: {over}")


def full_width_record(gen, dev, k, static, day_draws):
    """Record ``k`` of the weather machine at every point of the
    0.25-degree grid, generated on the card from ``gen`` in fp64: the
    forcing of one record, and its isecday."""
    from aerobulk_tpu_torch import thermo
    sst0, lon = static
    amp, wind_base = day_draws
    h = float(k)
    shape = (NY, NX)
    normal = lambda s: torch.randn(shape, generator=gen, device=dev,   # noqa
                                   dtype=torch.float64) * s
    uniform = lambda: torch.rand(shape, generator=gen, device=dev,      # noqa
                                 dtype=torch.float64)
    sst = sst0 + 0.8 * np.sin(h / 96.0) + normal(0.05)
    t = sst + 1.5 * np.sin(2 * np.pi * h / 24.0) + normal(1.0)
    slp = 99000.0 + 3000.0 * uniform()
    loc_h = torch.remainder(h + lon / 15.0, 24.0)
    f = {"sst": sst, "t_zt": t, "slp": slp,
         "hum_zt": 0.6 * thermo.q_sat(t, slp),
         "U_zu": wind_base[k] + 1.5 * uniform(), "V_zu": normal(2.0),
         "rad_sw": amp[k // 24] * torch.clamp(
             torch.sin(np.pi * (loc_h - 6.0) / 12.0), min=0.0),
         "rad_lw": 260.0 + 140.0 * uniform()}
    return f, (k % 24) * 3600 + 1800


def full_width_month(dev, algo):
    """Phase 20(c): the weather machine's month on the 721x1440 grid
    through kernel 1 in fp32 and fp64 and the eager port in fp32
    (run_series, one record a call), each record's statistics against
    kernel 1 fp64 accumulated on the card.  The gate, in every record and
    field: kernel 1 fp32 at most 1e-4 significant, or, where the eager
    fp32 port (fp32 itself, F5 of ROADMAP.md section 3) leaves that too,
    at most FP32_SELF_MULT times the eager port's fraction and never over
    FP32_SIG_CEILING.  Returns (the phase's record, the flip lines, fp32
    launches); the record's ``failed`` lists the records outside the
    gate (the run stops at the first)."""
    cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    gen = torch.Generator(device=dev).manual_seed(405)
    rng = np.random.default_rng(405)
    day = np.arange(NT_LONG) // 24
    ndays = -(-NT_LONG // 24)
    amp = np.maximum(850.0 - 700.0 * (np.arange(ndays) % 4 == 3)
                     + 80.0 * rng.standard_normal(ndays), 60.0)
    wind_base = 2.0 + 9.0 * (day % 7 >= 5) + 2.0 * rng.random(NT_LONG)
    sst0 = 287.0 + 10.0 * torch.rand((NY, NX), generator=gen, device=dev,
                                     dtype=torch.float64)
    lon = (0.25 * torch.arange(NX, device=dev, dtype=torch.float64)
           ).expand(NY, NX)
    lons = {torch.float32: lon.float().contiguous(),
            torch.float64: lon.contiguous()}
    k32, k64, e32 = runs = (("fused", torch.float32),
                            ("fused", torch.float64),
                            ("eager", torch.float32))
    states = {r: abt.init_skin_state(cfg, (NY, NX), r[1], dev) for r in runs}
    pairs = {"kernel_fp32_vs_kernel_fp64": (k32, k64),
             "eager_fp32_vs_kernel_fp64": (e32, k64),
             "kernel_fp32_vs_eager_fp32": (k32, e32)}
    worst = {p: {n: {"sig_frac": 0.0, "record": 0, "max_abs": 0.0,
                     "p9999_abs": 0.0, "median_rel": 0.0} for n in FIELDS}
             for p in pairs}
    # records where kernel 1 fp32 leaves 1e-4: (record, its significant
    # fraction, the eager fp32 port's), and those outside the gate
    over = {n: [] for n in FIELDS}
    failed = []
    flips, flip_lines, launches = 0, [], 0
    for k in range(NT_LONG):
        f64, isd = full_width_record(gen, dev, k, (sst0, lon),
                                     (amp, wind_base))
        prev64 = states[k64]
        res = {}
        for run in runs:
            backend, dt = run
            before = kfused.LAUNCHES
            out, states[run] = abt.run_series(
                cfg, {n: x.to(dt)[None] for n, x in f64.items()},
                skin_state=states[run], isecday_utc=[isd], lon=lons[dt],
                backend=backend)
            if run == k32:
                launches += kfused.LAUNCHES - before
            res[run] = (out.QL[0], out.QH[0], out.Tau_x[0], out.Tau_y[0],
                        out.Evap[0], out.T_s[0], *states[run])
        sig = {}
        stacked = {run: torch.stack([x.double().reshape(-1) for x in r])
                   for run, r in res.items()}
        meds = {}
        for pair, (ra, rb) in pairs.items():
            st, meds[rb] = fields_stats(stacked[ra], stacked[rb], pair,
                                        meds.get(rb))
            for i, name in enumerate(FIELDS):
                w = worst[pair][name]
                sig[pair, name] = sf = st["sig_frac"][i]
                if sf > w["sig_frac"]:
                    w["sig_frac"], w["record"] = sf, k
                for stat in ("max_abs", "p9999_abs", "median_rel"):
                    w[stat] = max(w[stat], st[stat][i])
        del stacked, meds
        for name in FIELDS:
            ks = sig["kernel_fp32_vs_kernel_fp64", name]
            es = sig["eager_fp32_vs_kernel_fp64", name]
            if ks > 1e-4:
                over[name].append([k, ks, es])
                if not (ks <= FP32_SELF_MULT * es and ks <= FP32_SIG_CEILING):
                    failed.append({"record": k, "field": name,
                                   "kernel_sig_frac": ks,
                                   "eager_sig_frac": es})
        r32, r64 = res[k32], res[k64]
        dq = torch.maximum((r32[0].double() - r64[0]).abs(),
                           (r32[1].double() - r64[1]).abs())
        flipped = dq > FLIP_WM2
        flips += int(flipped.sum())
        for j in torch.nonzero(flipped.reshape(-1)).reshape(-1)[
                :FLIPS_LISTED - len(flip_lines)].tolist():
            pt = lambda xs: {n: float(x.reshape(-1)[j])          # noqa: E731
                             for n, x in xs}
            flip_lines.append({
                "record": k, "index": [j // NX, j % NX], "isecday_utc": isd,
                "inputs": pt(f64.items()),
                "state_before_fp64": pt(zip(prev64._fields, prev64)),
                "fp32_kernel": pt(zip(FIELDS, r32)),
                "fp64_kernel": pt(zip(FIELDS, r64))})
        if failed:
            break
    rec = {"phase": "long_series", "part": "full_width", "algo": algo,
           "shape": [NY, NX], "records": k + 1, "launches_fp32": launches,
           "worst_by_pair_and_field": worst,
           "records_over_1e-4_kernel_fp32_vs_fp64_with_eager_fp32": {
               n: v for n, v in over.items() if v},
           "gate": {"sig_frac_every_record": 1e-4,
                    "else_times_eager_fp32": FP32_SELF_MULT,
                    "ceiling": FP32_SIG_CEILING},
           "failed": failed,
           "flip_threshold_w_m2": FLIP_WM2, "flipped_point_records": flips,
           "point_records": (k + 1) * NY * NX,
           "flip_fraction": flips / ((k + 1) * NY * NX)}
    return rec, flip_lines, launches


def month_reference(algo, dtype_name, nt):
    """Phase 20(a)'s eager reference of ``algo`` in ``dtype_name`` over
    ``nt`` records of the reference's month on the CPU, in a worker process
    of its own (the record_by_record result)."""
    torch.set_num_threads(1)
    f, isd, lon = measure.weather_forcing(nt, 6, seed=405)
    cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    return record_by_record(cfg, f, isd, lon, "eager",
                            getattr(torch, dtype_name), "cpu")


def long_series_phase(dev, card):
    """Phase 20: kernel 1 over a month and a year of the reference's
    weather machine, and over a month at 721x1440.  The eager references
    of (a) run on the host's CPU in four worker processes while the card
    runs (a), (b) and (c); (a) is checked when they are in.  Returns
    kernel 1's launches by part, algorithm and dtype."""
    import multiprocessing
    t_phase = time.perf_counter()
    pool = multiprocessing.get_context("spawn").Pool(4)
    try:
        refs = {(algo, name): pool.apply_async(month_reference,
                                               (algo, dt, NT_LONG))
                for algo in ("coare3p6", "ecmwf")
                for name, dt in (("eager_fp64", "float64"),
                                 ("eager_fp32", "float32"))}
        launches, months = long_series_on_card(dev, card)
        for algo, (runs, seconds) in months.items():
            t0 = time.perf_counter()
            for name in ("eager_fp64", "eager_fp32"):
                runs[name] = refs[(algo, name)].get(timeout=600)
            month_check(algo, runs, card,
                        seconds + time.perf_counter() - t0)
    finally:
        pool.terminate()
        pool.join()
    emit({"phase": "long_series", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


def month_check(algo, runs, card, seconds):
    """Phase 20(a)'s checks of one algorithm: kernel 1 fp32, the eager port
    fp32 and kernel 1 fp64 against the eager port fp64, each at the
    reference's asserted fp32 drift budgets."""
    ref = runs["eager_fp64"]
    d = {name: drift(run, ref) for name, run in runs.items()
         if name != "eager_fp64"}
    check_budget(f"long_series {algo} kernel fp32", d["kernel_fp32"])
    check_budget(f"long_series {algo} eager fp32", d["eager_fp32"])
    check_budget(f"long_series {algo} kernel fp64", d["kernel_fp64"])
    o64k, o64 = runs["kernel_fp64"][0], ref[0]
    rel64 = float(np.max(np.abs(o64k - o64)
                         / np.maximum(np.abs(o64), 1e-300)))
    dT = ref[1]
    emit({"phase": "long_series", "part": "month", "algo": algo,
          "points": 6, "records": NT_LONG, "seed": 405, "card": card,
          "eager_references_on": "cpu",
          "budget": MONTH_BUDGET, "drift_vs_eager_fp64": d,
          "kernel_fp64_vs_eager_fp64_max_rel_QL_QH": rel64,
          "wl_max_dT_wl": float(dT.max()),
          "wl_dawn_resets": int(((dT[:-1] > 0) & (dT[1:] == 0)).sum()),
          "seconds": seconds})


def long_series_on_card(dev, card):
    """Phase 20's runs on the card: (a) kernel 1 over the reference's month
    in fp32 and fp64, (b) the year, (c) the month at 721x1440, with (b)'s
    and (c)'s checks.  Returns (kernel 1's launches, {algorithm: ((a)'s
    runs, their seconds)})."""
    launches, months = {}, {}
    # (a) the reference's month, 6 points
    f, isd, lon = measure.weather_forcing(NT_LONG, 6, seed=405)
    for algo in ("coare3p6", "ecmwf"):
        t0 = time.perf_counter()
        cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                                 use_skin=True)
        runs = {}
        for name, dtype in (("kernel_fp32", torch.float32),
                            ("kernel_fp64", torch.float64)):
            before = kfused.LAUNCHES
            runs[name] = record_by_record(cfg, f, isd, lon, "fused", dtype,
                                          dev)
            n = kfused.LAUNCHES - before
            if n != NT_LONG:
                fail(f"long_series {algo} {name}: {n} launches of "
                     f"kernel 1, not {NT_LONG}")
            launches[f"month {algo} {name}"] = n
        months[algo] = (runs, time.perf_counter() - t0)

    # (b) a year, 4 points, seasonal; kernel 1 fp64 stands in for eager fp64
    t0 = time.perf_counter()
    f, isd, lon = measure.weather_forcing(NT_YEAR, 4, seed=406,
                                          seasonal=True)
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    before = kfused.LAUNCHES
    y32 = record_by_record(cfg, f, isd, lon, "fused", torch.float32, dev)
    launches["year coare3p6 kernel_fp32"] = kfused.LAUNCHES - before
    y64 = record_by_record(cfg, f, isd, lon, "fused", torch.float64, dev)
    d_dtwl = np.abs(y32[1] - y64[1])
    d_ql = np.abs(y32[0][:, 0] - y64[0][:, 0])
    d_qh = np.abs(y32[0][:, 1] - y64[0][:, 1])
    q_dtwl = d_dtwl.reshape(4, NT_YEAR // 4, -1).max(axis=(1, 2))
    flip_frac = float(np.mean(np.maximum(d_ql, d_qh) > FLIP_WM2))
    med_ql = float(np.median(d_ql))
    d_qac = float(np.abs(y32[2].Qnt_ac - y64[2].Qnt_ac).max())
    year = {"phase": "long_series", "part": "year", "algo": "coare3p6",
            "points": 4, "records": NT_YEAR, "seed": 406, "card": card,
            "Qnt_ac_final": d_qac, "dT_wl_quarterly_max": q_dtwl.tolist(),
            "QL_median_drift": med_ql, "flip_fraction": flip_frac,
            "flipped_point_records": int(np.sum(np.maximum(d_ql, d_qh)
                                                > FLIP_WM2)),
            "point_records": int(d_ql.size),
            "reference_cpu": {"Qnt_ac_final": 7.65,
                              "dT_wl_quarterly_max": [1.17e-5, 2.93e-6,
                                                      3.57e-6, 3.70e-6],
                              "QL_median_drift": 2.6e-4,
                              "flip_fraction": 0.0},
            "seconds": time.perf_counter() - t0}
    emit(year)
    if not (d_qac < 4e3 and q_dtwl[-1] < 1e-3
            and q_dtwl[-1] < 100 * max(q_dtwl[0], 1e-6) and med_ql < 0.01
            and flip_frac < 5e-3):
        fail(f"long_series year outside the reference's assertions: {year}")

    # (c) the month at 721x1440, fields made on the card record by record
    for algo in ("coare3p6", "ecmwf"):
        t0 = time.perf_counter()
        rec, lines, n = full_width_month(dev, algo)
        launches[f"full width {algo} kernel_fp32"] = n
        rec["seconds"] = time.perf_counter() - t0
        rec["card"] = card
        emit(rec)
        for line in lines:
            emit({"phase": "long_series", "part": "flip", "algo": algo,
                  **line})
        if rec["records"] != NT_LONG or rec["failed"]:
            fail(f"long_series full width {algo}: outside the fp32 gate "
                 f"{json.dumps(rec['gate'])}: {json.dumps(rec['failed'])}")
    return launches, months


def envelope_check(what, names, inputs, got, plain32, ref64):
    """Gate: every output of the kernel (``got``, one dtype) finite wherever
    the eager fp64 reference (``ref64``) is.  Returns the report; for each
    field, the count and first indices of points finite in one and not the
    other, each with its inputs and the fp32 plain and fp64 values."""
    report, bad_total = {}, 0
    for name, g, p, r in zip(names, got, plain32, ref64):
        g, r = g.reshape(-1), r.reshape(-1)
        lost = torch.isfinite(r) & ~torch.isfinite(g)
        gained = ~torch.isfinite(r) & torch.isfinite(g)
        entry = {"nonfinite_where_ref_finite": int(lost.sum()),
                 "finite_where_ref_nonfinite": int(gained.sum())}
        for key, mask in (("lost", lost), ("gained", gained)):
            idx = torch.nonzero(mask).reshape(-1)[:ENVELOPE_LISTED]
            if idx.numel():
                entry[f"first_{key}"] = [{
                    "index": int(j),
                    "inputs": [float(x.reshape(-1)[j]) for x in inputs],
                    "kernel": float(g[j]),
                    "fp32_plain": float(p.reshape(-1)[j]),
                    "fp64_plain": float(r[j])} for j in idx.tolist()]
        bad_total += entry["nonfinite_where_ref_finite"]
        report[name] = entry
    return {"case": what, "nonfinite_where_ref_finite": bad_total,
            "fields": report}


def envelope_phase(dev, card):
    """Phase 21: the 20,000-point ocean envelope and the 8,000-point ice
    envelope through kernels 1, 3, 4 and 5 in fp32 and fp64, each held
    against the eager port in fp64 on the card.  Returns the launches of
    each kernel's counter, and ``"by_case"``: the launches of each case."""
    t_phase = time.perf_counter()
    counters = ("LAUNCHES", "BULK_LAUNCHES", "ICE_LAUNCHES", "MIXED_LAUNCHES")
    start = {c: getattr(kfused, c) for c in counters}
    ocean = measure.ocean_envelope()
    ice = measure.ice_envelope()
    n_ocean = len(ocean[0])
    cases = []
    t_in = lambda arrs, dt, shape: [                           # noqa: E731
        torch.as_tensor(a, dtype=dt, device=dev).reshape(shape).contiguous()
        for a in arrs]
    for algo in ("coare3p6", "ecmwf"):
        cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0,
                                 niter=ENVELOPE_NITER, use_skin=True)

        def step(fn, dt, cfg=cfg):
            *args, lon = t_in(ocean, dt, (1, n_ocean))
            outs, st = fn(cfg, *args, lon=lon, isecday_utc=50000,
                          skin_state=abt.init_skin_state(cfg, (1, n_ocean),
                                                         dt, dev))
            return (*outs, *st)
        cases.append((f"kernel 1 {algo} + skin", FIELDS, ocean,
                      lambda dt, s=step: s(kfused.fused_flux_step, dt),
                      lambda dt, s=step: s(kfused.fused_flux_step_plain, dt)))
    for algo in ALGOS:
        bcfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0,
                                  niter=ENVELOPE_NITER)

        def bulk(fn, dt, bcfg=bcfg):
            return fn(bcfg, *t_in(ocean[:6], dt, (n_ocean,)))
        cases.append((f"kernel 3 {algo}", BULK_FIELDS, ocean[:6],
                      lambda dt, b=bulk: b(kfused.fused_bulk_step, dt),
                      lambda dt, b=bulk: b(kfused.fused_bulk_step_plain, dt)))
    ice_fields = (ice[0], *ice[2:])
    for algo in ICE_REGISTRY:
        def ice_step(fn, dt, algo=algo):
            Ts_i, t, q, u, v, slp, fr = t_in(ice_fields, dt, (len(ice[0]),))
            return fn(algo, 2.0, 10.0, Ts_i, t, q, u, v, slp, frice=fr,
                      niter=ICE_ENVELOPE_NITER)
        cases.append((f"kernel 4 {algo}", kfused.ICE_OUTPUTS, ice_fields,
                      lambda dt, s=ice_step: s(kfused.fused_ice_step, dt),
                      lambda dt, s=ice_step: s(kfused.fused_ice_step_plain,
                                               dt)))
    mixed = ([("ice_lg15", o, False) for o in ALGOS]
             + [(a, "ecmwf", False) for a in ICE_REGISTRY if a != "ice_lg15"]
             + [("ice_lg15", "ecmwf", True)])
    for ice_algo, ocean_algo, simul in mixed:
        kw = dict(ice_algo=ice_algo, ocean_algo=ocean_algo,
                  simultaneous=simul, niter=ICE_ENVELOPE_NITER)

        def mixed_step(fn, dt, kw=kw):
            return fn(2.0, 10.0, *t_in(ice, dt, (len(ice[0]),)), **kw)
        label = "lg15_io" if simul else f"{ice_algo} + {ocean_algo}"
        cases.append((f"kernel 5 {label}", kfused.MIXED_OUTPUTS, ice,
                      lambda dt, s=mixed_step: s(kfused.fused_mixed_step, dt),
                      lambda dt, s=mixed_step: s(kfused.fused_mixed_step_plain,
                                                 dt)))
    failures, by_case = [], {}
    for what, names, inputs, kernel, plain in cases:
        ref64 = plain(torch.float64)
        plain32 = plain(torch.float32)
        for dt in (torch.float32, torch.float64):
            before = sum(getattr(kfused, c) for c in counters)
            got = kernel(dt)
            by_case[what] = by_case.get(what, 0) + sum(
                getattr(kfused, c) for c in counters) - before
            rep = envelope_check(what, names, inputs, got, plain32, ref64)
            ref_nonfinite = {n: int((~torch.isfinite(r)).sum())
                             for n, r in zip(names, ref64)}
            emit({"phase": "envelope", "dtype": str(dt),
                  "ref_nonfinite_fp64": ref_nonfinite, **rep})
            if rep["nonfinite_where_ref_finite"]:
                failures.append(f"{what} {dt}")
    launches = {c: getattr(kfused, c) - start[c] for c in counters}
    emit({"phase": "envelope", "card": card, "ocean_points": n_ocean,
          "ice_points": len(ice[0]), "niter_ocean": ENVELOPE_NITER,
          "niter_ice": ICE_ENVELOPE_NITER, "launches": launches,
          "launches_by_case": by_case,
          "seconds": time.perf_counter() - t_phase})
    launches["by_case"] = by_case
    if failures:
        fail(f"envelope: kernel outputs non-finite where eager fp64 is "
             f"finite: {failures}")
    return launches


def fd_check(name, d64, at):
    """Hold the fp64 derivative ``d64`` of the outputs LIN_OUTPUTS to
    differences of the step ``at(delta)`` with steps h and h/2
    (``LIN_STEPS[name]``).  A point is excluded, as near a branch switch,
    where the central differences with h and h/2 disagree by more than
    FD_AGREE, or the one-sided slopes over h/2 by more than FD_KINK
    (relative, with a floor of 1e-3 of the field's largest: a switch or a
    feature narrower than h within h of the point).  On the others the
    derivative must meet the Richardson value (4 c(h/2) - c(h)) / 3 within
    FD_RTOL of max(|value|, 1e-3 of its largest)."""
    h = LIN_STEPS[name]
    plus, minus, plus2, minus2, zero = (at(h), at(-h), at(h / 2),
                                        at(-h / 2), at(0.0))
    excluded = torch.zeros_like(d64.QL, dtype=torch.bool)
    rich = {}
    for out in LIN_OUTPUTS:
        c1 = (getattr(plus, out) - getattr(minus, out)) / (2 * h)
        c2 = (getattr(plus2, out) - getattr(minus2, out)) / h
        kink = (getattr(plus2, out) - 2 * getattr(zero, out)
                + getattr(minus2, out)) / (h / 2)
        scale = c2.abs() + 1e-3 * float(c2.abs().max())
        excluded |= ((c1 - c2).abs() > FD_AGREE * scale) \
            | (kink.abs() > FD_KINK * scale)
        rich[out] = (4 * c2 - c1) / 3
    report = {"step": h, "excluded_fraction":
              float(excluded.double().mean())}
    for out in LIN_OUTPUTS:
        r = rich[out]
        err = (getattr(d64, out) - r).abs() / (
            r.abs() + 1e-3 * float(r.abs().max()))
        worst = float(err[~excluded].max())
        report[out] = worst
        if not worst <= FD_RTOL:
            fail(f"linearized d/d{name} {out}: the fp64 derivative is "
                 f"{worst:.3g} from the central differences (gate {FD_RTOL})")
    return report


def lin_witness(lin, forcing32, idx, outputs=LIN_OUTPUTS, fixed=None,
                each=False):
    """The derivatives ``outputs`` of ``lin(inputs)`` (a linearization's
    d_out, or a VJP's gradients, by name, from the inputs by name) at the
    flat points ``idx`` of ``forcing32`` (the fp32 inputs), where the
    inputs move within fp32's resolution: (fp32 at the inputs nudged one
    ulp down and up, fp64 at the fp32 inputs and at them nudged one ulp
    down and up), each a dict by output.  The inputs move together, or
    with ``each`` one at a time, each down and up: a difference of two
    inputs (sst - t_zt) that rounds to 0 moves only then.  ``fixed`` holds
    inputs by name that are not nudged (a VJP's state and cotangents), in
    each dtype.  The function is pointwise, so the points of every nudge go
    through one call per dtype, side by side."""
    sub = {n: x.reshape(-1)[idx] for n, x in forcing32.items()}
    held = {n: x.reshape(-1)[idx] for n, x in (fixed or {}).items()}
    moves = ([{n: k} for n in sub for k in (-1, 1)] if each else
             [dict.fromkeys(sub, k) for k in (-1, 1)])

    def nudged(ks, dt):
        cat = {n: torch.cat([(torch.nextafter(
            x, torch.full_like(x, k[n] * float("inf"))) if k.get(n) else
            x).to(dt) for k in ks]) for n, x in sub.items()}
        cat.update({n: x.to(dt).repeat(len(ks)) for n, x in held.items()})
        res = lin(cat)
        return [{o: getattr(res, o).reshape(len(ks), -1)[i]
                 for o in outputs} for i in range(len(ks))]
    return nudged(moves, torch.float32), nudged([{}] + moves, torch.float64)


def fp32_check(name, d32, d64, witness, outputs=LIN_OUTPUTS, rule="field",
               allowed=None, verdicts=None):
    """The fp32 derivative in ``name`` against the fp64 one, per output of
    ``outputs``, at the significant-fraction gate of fp32
    (:func:`diff_stats` by ``rule``; a point where fp32 is not finite and
    fp64 is counts as significant), over the points whose derivative fp32
    can resolve.  A significant point is witnessed as beyond fp32's
    resolution where ``witness(idx)`` (:func:`lin_witness`) shows the
    derivative itself moving by more than the significance threshold when
    the inputs move within fp32's resolution: the fp32 derivative one ulp
    away from the fp32 one, or the fp64 derivative at the fp32 inputs or
    one ulp away from the fp64 one (ROADMAP.md section 3, F6).  Without
    ``witness`` no point is witnessed (the outputs may then differ in
    shape).  Gate: at most 1e-4 of the points significant and not
    witnessed, or ``allowed[output]`` (None: no gate).  ``verdicts``, a
    dict keyed by flat points, is filled for those points whether they are
    witnessed: True where every output significant there is, None where
    none is."""
    stats = {out: diff_stats(getattr(d32, out), getattr(d64, out),
                             nonfinite="significant", rule=rule)
             for out in outputs}
    w32 = w64 = ()
    if witness is not None:
        sig_any = torch.stack([s["sig"] for s in stats.values()]).any(0)
        asked = torch.tensor(list(verdicts or ()), dtype=torch.long,
                             device=sig_any.device)
        idx = torch.unique(torch.cat([torch.nonzero(sig_any).reshape(-1),
                                      asked]))
        if idx.numel():
            w32, w64 = witness(idx)
    report, moved_by = {}, {}
    for out, s in stats.items():
        if witness is None:
            idx = torch.nonzero(s["sig"]).reshape(-1)
        sig = s["sig"][idx]
        thr = s["thr"][idx] if rule == "grad" else s["thr"]
        moved = torch.zeros_like(sig)
        for ws, base in ((w32, d32), (w64, d64)):
            b = getattr(base, out).double().reshape(-1)[idx]
            for w in ws:
                w = w[out].double()
                moved |= ((w - b).abs() > thr) | (
                    torch.isfinite(w) != torch.isfinite(b))
        moved_by[out] = (sig, moved)
        n = int((s["keep"] | s["lost"]).sum())
        bare = idx[sig & ~moved]
        r = {"median_rel": median(s["rel"]),
             "max_rel": float(s["rel"].max()) if s["rel"].numel() else 0.0,
             "max_abs": float(s["d"].max()), "sig_frac": s["sig_frac"],
             "sig_points": int(sig.sum()), "lost_points": int(s["lost"].sum()),
             "witnessed_sig_points": int((sig & moved).sum()),
             "unwitnessed_sig_frac": bare.numel() / n,
             "unwitnessed_first_flat": bare[:ENVELOPE_LISTED].tolist()}
        limit = GATES[torch.float32][1] if allowed is None else \
            allowed.get(out)
        if limit is not None and not r["unwitnessed_sig_frac"] <= limit:
            fail(f"{name} {out}: fp32 against fp64 outside the gate "
                 f"({limit} significant, unwitnessed): {json.dumps(r)}")
        report[out] = r
    if verdicts and witness is not None:
        pos = {int(j): k for k, j in enumerate(idx.tolist())}
        for j in list(verdicts):
            k = pos[int(j)]
            hit = [bool(moved[k]) for sig, moved in moved_by.values()
                   if sig[k]]
            verdicts[j] = all(hit) if hit else None
    return report


def linearized_phase(dev, card):
    """Phase 22: the linearizations at 721x1440 (fp64 against central
    differences, fp32 against fp64), aerobulk_model over 24 records against
    the eager chain, and implicit_coupling.main(days=8) on the card."""
    from aerobulk_tpu_torch import api as tapi
    from aerobulk_tpu_torch import implicit_coupling
    t_phase = time.perf_counter()
    names = ("sst", "t_zt", "hum_zt", "U_zu", "V_zu", "slp", "rad_sw",
             "rad_lw")
    forcing = {dt: dict(zip(names + ("lon",), make_inputs(dev, dt)))
               for dt in (torch.float64, torch.float32)}
    for algo in ("coare3p6", "ecmwf"):
        cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                                 use_skin=True)
        for wrt in abt.api._LINEARIZABLE:
            def lin(g, cfg=cfg, wrt=wrt):
                return abt.flux_step_linearized(
                    cfg, *(g[n] for n in names[:6]), wrt=wrt,
                    rad_sw=g["rad_sw"], rad_lw=g["rad_lw"], lon=g["lon"],
                    isecday_utc=43200, skin_state=abt.init_skin_state(
                        cfg, g["sst"].shape, g["sst"].dtype, dev))[1]
            d, ms = {}, {}
            for dt in (torch.float64, torch.float32):
                d[dt], ms[dt] = measure.timed_call(
                    lambda: lin(forcing[dt]))
            f = forcing[torch.float64]
            state = abt.init_skin_state(cfg, (NY, NX), torch.float64, dev)

            def at(delta, f=f, wrt=wrt, state=state, cfg=cfg):
                g = dict(f, **{wrt: f[wrt] + delta})
                return abt.flux_step(cfg, *(g[n] for n in names[:6]),
                                     rad_sw=g["rad_sw"], rad_lw=g["rad_lw"],
                                     lon=f["lon"], isecday_utc=43200,
                                     skin_state=state)[0]
            emit({"phase": "linearized", "call": "flux_step_linearized",
                  "algo": algo, "wrt": wrt, "shape": [NY, NX], "card": card,
                  "ms_fp64": ms[torch.float64], "ms_fp32": ms[torch.float32],
                  "fd_fp64": fd_check(wrt, d[torch.float64], at),
                  "fp32_vs_fp64": fp32_check(
                      wrt, d[torch.float32], d[torch.float64],
                      lambda idx, lin=lin: lin_witness(
                          lin, forcing[torch.float32], idx))})
            del d
    del forcing

    # flux_step_ice_linearized in Ts_i, ice_lg15, the cold forcing
    def ice_lin(g):
        return abt.flux_step_ice_linearized(
            "ice_lg15", 2.0, 10.0, *(g[n] for n in ICE_LIN_INPUTS[:6]),
            frice=g["frice"], niter=NITER, wrt="Ts_i")[1]
    d, ms, cold = {}, {}, {}
    for dt in (torch.float64, torch.float32):
        Ts_i, _, *rest = cold_forcing(dev, dt)      # no sst
        cold[dt] = dict(zip(ICE_LIN_INPUTS, (Ts_i, *rest)))
        d[dt], ms[dt] = measure.timed_call(lambda: ice_lin(cold[dt]))
    c64 = cold[torch.float64]
    emit({"phase": "linearized", "call": "flux_step_ice_linearized",
          "ice_algo": "ice_lg15", "wrt": "Ts_i", "shape": [NY, NX],
          "card": card, "ms_fp64": ms[torch.float64],
          "ms_fp32": ms[torch.float32],
          "fd_fp64": fd_check("Ts_i", d[torch.float64], lambda delta: (
              abt.flux_step_ice("ice_lg15", 2.0, 10.0, c64["Ts_i"] + delta,
                                *(c64[n] for n in ICE_LIN_INPUTS[1:6]),
                                frice=c64["frice"], niter=NITER)[0])),
          "fp32_vs_fp64": fp32_check(
              "Ts_i", d[torch.float32], d[torch.float64],
              lambda idx: lin_witness(ice_lin, cold[torch.float32], idx))})
    del d, cold, c64

    # aerobulk_model: 24 records with numpy inputs against the eager chain
    forcing, lon = series_forcing(dev)
    isd = list(range(0, 86400, 3600))
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    ref, _ = abt.run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                            backend="eager")
    lon_np = lon.cpu().numpy()
    call_ms = []
    for k in range(NT):
        rec = {n: x[k].cpu().numpy() for n, x in forcing.items()}
        got, ms_k = measure.timed_call(lambda: abt.aerobulk_model(
            k + 1, NT, "coare3p6", 2.0, 10.0, Niter=NITER, l_use_skin=True,
            isecday_utc=isd[k], lon=lon_np, **rec))
        call_ms.append(ms_k)
        for name, g in zip(("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s"), got):
            if not torch.equal(g, getattr(ref, name)[k]):
                fail(f"aerobulk_model record {k + 1}: {name} differs from "
                     "run_series(backend='eager')")
    if tapi._MODEL_STATE:
        fail(f"aerobulk_model: the registry holds {list(tapi._MODEL_STATE)} "
             "after jt == Nt")
    emit({"phase": "linearized", "call": "aerobulk_model", "algo": "coare3p6",
          "shape": [NY, NX], "records": NT, "card": card,
          "bitwise_equal_to_eager_series": True, "registry_empty": True,
          "ms_by_call": call_ms})
    del forcing, ref

    t0 = time.perf_counter()
    ref_t, exp_t, imp_t = implicit_coupling.main(days=8.0)
    emit({"phase": "linearized", "call": "implicit_coupling.main",
          "days": 8.0, "card": card, "seconds": time.perf_counter() - t0,
          "equilibrium_K": float(ref_t[-1]), "implicit_final_K":
          float(imp_t[-1]), "explicit_max_excursion_K":
          float(np.abs(exp_t - ref_t[-1]).max())})
    emit({"phase": "linearized", "seconds": time.perf_counter() - t_phase})

# ---------------------------------------------------------------------------
# phase 23: the host surfaces
# ---------------------------------------------------------------------------

def _written(path):
    """The columns of a series file the CLI wrote, as float64 arrays."""
    return {k: np.asarray(v, np.float64)
            for k, v in tio.read_forcing(path).items()}


def _tool_outputs(dev_name, tmp):
    """toy's table and the cx-vs-wind, coef-n10 and psi-stab files of the
    CLI on ``dev_name``: (printed table, {tool: parsed JSON})."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["--device", dev_name, "toy"])
    files = {}
    for tool in HOST_TOOLS:
        path = os.path.join(tmp, f"{tool}_{dev_name}.json")
        cli.main(["--device", dev_name, tool, "--out", path])
        with open(path) as fh:
            files[tool] = json.load(fh)
    return buf.getvalue(), files


def _tree_err(got, ref):
    """The largest |got - ref| / (1e-10 |ref| + 1e-10 max|ref|) over the
    numbers of two matching JSON trees, max|ref| per array: <= 1 is
    agreement at rtol 1e-10, with the same bound absolute against the
    array's scale where a value crosses zero (psi at zeta = 0, a
    difference of terms of order 10)."""
    if isinstance(ref, dict):
        return max(_tree_err(got[k], ref[k]) for k in ref)
    g, r = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = 1e-10 * (np.abs(r) + np.max(np.abs(r)))
    return float(np.max(np.abs(g - r) / np.where(scale > 0, scale, 1.0)))


def host_surfaces_phase(dev, card):
    """Phase 23: the CLI's series through kernel 1 at 721x1440 (resident
    and streamed), a device trace of one record, the C API at full width,
    the C++ binding on the card, and the table tools and validation runs on
    the card against the CPU.  Returns kernel 1's launches by path."""
    t_phase = time.perf_counter()
    launches = {}
    forcing, _ = series_forcing(dev)
    f64 = {k: v.double().reshape(NT, 1, -1) for k, v in forcing.items()}
    isd = list(range(0, NT * 3600, 3600))
    with tempfile.TemporaryDirectory() as tmp:
        # (a) the CLI's series at full width: 24 hourly fp32 records of
        # phase 4's forcing in an .npz under the forcing file's names
        src = os.path.join(tmp, "forcing.npz")
        t0 = time.perf_counter()
        np.savez(src, time=np.arange(NT) * 3600.0,
                 **{FILE_NAMES[k]: v.cpu().numpy() for k, v in forcing.items()})
        write_npz_s = time.perf_counter() - t0
        del forcing
        for algo in ("coare3p6", "ecmwf"):
            cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                                     use_skin=True)
            argv = ["series", src, "--algo", algo, "--skin", "--niter",
                    str(NITER)]
            runs, stages = {}, {}
            for run, extra in (("fused", ["--backend", "fused"]),
                               ("fused_chunk8", ["--backend", "fused",
                                                 "--chunk", str(CHUNK)]),
                               ("eager", [])):
                out = os.path.join(tmp, f"{algo}_{run}.npz")
                prof = profiling.Profiler()
                kfused.LAUNCHES = 0
                t0 = time.perf_counter()
                cli.main([*argv, *extra, "--out", out], profiler=prof)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                n = kfused.LAUNCHES
                if run != "eager":
                    if n != NT:
                        fail(f"cli series {algo} {run}: kernel 1 launched {n} "
                             f"times, not {NT}")
                    launches[f"cli series {algo} {run}"] = n
                runs[run] = _written(out)
                stages[run] = {"seconds": wall, "launches": n,
                               **{k: prof.totals[k] for k in prof.totals}}
            ref, _ = abt.run_series(cfg, f64, isecday_utc=isd,
                                    backend="fused")
            first = {k: getattr(ref, k).reshape(NT, -1)[:, 0].cpu().numpy()
                     for k in FIELDS[:6]}
            # the CLI's columns: Tau rebuilt on the host, as it does
            col = {"Qlat": first["QL"], "Qsen": first["QH"],
                   "Evap": first["Evap"], "T_s": first["T_s"],
                   "Tau": np.hypot(first["Tau_x"], first["Tau_y"])}
            for name, want in col.items():
                if not np.array_equal(runs["fused"][name], want):
                    fail(f"cli series {algo} --backend fused: {name} is not "
                         "bitwise run_series(backend='fused')")
                np.testing.assert_allclose(
                    runs["fused_chunk8"][name], runs["fused"][name],
                    rtol=1e-12, err_msg=f"cli series {algo} --chunk {CHUNK}")
            names = tuple(col)
            cols = parity([torch.from_numpy(runs["fused"][k]) for k in names],
                          [torch.from_numpy(runs["eager"][k]) for k in names],
                          torch.float64, names=names)
            eager, _ = abt.run_series(cfg, f64, isecday_utc=isd,
                                      backend="eager")
            grid = parity((ref.QL, ref.QH, ref.Tau_x, ref.Tau_y, ref.Evap,
                           ref.T_s),
                          (eager.QL, eager.QH, eager.Tau_x, eager.Tau_y,
                           eager.Evap, eager.T_s), torch.float64,
                          names=FIELDS[:6])
            del ref, eager, col
            emit({"phase": "host_surfaces", "part": "cli_series",
                  "algo": algo, "shape": [NY, NX], "records": NT,
                  "dtype": "torch.float64", "card": card,
                  "forcing_npz_write_s": write_npz_s, "runs": stages,
                  "written_bitwise_equal_to_run_series_fused": True,
                  "chunk8_vs_resident_rtol": 1e-12,
                  "written_fused_vs_eager": {
                      k: cols[k] for k in ("median_rel", "worst_sig_frac")},
                  "grid_fused_vs_eager": {
                      k: grid[k] for k in ("median_rel", "worst_sig_frac",
                                           "max_abs_err")}})
            torch.cuda.empty_cache()

        # (b) a device trace of one record of (a) through kernel 1
        prof = profiling.Profiler(trace_dir=os.path.join(tmp, "trace"))
        cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0,
                                 niter=NITER, use_skin=True)
        with prof.device_trace():
            abt.run_series(cfg, {k: v[:1] for k, v in f64.items()},
                           isecday_utc=isd[:1], backend="fused")
        with open(prof.traces[0]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        step = [e for e in kernels if "fused_step_kernel" in e.get("name", "")]
        if not step:
            fail("device trace: kernel 1 (fused_step_kernel) is not in the "
                 f"trace; its kernels: {[e.get('name') for e in kernels][:10]}")
        emit({"phase": "host_surfaces", "part": "device_trace", "card": card,
              "trace_bytes": os.path.getsize(prof.traces[0]),
              "kernel_events": len(kernels), "kernel_1_name": step[0]["name"],
              "kernel_1_us": [e.get("dur") for e in step]})

        # (c) the C API at full width: numpy buffers of 1,038,240 points
        # over the 24 records, COARE 3.6 + skin, against the eager series
        # with the reference's hardcoded clock
        ref, _ = abt.run_series(cfg, {k: v.reshape(NT, -1)
                                      for k, v in f64.items()},
                                isecday_utc=[12] * NT, backend="eager")
        n = NY * NX
        outs = {k: np.empty(n) for k in CAPI_OUTPUTS}
        per_record = []
        for k in range(NT):
            rec = {name: v[k].reshape(-1).cpu().numpy()
                   for name, v in f64.items()}
            t0 = time.perf_counter()
            capi.model_buffers(
                k + 1, NT, "coare3p6", 2.0, 10.0,
                *(rec[x] for x in ("sst", "t_zt", "hum_zt", "U_zu", "V_zu",
                                   "slp")),
                *(outs[x] for x in CAPI_OUTPUTS[:5]), niter=NITER,
                use_skin=True, rad_sw=rec["rad_sw"], rad_lw=rec["rad_lw"],
                T_s=outs["T_s"])
            per_record.append(time.perf_counter() - t0)
            for name in CAPI_OUTPUTS:
                if not np.array_equal(outs[name],
                                      getattr(ref, name)[k].cpu().numpy()):
                    fail(f"capi record {k + 1}: {name} is not bitwise the "
                         "eager series")
        if capi._STATE:
            fail(f"capi: the registry holds {list(capi._STATE)} after "
                 "jt == Nt")
        del ref
        emit({"phase": "host_surfaces", "part": "capi", "algo": "coare3p6",
              "points": n, "records": NT, "card": card,
              "bitwise_equal_to_eager_series": True, "registry_empty": True,
              "seconds_by_record": per_record})
    del f64
    torch.cuda.empty_cache()

    # (d) the C++ binding, built here, on the card
    missing = cxx.toolchain_missing()
    if missing:
        emit({"phase": "host_surfaces", "part": "cxx", "skipped": missing})
    else:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            exe = cxx.build_example(tmp)
            build_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = cxx.run_example(exe)
            run_s = time.perf_counter() - t0
        if res.returncode != 0:
            fail(f"cpp_torch example exited {res.returncode}: "
                 f"{res.stderr[-2000:]}")
        for want in CXX_GOLDEN:
            if want not in res.stdout:
                fail(f"cpp_torch example: {want!r} not printed:\n"
                     f"{res.stdout[-2000:]}")
        emit({"phase": "host_surfaces", "part": "cxx", "card": card,
              "build_s": build_s, "run_s": run_s, "printed": list(CXX_GOLDEN)})

    # (e) the table tools and three days of validation runs, card vs CPU
    # (one-point eager runs, launch-bound: ~11 s a day on the card)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        toy_gpu, files_gpu = _tool_outputs("cuda", tmp)
        tools_s = time.perf_counter() - t0
        toy_cpu, files_cpu = _tool_outputs("cpu", tmp)
    if toy_gpu != toy_cpu:
        fail(f"cli toy on cuda prints\n{toy_gpu}\nand on cpu\n{toy_cpu}")
    err = {t: _tree_err(files_gpu[t], files_cpu[t]) for t in HOST_TOOLS}
    if not max(err.values()) <= 1.0:
        fail(f"cli tools on cuda against cpu beyond rtol 1e-10: {err}")
    days = validation.idealized_forcing(nt=24 * VALIDATION_DAYS)
    t0 = time.perf_counter()
    gpu = {a: validation.run_idealized(a, days) for a in
           validation.OCEAN_ALGOS_ORDER}
    days_s = time.perf_counter() - t0
    cpu = {a: validation.run_idealized(a, days, device="cpu") for a in
           validation.OCEAN_ALGOS_ORDER}
    bands = {}
    for v in validation.FLUX_VARS:
        stack = np.stack([cpu[a][v] for a in validation.OCEAN_ALGOS_ORDER])
        bands[v] = {"lower": stack.min(0), "upper": stack.max(0)}
    verdicts = {a: validation.check_against_bands(gpu[a], bands)
                for a in gpu}
    if not all(all(v.values()) for v in verdicts.values()):
        fail(f"validation: a card run outside the CPU's bands: {verdicts}")
    days_err = {a: max(_tree_err(gpu[a][v], cpu[a][v])
                       for v in validation.FLUX_VARS) for a in gpu}
    if not max(days_err.values()) <= 1.0:
        fail(f"validation runs on cuda against cpu beyond rtol 1e-10: "
             f"{days_err}")
    emit({"phase": "host_surfaces", "part": "tools", "card": card,
          "toy_table_equal": True,
          "err_cuda_vs_cpu_in_rtol_1e-10": err,
          "tools_cuda_s": tools_s, "validation_days": VALIDATION_DAYS,
          "validation_cuda_s": days_s,
          "validation_err_cuda_vs_cpu_in_rtol_1e-10": days_err,
          "accepted_by_cpu_bands": list(verdicts)})
    emit({"phase": "host_surfaces", "seconds": time.perf_counter() - t_phase})
    return launches


# ---------------------------------------------------------------------------
# phase 24: multiple devices
# ---------------------------------------------------------------------------

#: the ranks' row blocks of the grid on a (2, 1) mesh (DTensor's layout:
#: 721 rows split 361 / 360)
TWO_RANK_ROWS = ((0, 361), (361, NY))


def spawn_ranks(tmp, scenario, world, timeout):
    """``world`` processes of ``distributed_worker``'s ``scenario`` on the
    card; returns each rank's OK report."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    outs = dw.spawn(["-m", "aerobulk_tpu_torch.distributed_worker", "run",
                     scenario, f"file://{tmp}/rendezvous_{scenario}",
                     str(world), tmp, "cuda"], world, timeout, env=env)
    return [dw.ok_line(out, r) for r, out in enumerate(outs)]


def rank_grid(tmp, part, key):
    """The whole grid of ``key`` from both ranks' row blocks of ``part``."""
    blocks = []
    for r in range(2):
        with np.load(os.path.join(tmp, f"{part}_rank{r}.npz")) as z:
            blocks.append(z[key])
    return np.concatenate(blocks, axis=-2)


def bitwise(what, got, ref):
    """``got`` (numpy, gathered from the ranks) bitwise equal to ``ref``
    (the single-process run's tensor), or fail with the largest gap."""
    ref = ref.detach().cpu().numpy()
    if got.shape != ref.shape:
        fail(f"sharded {what}: shape {got.shape}, not {ref.shape}")
    if not np.array_equal(got, ref, equal_nan=True):
        gap = float(np.nanmax(np.abs(got.astype(np.float64) - ref)))
        fail(f"sharded {what} differs from the single-process run "
             f"(largest |difference| {gap})")


def empty_block_check(dev, cfg):
    """One direct call of kernels 1 and 2 on an empty block (a rank whose
    share of the grid is empty): empty outputs, no launch counted."""
    ins = [torch.zeros((0, NX), device=dev) for _ in range(13)]
    before = (kfused.LAUNCHES, kfused.GRAD_LAUNCHES)
    outs, st = kfused.fused_flux_step(cfg, *ins[:8], lon=ins[8],
                                      skin_state=abt.SkinState(*ins[9:]))
    grads = kfused.fused_flux_step_grad(cfg, ins, ins[:10])
    torch.cuda.synchronize()
    if (kfused.LAUNCHES, kfused.GRAD_LAUNCHES) != before \
            or any(x.shape != (0, NX) for x in (*outs, *st, *grads)):
        fail("an empty block launched a kernel or returned a non-empty "
             "output")
    return {"outputs": 10, "gradients": 13, "shape": [0, NX],
            "launches": 0}


def single_process(dev, base, stream_in):
    """Phase 24's references, each one process on the whole grid: per
    algorithm the fused series (kernel 1), its value+grad (kernel 2) and
    the streamed feed of COARE 3.6 per wire; with their seconds."""
    refs, seconds = {}, {}
    forcing, lon = dw.series_forcing(base)
    isd = dw.isecday()
    sbase, slon, offs, sbase_dev, slon_dev = stream_in
    for algo in dw.ALGOS:
        cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                                 use_skin=True)
        abt.run_series(cfg, {k: v[:1] for k, v in forcing.items()},
                       isecday_utc=isd[:1], lon=lon, backend="fused")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = abt.run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                                 backend="fused")
        torch.cuda.synchronize()
        seconds[f"{algo} series"] = time.perf_counter() - t0
        refs[f"series_{algo}"] = (out, st)
        sst = forcing["sst"].clone().requires_grad_()
        state0 = abt.SkinState(*(x.clone().requires_grad_() for x in
                                 abt.init_skin_state(cfg, (NY, NX),
                                                     torch.float32, dev)))
        t0 = time.perf_counter()
        out, _ = abt.run_series(cfg, {**forcing, "sst": sst},
                                skin_state=state0, isecday_utc=isd, lon=lon,
                                backend="fused", fused_grad_backend="kernel")
        grads = torch.autograd.grad((out.QL + out.QH + out.Tau_x).sum(),
                                    (sst, *state0), materialize_grads=True)
        torch.cuda.synchronize()
        seconds[f"{algo} value+grad"] = time.perf_counter() - t0
        refs[f"grad_{algo}"] = grads
        del out, sst, state0
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    refs["feed"] = resident_reference(cfg, sbase_dev, offs, dw.NT, slon_dev)
    for wire in dw.WIRES:
        kw = dict(chunk=dw.CHUNK, backend="fused", wire=wire, lon=slon,
                  device=dev)
        tpipe.run_series_pipelined(cfg, streamed_records(sbase, offs,
                                                         dw.CHUNK), **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tpipe.run_series_pipelined(cfg, streamed_records(sbase, offs, dw.NT),
                                   **kw)
        torch.cuda.synchronize()
        seconds[f"feed {wire}"] = time.perf_counter() - t0
    return refs, seconds


def sharded_phase(dev, card):
    """Phase 24: the sharded paths at 721x1440 (sharding.sharded_run_series,
    its gradient, the sharded streamed feed, DCP checkpoints), as
    distributed_worker's ranks run them: two ranks sharing the card over
    gloo on a (2, 1) mesh, then one rank over NCCL on (1, 1); every output,
    state and gradient gathered from the ranks and held bitwise against
    one process on the whole grid, the feed at phase 19's gates.  Returns
    kernels 1 and 2's launches by path."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    emit({"phase": "sharded", "part": "empty_block",
          **empty_block_check(dev, cfg)})
    base = make_inputs(dev, torch.float32)
    sbase, slon, offs = measure.streamed_forcing(NREC)
    stream_in = (sbase, slon, offs,
                 {k: torch.as_tensor(v, device=dev) for k, v in sbase.items()},
                 torch.as_tensor(slon, device=dev))
    refs, single_s = single_process(dev, base, stream_in)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        # the forcing files each rank reads its slab of
        np.save(os.path.join(tmp, "base.npy"),
                np.stack([x.cpu().numpy() for x in base]))
        np.save(os.path.join(tmp, "stream.npy"),
                np.stack([sbase[k] for k in dw.STREAM] + [slon]))
        np.savez(os.path.join(tmp, "stream_offsets.npz"), **offs)

        # (b)-(e) two ranks sharing the card, gloo, mesh (2, 1)
        t0 = time.perf_counter()
        reports = spawn_ranks(tmp, "two_ranks", 2, timeout=420)
        two_s = time.perf_counter() - t0
        for r, rep in enumerate(reports):
            if tuple(rep["slab"]) != (*TWO_RANK_ROWS[r], 0, NX):
                fail(f"rank {r} holds the slab {rep['slab']}")
            for key, n in {**rep["launches"],
                           **rep["grad_launches"]}.items():
                if n != dw.NT:
                    fail(f"rank {r}: {key} launched {n} times, not "
                         f"{dw.NT}")
                launches[f"{key} rank {r} of 2"] = n
        for algo in dw.ALGOS:
            out, st = refs[f"series_{algo}"]
            for n in dw.OUT:
                bitwise(f"{algo} {n}", rank_grid(tmp, f"series_{algo}", n),
                        getattr(out, n))
            for n, x in zip(abt.SkinState._fields, st):
                bitwise(f"{algo} final {n}",
                        rank_grid(tmp, f"series_{algo}", f"state_{n}"), x)
            for n, g in zip(("sst",) + abt.SkinState._fields,
                            refs[f"grad_{algo}"]):
                bitwise(f"{algo} gradient of {n}",
                        rank_grid(tmp, f"grad_{algo}", f"d_{n}"), g)
        emit({"phase": "sharded", "part": "two_ranks", "mesh": [2, 1],
              "backend": "gloo", "card": card, "records": dw.NT,
              "slabs": [rep["slab"] for rep in reports],
              "launches": [rep["launches"] for rep in reports],
              "grad_launches": [rep["grad_launches"] for rep in reports],
              "series_and_state_bitwise": True, "gradients_bitwise": True})
        out, st = refs["series_coare3p6"]
        for n in dw.OUT:
            bitwise(f"resumed {n}", rank_grid(tmp, "resume", n),
                    getattr(out, n)[dw.HALF:])
        for n, x in zip(abt.SkinState._fields, st):
            bitwise(f"resumed final {n}",
                    rank_grid(tmp, "resume", f"state_{n}"), x)
        for r in range(2):
            with np.load(os.path.join(tmp, f"resume_rank{r}.npz")) as z:
                if not bool(z["restored_equal"]):
                    fail(f"rank {r}: the restored checkpoint differs from "
                         "the saved state")
        feed = {}
        for wire in dw.WIRES:
            got = [torch.as_tensor(rank_grid(tmp, f"feed_{wire}", k),
                                   device=dev) for k in dw.STREAM_OUT]
            check = parity(got, refs["feed"], torch.float32,
                           names=dw.STREAM_OUT,
                           gate=STREAMED_GATES[wire != "f32"])
            feed[wire] = {k: check[k] for k in ("median_rel",
                                                "worst_sig_frac",
                                                "max_abs_err", "gate")}
            del got
        emit({"phase": "sharded", "part": "feed", "mesh": [2, 1],
              "chunk": dw.CHUNK, "records": dw.NT, "card": card,
              "vs_resident_single_process": feed})

        # (a) and (e) one rank, NCCL, mesh (1, 1)
        t0 = time.perf_counter()
        one, = spawn_ranks(tmp, "one_rank", 1, timeout=240)
        one_s = time.perf_counter() - t0
        for key, n in one["launches"].items():
            if n != dw.NT:
                fail(f"one rank: {key} launched {n} times, not {dw.NT}")
            launches[f"{key} rank 0 of 1"] = n
        if not all(one["bitwise"].values()):
            fail(f"one rank: not bitwise {one['bitwise']}")
        emit({"phase": "sharded", "part": "one_rank", "mesh": [1, 1],
              "backend": "nccl", "card": card, "launches": one["launches"],
              "bitwise": one["bitwise"]})
        emit({"phase": "sharded", "part": "checkpoint",
              "saved_after": dw.HALF, "resumed_on": [[2, 1], [1, 1]],
              "format": "torch.distributed.checkpoint", "bitwise": True})
    # (f) seconds: two ranks time-slice one card, so this is no scaling
    # figure
    emit({"phase": "sharded", "part": "seconds", "card": card,
          "note": "two ranks time-slicing one card, not a scaling figure",
          "single_process": single_s,
          "two_ranks_per_rank": [rep["seconds"] for rep in reports],
          "one_rank": one["seconds"],
          "two_ranks_processes_s": two_s, "one_rank_process_s": one_s,
          "phase_s": time.perf_counter() - t_phase})
    del refs, base, stream_in
    return launches


# ---------------------------------------------------------------------------
# phase 25: the bench
# ---------------------------------------------------------------------------

#: the bench runs of phase 25, by cli flags
#: the bench's modes that phase 25 runs; --grad only its two kernel variants
#: (each held by the gradient gate): the plain ones launch no kernel, and the
#: bench alone and the pinned matrix time them
BENCH_RUNS = ([], ["--all"], ["--grad", "--variants=fused_kernel,fused_eager"],
              ["--bf16"], ["--streamed"])
#: the launches a run of each bench row makes, by kernel (the --grad line's
#: by variant)
BENCH_LAUNCHES = {
    "coare3p6_skin_0p25deg_grid_points_per_s_per_chip": {"fused_step": 20},
    "ncar_small_grid_points_per_s": {"fused_bulk": 128},
    "coare3p0_bulk_1deg_points_per_s": {"fused_bulk": 32},
    "coare3p6_skin_0p25deg_points_per_s": {"fused_step": 20},
    "ecmwf_skin_0p25deg_points_per_s": {"fused_step_ecmwf": 20},
    "mixed_ice_ocean_0p25deg_points_per_s": {"fused_mixed": 10},
    "ice_lg15_0p25deg_points_per_s": {"fused_ice": 80},
    "coare3p6_skin_0p25deg_value_and_grad_points_per_s": {
        "fused_kernel": {"fused_step": 8, "fused_grad": 8},
        "fused_eager": {"fused_step": 8}},
    "ncar_small_grid_bf16_points_per_s": {},
    "coare3p0_bulk_1deg_bf16_points_per_s": {},
    "coare3p6_skin_0p25deg_streamed_points_per_s": {"fused_step": 48},
}


def bench_phase(card):
    """Phase 25: the bench's modes through ``cli bench`` with parity on.
    Fails if a line's check is false or missing where a kernel ran, if its
    launches are not its row's, if it does not name this card, or if a
    kernel's counter over the phase falls short of its rows' timed runs.
    Returns each row's launches a run by kernel, then row."""
    t_phase = time.perf_counter()
    before = launch_counts()
    launches, timed = {}, {}
    for flags in BENCH_RUNS:
        t0 = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(["bench", *flags])
        lines = [json.loads(ln) for ln in out.getvalue().splitlines()
                 if ln.startswith("{")]
        if not lines:
            fail(f"bench {flags}: no line")
        for rec in lines:
            metric = rec["metric"]
            if f"{rec['card']['name']}, {rec['card']['power_limit']}" != card:
                fail(f"bench {metric}: card {rec['card']}, not {card}")
            want = BENCH_LAUNCHES[metric]
            runs = ({v: rec[f"{v}_launches"] for v in want}
                    if "value_and_grad" in metric else {"": rec["launches"]})
            if runs != ({"": want} if "" in runs else want):
                fail(f"bench {metric}: launches {runs}, not {want}")
            checks = {k: v for k, v in rec.items() if k.endswith("_ok")}
            if any(runs.values()) and not checks:
                fail(f"bench {metric}: a kernel ran and nothing checked it")
            if not all(v is True for v in checks.values()):
                fail(f"bench {metric}: checks {checks}")
            for variant, counts in runs.items():
                for kernel, n in counts.items():
                    label = f"bench {metric}{' ' + variant if variant else ''}"
                    launches.setdefault(kernel, {})[f"{label} (phase 25)"] = n
                    base = kernel.removesuffix("_ecmwf")
                    timed[base] = timed.get(base, 0) + n * rec["repeats"]
            emit({"phase": "bench", "flags": flags, **rec})
        emit({"phase": "bench", "flags": flags, "part": "seconds",
              "seconds": time.perf_counter() - t0})
    counters = {k: n - before[k] for k, n in launch_counts().items()}
    short = {k: (counters[k], n) for k, n in timed.items() if counters[k] < n}
    if short or set(timed) != set(counters):
        fail(f"bench: counters {counters} against the rows' timed runs "
             f"{timed}")
    emit({"phase": "bench", "part": "launches", "counters": counters,
          "rows_timed_runs": timed, "card": card,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; this script runs only on a GPU")
    dev = torch.device("cuda", 0)

    # --- 1. device ----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    device_name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "torch_device": device_name,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    sources = {}
    for source in _build.SOURCES:
        _build.load_library(source)
        log = _build.library_path(source).with_suffix(".log")
        text = log.read_text() if log.exists() else ""
        wall = re.search(r"nvcc wall seconds: ([\d.]+)", text)
        # each source's flags beyond nvcc_flags, and each kernel's
        # instantiation (mangled) with its registers and spill bytes
        sources[source] = {
            "flags": list(_build.SOURCE_FLAGS.get(source, ())),
            "nvcc_seconds": float(wall.group(1)) if wall else None,
            "registers_spill_stores_spill_loads": _build.ptxas_report(text)}
    emit({"phase": "build", "seconds": build_s, "grad_mode": "reverse",
          "nvcc_flags": list(_build.NVCC_FLAGS), "sources": sources})

    # --- 3. kernel vs plain, one step, fp64 and fp32 --------------------------
    cfg = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
    par = {}
    for dtype in (torch.float64, torch.float32):
        args = make_inputs(dev, dtype)
        state = abt.init_skin_state(cfg, (NY, NX), dtype, dev)
        kw = dict(lon=args[8], isecday_utc=43200, skin_state=state)
        outs, st = kfused.fused_flux_step(cfg, *args[:8], **kw)
        pouts, pst = kfused.fused_flux_step_plain(cfg, *args[:8], **kw)
        torch.cuda.synchronize()
        par[dtype] = parity((*outs, *st), (*pouts, *pst), dtype)
        emit({"phase": "parity", "dtype": str(dtype), **par[dtype]})
    del args, state, outs, st, pouts, pst

    # --- 4. the main path: 24 hourly records, fp32, fused backend ------------
    forcing, lon = series_forcing(dev)
    isd = list(range(0, 86400, 3600))
    series_lon = lon
    kfused.LAUNCHES = 0
    t0 = time.perf_counter()
    f_out, f_state = abt.run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                                    backend="fused")
    torch.cuda.synchronize()
    series_s = time.perf_counter() - t0
    launches = kfused.LAUNCHES
    if launches != NT:
        fail(f"main path launched the kernel {launches} times, not {NT}")
    f_fields = (f_out.QL, f_out.QH, f_out.Tau_x, f_out.Tau_y, f_out.Evap,
                f_out.T_s, *f_state)
    for fname, x in zip(FIELDS, f_fields):
        if not bool(torch.isfinite(x).all()):
            fail(f"main path: {fname} is not finite everywhere")

    e_out, e_state = abt.run_series(cfg, forcing, isecday_utc=isd, lon=lon,
                                    backend="eager")
    torch.cuda.synchronize()
    dT = e_out.diag.dT_wl
    built = int((dT > 0).sum())
    resets = int(((dT[:-1] > 0) & (dT[1:] == 0)).sum())
    fused_built = int((f_state.dT_wl > 0).sum())
    if built == 0 or fused_built == 0 or resets == 0:
        fail(f"warm layer: built {built} (fused final {fused_built}), "
             f"resets {resets}")
    last = lambda o: (o.QL[-1], o.QH[-1], o.Tau_x[-1], o.Tau_y[-1],
                      o.Evap[-1], o.T_s[-1])
    series_par = parity((*last(f_out), *f_state), (*last(e_out), *e_state),
                        torch.float32)
    emit({"phase": "series", "records": NT, "launches": launches,
          "seconds_fused_series": series_s, "wl_built_point_records": built,
          "wl_built_points_fused_final": fused_built,
          "wl_resets": resets,
          "max_dT_wl_fused_final": float(f_state.dT_wl.max()),
          "vs_eager": series_par})
    del f_out, e_out, f_fields, dT, e_state

    # --- 5. timing: one step, kernel and plain, fp32 (the main path) and fp64
    times = {}
    cfg20 = abt.AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=20,
                               use_skin=True)
    for dtype in (torch.float32, torch.float64):
        *args, lon = make_inputs(dev, dtype)
        state = abt.init_skin_state(cfg, (NY, NX), dtype, dev)
        kw = dict(lon=lon, isecday_utc=43200, skin_state=state)
        k_ms = cuda_ms(lambda: kfused.fused_flux_step(cfg, *args, **kw), 20)
        p_ms = cuda_ms(lambda: kfused.fused_flux_step_plain(cfg, *args, **kw),
                       3)
        # the reference's converged setting (bench.py --niter 20)
        k20_ms = cuda_ms(lambda: kfused.fused_flux_step(cfg20, *args, **kw),
                         20)
        times[dtype] = (k_ms, p_ms, k20_ms)
        emit({"phase": "timing", "dtype": str(dtype), "shape": [NY, NX],
              "card": card, "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_points_per_s": NY * NX / (k_ms * 1e-3),
              "plain_points_per_s": NY * NX / (p_ms * 1e-3),
              "kernel_ms_niter20": k20_ms})
    k_ms, p_ms, _ = times[torch.float32]
    del args, lon, state, kw

    # --- 6. gradient kernel vs plain autograd, one step; fp32 also against
    # the fp64 gradient at the fp32 inputs, its worst points stepped --------
    gpar = {}
    isd0 = 43200
    for dtype in (torch.float64, torch.float32):
        args = make_inputs(dev, dtype)
        cts = cotangents((NY, NX), dtype, dev, seed=7)
        states = {"fresh": abt.init_skin_state(cfg, (NY, NX), dtype, dev),
                  "series_final": abt.SkinState(*(x.to(dtype)
                                                  for x in f_state))}
        if not bool((states["fresh"].Hz_wl == HWL_MAX).all()):
            fail("a fresh state does not sit at the Hz_wl == HWL_MAX tie")
        for sname, st in states.items():
            gpar[(dtype, sname)] = grad_step_check(
                "grad_parity", cfg, args, st, cts, isd0, sname)
        del args, cts, states, st
    for line in worst_grad_points(cfg, isd0, gpar, dev):
        emit({"phase": "grad_parity", "part": "worst_point", **line})

    # --- 7. the gradient main path: value+grad of the 24-record series -------
    # the fp64 yardstick of the fp32 series gradients: the same records
    # upcast through kernels 1 and 2 in fp64 (each held to its plain version
    # at the fp64 gates in phases 3 and 6; the eager remat series in fp64
    # would take tens of seconds)
    loss_of = lambda out: (out.QL + out.QH + out.Tau_x).sum()
    grads = {}
    fused_kw = dict(backend="fused", fused_grad_backend="kernel")
    for path, dtype, kw in (
            ("fused", torch.float32, fused_kw),
            ("eager_remat", torch.float32, dict(backend="eager", remat=True)),
            ("fp64", torch.float64, fused_kw)):
        # copies: a fresh state's zero fields share one tensor
        sst_series = forcing["sst"].to(dtype, copy=True).requires_grad_()
        state0 = abt.SkinState(*(x.to(dtype, copy=True).requires_grad_()
                                 for x in abt.init_skin_state(
                                     cfg, (NY, NX), torch.float32, dev)))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if path == "fused":
            kfused.GRAD_LAUNCHES = 0
        t0 = time.perf_counter()
        out, _ = abt.run_series(cfg, {**{k: v.to(dtype) for k, v in
                                         forcing.items()},
                                      "sst": sst_series},
                                skin_state=state0, isecday_utc=isd,
                                lon=series_lon.to(dtype), **kw)
        loss = loss_of(out)
        g = torch.autograd.grad(loss, (sst_series, *state0))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if path == "fused":
            grad_launches = kfused.GRAD_LAUNCHES
            if grad_launches != NT:
                fail(f"gradient main path launched the gradient kernel "
                     f"{grad_launches} times, not {NT}")
        for gname, x in zip(("sst",) + GRADS[9:], g):
            if not bool(torch.isfinite(x).all()):
                fail(f"{path} series gradient of {gname} is not finite")
        grads[path] = (float(loss.detach()), g, seconds,
                       torch.cuda.max_memory_allocated())
        del out, loss, g, sst_series, state0
    loss_f, g_f, s_f, mem_f = grads["fused"]
    loss_e, g_e, s_e, mem_e = grads["eager_remat"]
    series_gpar = grad_parity(g_f, g_e, ("sst",) + GRADS[9:], torch.float32,
                              yard=grads["fp64"][1], gate=False)
    emit({"phase": "grad_series", "records": NT,
          "grad_launches": grad_launches, "loss_fused": loss_f,
          "loss_eager_remat": loss_e, "seconds_fused": s_f,
          "seconds_eager_remat": s_e, "max_memory_allocated_fused": mem_f,
          "max_memory_allocated_eager_remat": mem_e,
          "seconds_fp64_yardstick": grads["fp64"][2],
          "vs_eager_remat": series_gpar})
    del grads, g_f, g_e, forcing, f_state

    # --- 8. timing: one value+grad step, fp32 (the main path) and fp64 -------
    gtimes = {}
    for dtype in (torch.float32, torch.float64):
        ins = (*make_inputs(dev, dtype),
               *abt.init_skin_state(cfg, (NY, NX), dtype, dev))
        cts = cotangents((NY, NX), dtype, dev, seed=8)
        leaves = [x.clone().requires_grad_() for x in ins]

        def value_and_grad(step, **kw):
            outs, _ = step(cfg, *leaves[:8], lon=leaves[8],
                           isecday_utc=isd0,
                           skin_state=abt.SkinState(*leaves[9:]), **kw)
            return torch.autograd.grad((outs[0] + outs[1]).sum(), leaves,
                                       materialize_grads=True)

        rec = {
            "value_grad_kernel_ms": cuda_ms(
                lambda: value_and_grad(kfused.fused_flux_step), 5),
            "value_grad_eager_backward_ms": cuda_ms(
                lambda: value_and_grad(kfused.fused_flux_step,
                                       grad_backend="eager"), 2),
            "value_grad_plain_ms": cuda_ms(
                lambda: value_and_grad(kfused.fused_flux_step_plain), 2),
            "plain_vjp_ms": cuda_ms(
                lambda: kfused.fused_flux_step_vjp_plain(
                    cfg, ins[:9], abt.SkinState(*ins[9:]), cts, isd0), 2),
        }
        rec["grad_kernel_ms"] = cuda_ms(
            lambda: kfused.fused_flux_step_grad(cfg, ins, cts, isd0), 5)
        for key in ("value_grad_kernel_ms", "value_grad_eager_backward_ms",
                    "value_grad_plain_ms"):
            rec[key.replace("_ms", "_points_per_s")] = \
                NY * NX / (rec[key] * 1e-3)
        rec["grad_bound_ms"], rec["grad_bound_by"] = bound(
            OPS_PER_POINT["grad_skin_coare3p6"], 36, NY * NX, dtype)
        rec["grad_bound_forward_mode_ms"] = bound(
            OPS_PER_POINT["skin_coare3p6"] * FORWARD_MODE_FACTOR, 36, NY * NX,
            dtype)[0]
        rec["grad_share_of_bound"] = rec["grad_bound_ms"] / \
            rec["grad_kernel_ms"]
        gtimes[dtype] = rec
        emit({"phase": "grad_timing", "dtype": str(dtype), "shape": [NY, NX],
              "card": card, "mode": "reverse", **rec})
        del ins, cts, leaves

    # --- 9. the stateless kernel vs plain on the month, and its main path ----
    points = NT_MONTH * NY1 * NX1
    bpar = {}
    for dtype in (torch.float64, torch.float32):
        month = month_forcing(dev, dtype)
        args = [month[n] for n in BULK_INPUTS]
        for algo in ALGOS:
            bcfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0,
                                      niter=NITER)
            got = kfused.fused_bulk_step(bcfg, *args)
            ref = kfused.fused_bulk_step_plain(bcfg, *args)
            torch.cuda.synchronize()
            bpar[(algo, dtype)] = parity(got, ref, dtype)
            emit({"phase": "bulk_parity", "algo": algo, "dtype": str(dtype),
                  "shape": [NT_MONTH, NY1, NX1],
                  **bpar[(algo, dtype)]})
            del got, ref
        if dtype == torch.float64:
            month64 = {n: x.cpu() for n, x in month.items()}
        del month, args
    # F3: NCAR's first significant fp32 QH points, stepped three ways
    for point in bpar[("ncar", torch.float32)]["fields"]["QH"].get(
            "sig_first_points", []):
        emit({"phase": "bulk_parity", "part": "ncar_f3", **ncar_f3(
            dev, point, [float(month64[n][tuple(point)])
                         for n in BULK_INPUTS])})
    del month64

    # the main path: one run_series(batch_records=True, backend="fused") on
    # the fp32 month per algorithm, one launch each
    month = month_forcing(dev, torch.float32)
    kfused.BULK_LAUNCHES = 0
    series = {}
    t0 = time.perf_counter()
    for algo in ALGOS:
        bcfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER)
        out, _ = abt.run_series(bcfg, month, batch_records=True,
                                backend="fused")
        torch.cuda.synchronize()
        series[algo] = [getattr(out, n) for n in BULK_FIELDS]
    series_s = time.perf_counter() - t0
    bulk_launches = kfused.BULK_LAUNCHES
    if bulk_launches != len(ALGOS):
        fail(f"the stateless main path launched the kernel {bulk_launches} "
             f"times for {len(ALGOS)} series, not once each")
    for algo in ALGOS:
        for fname, x in zip(BULK_FIELDS, series[algo]):
            if tuple(x.shape) != (NT_MONTH, NY1, NX1) or \
                    not bool(torch.isfinite(x).all()):
                fail(f"stateless main path, {algo}: {fname} has shape "
                     f"{tuple(x.shape)} or is not finite everywhere")
        bcfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER)
        eager, _ = abt.run_series(bcfg, month, batch_records=True,
                                  backend="eager")
        res = parity(series[algo],
                     [getattr(eager, n) for n in BULK_FIELDS], torch.float32)
        emit({"phase": "bulk_series", "algo": algo, "records": NT_MONTH,
              "launches": 1, "vs_eager": res})
        del eager
    emit({"phase": "bulk_series", "algos": list(ALGOS),
          "launches": bulk_launches, "seconds_fused_series": series_s})
    del series, month

    # a year of hourly records at one buoy (NCAR), the scalar slp broadcast
    buoy = month_forcing(dev, torch.float32, nt=BUOY_RECORDS, shape=(),
                         seed=11)
    bcfg = abt.AeroBulkConfig(algo="ncar", zt=2.0, zu=10.0, niter=NITER)
    buoy_args = [buoy[n] for n in BULK_INPUTS[:5]] + [101325.0]
    got = kfused.fused_bulk_step(bcfg, *buoy_args)
    ref = kfused.fused_bulk_step_plain(bcfg, *buoy_args)
    torch.cuda.synchronize()
    if any(tuple(x.shape) != (BUOY_RECORDS,) for x in got):
        fail("the buoy series came back in another shape")
    emit({"phase": "bulk_parity", "algo": "ncar", "dtype": "torch.float32",
          "shape": [BUOY_RECORDS], "slp": 101325.0,
          **parity(got, ref, torch.float32)})
    del buoy, buoy_args, got, ref

    # --- 10. timing: one launch on the month, per algorithm and dtype ------
    btimes = {}
    for dtype in (torch.float32, torch.float64):
        month = month_forcing(dev, dtype)
        args = [month[n] for n in BULK_INPUTS]
        for algo in ALGOS:
            bcfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0,
                                      niter=NITER)
            kb_ms = cuda_ms(lambda: kfused.fused_bulk_step(bcfg, *args), 10)
            pb_ms = cuda_ms(lambda: kfused.fused_bulk_step_plain(bcfg, *args),
                            3)
            b_ms, b_by = bound(OPS_PER_POINT[algo], 12, points, dtype)
            btimes[(algo, dtype)] = (kb_ms, pb_ms, b_ms, b_by)
            emit({"phase": "bulk_timing", "algo": algo, "dtype": str(dtype),
                  "shape": [NT_MONTH, NY1, NX1], "card": card,
                  "kernel_ms": kb_ms, "plain_ms": pb_ms,
                  "kernel_points_per_s": points / (kb_ms * 1e-3),
                  "plain_points_per_s": points / (pb_ms * 1e-3),
                  "bound_ms": b_ms, "bound_by": b_by})
        del month, args

    # --- 11. the ice kernel vs plain, seven algorithms, fp64 and fp32 -------
    ipar = {}
    f64 = cold_forcing(dev, torch.float64)
    for dtype in (torch.float64, torch.float32):
        f = cold_forcing(dev, dtype)
        for algo in ICE_REGISTRY:
            got = ice_call(kfused.fused_ice_step, algo, f)
            ref = ice_call(kfused.fused_ice_step_plain, algo, f)
            torch.cuda.synchronize()
            ipar[(algo, dtype)] = parity(got, ref, dtype,
                                         kfused.ICE_OUTPUTS)
            emit({"phase": "ice_parity", "algo": algo, "dtype": str(dtype),
                  "shape": [NY, NX],
                  **({"algo_kw": EASY_KW} if algo == "ice_easy" else {}),
                  **ipar[(algo, dtype)]})
            if dtype == torch.float32:
                for line in sig_point_lines(
                        ipar[(algo, dtype)], kfused.ICE_OUTPUTS, got, ref, f64,
                        lambda pt, algo=algo: ice_call(
                            kfused.fused_ice_step_plain, algo, pt)):
                    emit({"phase": "ice_parity", "part": "sig_point",
                          "algo": algo, **line})
            del got, ref
        del f

    # --- 12. the mixed kernel vs plain, then the main path of config 5 -------
    mixed_cases = ([("ice_lg15", "ecmwf", False), ("ice_lg15", "ecmwf", True)]
                   + [(a, "ecmwf", False) for a in ICE_REGISTRY
                      if a != "ice_lg15"]
                   + [("ice_lg15", o, False) for o in ALGOS if o != "ecmwf"])
    mpar = {}
    for dtype in (torch.float64, torch.float32):
        f = cold_forcing(dev, dtype)
        for ice_algo, ocean_algo, simul in mixed_cases:
            kw = dict(ice_algo=ice_algo, ocean_algo=ocean_algo,
                      simultaneous=simul)
            before = kfused.MIXED_LAUNCHES
            got = mixed_call(kfused.fused_mixed_step, f, **kw)
            if kfused.MIXED_LAUNCHES != before + 1:
                fail(f"fused_mixed_step launched its kernel "
                     f"{kfused.MIXED_LAUNCHES - before} times in one call")
            ref = mixed_call(kfused.fused_mixed_step_plain, f, **kw)
            torch.cuda.synchronize()
            res = parity(got, ref, dtype, kfused.MIXED_OUTPUTS)
            mpar[(ice_algo, ocean_algo, simul, dtype)] = res
            emit({"phase": "mixed_parity", "dtype": str(dtype),
                  "shape": [NY, NX], **kw, **res})
            if dtype == torch.float32:
                for line in sig_point_lines(
                        res, kfused.MIXED_OUTPUTS, got, ref, f64,
                        lambda pt, kw=kw: mixed_call(
                            kfused.fused_mixed_step_plain, pt, **kw)):
                    emit({"phase": "mixed_parity", "part": "sig_point",
                          **kw, **line})
            del got, ref
        del f
    del f64

    # the main path: BASELINE config 5 (LG15 ice + ECMWF leads) and its
    # ice-only companion, fp32, one call of each entry point
    f = cold_forcing(dev, torch.float32)
    kfused.MIXED_LAUNCHES = 0
    kfused.ICE_LAUNCHES = 0
    t0 = time.perf_counter()
    main_mixed = mixed_call(kfused.fused_mixed_step, f)
    main_ice = ice_call(kfused.fused_ice_step, "ice_lg15", f)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    mixed_launches, ice_launches = kfused.MIXED_LAUNCHES, kfused.ICE_LAUNCHES
    if mixed_launches != 1 or ice_launches != 1:
        fail(f"the ice main path launched the mixed kernel {mixed_launches} "
             f"and the ice kernel {ice_launches} times, not once each")
    for names, outs in ((kfused.MIXED_OUTPUTS, main_mixed),
                        (kfused.ICE_OUTPUTS, main_ice)):
        for fname, x in zip(names, outs):
            if tuple(x.shape) != (NY, NX) or \
                    not bool(torch.isfinite(x).all()):
                fail(f"ice main path: {fname} has shape {tuple(x.shape)} "
                     f"or is not finite everywhere")
    main_par = {
        "mixed": parity(main_mixed, mixed_call(kfused.fused_mixed_step_plain,
                                               f), torch.float32,
                        kfused.MIXED_OUTPUTS),
        "ice": parity(main_ice, ice_call(kfused.fused_ice_step_plain,
                                         "ice_lg15", f), torch.float32,
                      kfused.ICE_OUTPUTS)}
    emit({"phase": "ice_main_path", "shape": [NY, NX],
          "mixed_launches": mixed_launches, "ice_launches": ice_launches,
          "seconds": main_s, "ice_fraction_mean": float(f[7].mean()),
          "vs_plain": main_par})
    del f, main_mixed, main_ice

    # --- 13. timing: every ice algorithm and the timed mixed cells, the
    # kernel alone (CUDA-graph slope) and the wrapper call; the plain
    # versions of the main path's three
    itimes = {}
    for dtype in (torch.float32, torch.float64):
        f = cold_forcing(dev, dtype)
        Ts_i, _, t, q, u, v, slp, frice = f
        runs = {}
        for algo in ICE_REGISTRY:
            kw = EASY_KW if algo == "ice_easy" else {}
            runs[algo] = (
                "ice_step.cu", algo,
                lambda algo=algo: ice_call(kfused.fused_ice_step, algo, f),
                lambda algo=algo, kw=kw: kfused.ice_step_launch(
                    algo, 2.0, 10.0, Ts_i, t, q, u, v, slp, frice=frice,
                    niter=NITER, **kw)[0],
                lambda algo=algo: ice_call(kfused.fused_ice_step_plain, algo,
                                           f))
        for ice_algo, ocean_algo, simul in TIMED_MIXED:
            kw = dict(ice_algo=ice_algo, ocean_algo=ocean_algo,
                      simultaneous=simul)
            runs["mixed_lg15_io" if simul else
                 f"mixed_{ice_algo}_{ocean_algo}"] = (
                kfused.mixed_source(ocean_algo, simul), ice_algo,
                lambda kw=kw: mixed_call(kfused.fused_mixed_step, f, **kw),
                lambda kw=kw: kfused.mixed_step_launch(
                    2.0, 10.0, *f, niter=NITER, **kw)[0],
                lambda kw=kw: mixed_call(kfused.fused_mixed_step_plain, f,
                                         **kw))
        for name, (source, ice_algo, call, bind, plain) in runs.items():
            rec = {"kernel_ms": measure.graph_ms(bind()),
                   "wrapper_call_ms": cuda_ms(call, 20),
                   "launch_shape": kfused.launch_shape(source, ice_algo,
                                                       dtype)}
            rec["kernel_points_per_s"] = NY * NX / (rec["kernel_ms"] * 1e-3)
            if name in OPS_PER_POINT:
                rec["bound_ms"], rec["bound_by"] = bound(
                    OPS_PER_POINT[name], 13, NY * NX, dtype)
                rec["share_of_bound"] = rec["bound_ms"] / rec["kernel_ms"]
            if name in MAIN_ICE_STEPS:
                rec["plain_ms"] = cuda_ms(plain, 3)
                rec["plain_points_per_s"] = NY * NX / (rec["plain_ms"] * 1e-3)
            itimes[(name, dtype)] = rec
            emit({"phase": "ice_timing", "step": name, "dtype": str(dtype),
                  "shape": [NY, NX], "card": card, **rec})
        del f, runs

    # --- 14-17. BASELINE config 4: ECMWF + skin through kernels 1 and 2 ------
    ecm = ecmwf_phases(dev, card, cfg)

    # --- 18. kernel 6 and the roofline of the kernels timed above ------------
    dtypes = (torch.float32, torch.float64)
    pps = lambda ms, points=NY * NX: points / (ms * 1e-3)
    timed = {
        "fused_step (coare3p6 + skin)": (
            "skin_coare3p6", "fused_step.cu",
            {dt: pps(times[dt][0]) for dt in dtypes}),
        # the port's own census of niter=20 (roofline.flux_step_counts)
        "fused_step (coare3p6 + skin, niter=20)": (
            roofline.flux_step_counts(algo="coare3p6", niter=20),
            "fused_step.cu", {dt: pps(times[dt][2]) for dt in dtypes}),
        "fused_grad (coare3p6 + skin)": (
            "grad_skin_coare3p6", "fused_grad.cu",
            {dt: pps(gtimes[dt]["grad_kernel_ms"]) for dt in dtypes}),
        "fused_step_ecmwf": ("skin_ecmwf", "fused_step_ecmwf.cu", {
            dt: pps(ecm["times"][dt]["kernel_ms"]) for dt in dtypes}),
        "fused_grad_ecmwf": ("grad_skin_ecmwf", "fused_grad_ecmwf.cu", {
            dt: pps(ecm["times"][dt]["grad_kernel_ms"]) for dt in dtypes}),
        **{f"fused_bulk ({algo})": (algo, "bulk_step.cu", {
            dt: pps(btimes[(algo, dt)][0], points) for dt in dtypes})
           for algo in ALGOS},
        **{f"{kern} ({name})": (name, source, {
            dt: pps(itimes[(name, dt)]["kernel_ms"]) for dt in dtypes})
           for kern, name, source in (
               ("fused_ice", "ice_lg15", "ice_step.cu"),
               ("fused_mixed", "mixed_ice_lg15_ecmwf", "mixed_step_ecmwf.cu"),
               ("fused_mixed", "mixed_lg15_io", "mixed_step_lg15_io.cu"))}}
    rl = roofline_phase(dev, card, timed)

    # --- 19. the streamed host feed through kernel 1 -------------------------
    streamed = streamed_phase(dev, card)

    # --- 20. kernel 1 over a month, a year and a month at full width -------
    long_launches = long_series_phase(dev, card)

    # --- 21. the validity envelope through kernels 1, 3, 4 and 5 ----------
    env = envelope_phase(dev, card)

    # --- 22. linearizations, aerobulk_model and implicit coupling ---------
    linearized_phase(dev, card)

    # --- 23. the host surfaces: CLI series, trace, C API, C++, tools ------
    host_launches = host_surfaces_phase(dev, card)

    # --- 24. multiple devices: ranks on the card through kernels 1 and 2 --
    sharded_launches = sharded_phase(dev, card)

    # --- 25. the bench: cli bench's modes through kernels 1-5 -------------
    bench_launches = bench_phase(card)

    def worst(table, keys, dtype, src):
        return max(table[(*k, dtype)][src] for k in keys)

    ice_keys = [(a,) for a in ICE_REGISTRY]

    def ice_entry(source, name, mangled):
        """The timing, launch shape, flags and ptxas of the main path's
        instantiation ``name`` of the ice or mixed kernel, fp32."""
        t = itimes[(name, torch.float32)]
        return {"ms": t["kernel_ms"], "wrapper_call_ms": t["wrapper_call_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "launch_shape": t["launch_shape"],
                "flags": sources[source]["flags"],
                "registers_spill_stores_spill_loads": next(
                    v for k, v in sources[source][
                        "registers_spill_stores_spill_loads"].items()
                    if re.search(mangled, k))}

    g32 = gpar[(torch.float32, "fresh")]
    g64 = gpar[(torch.float64, "fresh")]
    step_bound = bound(OPS_PER_POINT["skin_coare3p6"], 23, NY * NX,
                       torch.float32)
    grad_bound = bound(OPS_PER_POINT["grad_skin_coare3p6"], 36, NY * NX,
                       torch.float32)
    grad_bound_fwd = bound(OPS_PER_POINT["skin_coare3p6"] * FORWARD_MODE_FACTOR,
                           36, NY * NX, torch.float32)
    et32 = ecm["times"][torch.float32]
    eg32 = ecm["gpar"][(torch.float32, "fresh")]
    eg64 = ecm["gpar"][(torch.float64, "fresh")]
    kb_ms, pb_ms, b_ms, b_by = btimes[("coare3p0", torch.float32)]
    emit({"phase": "total", "seconds": time.perf_counter() - _CLOCK["start"],
          "card": card})
    emit({"kernels": [{
        "name": "fused_step", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/fused_step.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:45 (_kernel)",
        "launches": launches,
        "launches_by_path": {
            "run_series (phase 4)": launches,
            **{f"run_series_pipelined {k} (phase 19)": n
               for k, n in streamed.items() if k.startswith("coare3p6")},
            **{f"run_series {k} (phase 20)": n
               for k, n in long_launches.items() if "coare3p6" in k},
            "envelope (phase 21)": env["by_case"]["kernel 1 coare3p6 + skin"],
            **{f"{k} (phase 23)": n for k, n in host_launches.items()
               if "coare3p6" in k},
            **{f"sharded {k} (phase 24)": n
               for k, n in sharded_launches.items()
               if ("coare3p6" in k or "feed" in k) and "grad" not in k},
            **bench_launches["fused_step"]},
        "max_abs_err": par[torch.float32]["max_abs_err"],
        "median_rel_fp32": par[torch.float32]["median_rel"],
        "sig_frac_fp32": par[torch.float32]["worst_sig_frac"],
        "median_rel_fp64": par[torch.float64]["median_rel"],
        "sig_frac_fp64": par[torch.float64]["worst_sig_frac"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": step_bound[0],
        "bound_by": step_bound[1], "library_ms": None}, {
        "name": "fused_grad", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/fused_grad.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:256 (_grad_kernel)",
        "launches": grad_launches,
        "launches_by_path": {
            "run_series value+grad (phase 7)": grad_launches,
            **{f"sharded {k} (phase 24)": n
               for k, n in sharded_launches.items()
               if "coare3p6 value+grad" in k},
            **bench_launches["fused_grad"]},
        "max_abs_err": g32["max_abs_err"],
        "max_abs_err_fp64": g64["max_abs_err"],
        "worst_median_rel_fp32": max(
            r.get("median_rel", 0.0) for r in g32["fields"].values()),
        "worst_p99_rel_fp32": max(
            r.get("p99_rel", 0.0) for r in g32["fields"].values()),
        "worst_median_rel_fp64": max(
            r.get("median_rel", 0.0) for r in g64["fields"].values()),
        "ms": gtimes[torch.float32]["grad_kernel_ms"],
        "plain_ms": gtimes[torch.float32]["plain_vjp_ms"],
        "bound_ms": grad_bound[0], "bound_by": grad_bound[1],
        "bound_forward_mode_ms": grad_bound_fwd[0], "mode": "reverse",
        "library_ms": None}, {
        "name": "fused_bulk", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/bulk_step.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:524 (_bulk_kernel)",
        "launches": bulk_launches,
        "launches_by_path": {"run_series(batch_records=True) (phase 9)": bulk_launches,
                             "envelope (phase 21)": env["BULK_LAUNCHES"],
                             **bench_launches["fused_bulk"]},
        "max_abs_err": max(bpar[(a, torch.float32)]["max_abs_err"]
                           for a in ALGOS),
        **{f"worst_{key}_{tag}": max(bpar[(a, dt)][src] for a in ALGOS)
           for key, src in (("median_rel", "median_rel"),
                            ("sig_frac", "worst_sig_frac"))
           for tag, dt in (("fp32", torch.float32),
                           ("fp64", torch.float64))},
        "ms": kb_ms, "plain_ms": pb_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None}, {
        "name": "fused_ice", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/ice_step.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:181 (_ice_kernel)",
        "launches": ice_launches,
        "launches_by_path": {"fused_ice_step (phase 12)": ice_launches,
                             "envelope (phase 21)": env["ICE_LAUNCHES"],
                             **bench_launches["fused_ice"]},
        "max_abs_err": worst(ipar, ice_keys, torch.float32, "max_abs_err"),
        **{f"worst_{key}_{tag}": worst(ipar, ice_keys, dt, src)
           for key, src in (("median_rel", "median_rel"),
                            ("sig_frac", "worst_sig_frac"))
           for tag, dt in (("fp32", torch.float32),
                           ("fp64", torch.float64))},
        **ice_entry("ice_step.cu", "ice_lg15",
                    rf"ice_step_kernelIfLi{kfused._ICE_ALGOS['ice_lg15']}E"),
        "library_ms": None}, {
        "name": "fused_mixed", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/mixed_step_ecmwf.cu "
                  "(+ mixed_step.cuh)",
        "replaces": "aerobulk_tpu/kernels/fused.py:101 (_mixed_kernel)",
        "launches": mixed_launches,
        "launches_by_path": {"fused_mixed_step (phase 12)": mixed_launches,
                             "envelope (phase 21)": env["MIXED_LAUNCHES"],
                             **bench_launches["fused_mixed"]},
        "max_abs_err": worst(mpar, mixed_cases, torch.float32, "max_abs_err"),
        **{f"worst_{key}_{tag}": worst(mpar, mixed_cases, dt, src)
           for key, src in (("median_rel", "median_rel"),
                            ("sig_frac", "worst_sig_frac"))
           for tag, dt in (("fp32", torch.float32),
                           ("fp64", torch.float64))},
        **ice_entry("mixed_step_ecmwf.cu", "mixed_ice_lg15_ecmwf",
                    rf"mixed_step_kernelIfLi{kfused._BULK_ALGOS['ecmwf']}E"
                    rf"Li{kfused._ICE_ALGOS['ice_lg15']}E"),
        "library_ms": None}, {
        "name": "fused_step_ecmwf", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/fused_step_ecmwf.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:45 (_kernel, ecmwf + skin)",
        "launches": ecm["launches"],
        "launches_by_path": {
            "run_series (phase 15)": ecm["launches"],
            **{f"run_series_pipelined {k} (phase 19)": n
               for k, n in streamed.items() if k.startswith("ecmwf")},
            **{f"run_series {k} (phase 20)": n
               for k, n in long_launches.items() if "ecmwf" in k},
            "envelope (phase 21)": env["by_case"]["kernel 1 ecmwf + skin"],
            **{f"{k} (phase 23)": n for k, n in host_launches.items()
               if "ecmwf" in k},
            **{f"sharded {k} (phase 24)": n
               for k, n in sharded_launches.items()
               if "ecmwf series" in k},
            **bench_launches["fused_step_ecmwf"]},
        "max_abs_err": ecm["par"][torch.float32]["max_abs_err"],
        **{f"{key}_{tag}": ecm["par"][dt][src]
           for key, src in (("median_rel", "median_rel"),
                            ("sig_frac", "worst_sig_frac"))
           for tag, dt in (("fp32", torch.float32),
                           ("fp64", torch.float64))},
        "ms": et32["kernel_ms"], "plain_ms": et32["plain_ms"],
        "bound_ms": et32["bound_ms"], "bound_by": et32["bound_by"],
        "library_ms": None}, {
        "name": "fused_grad_ecmwf", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/fused_grad_ecmwf.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:256 "
                    "(_grad_kernel, ecmwf + skin)",
        "launches": ecm["grad_launches"],
        "launches_by_path": {
            "run_series value+grad (phase 16)": ecm["grad_launches"],
            **{f"sharded {k} (phase 24)": n
               for k, n in sharded_launches.items()
               if "ecmwf value+grad" in k}},
        "max_abs_err": eg32["max_abs_err"],
        "max_abs_err_fp64": eg64["max_abs_err"],
        "worst_median_rel_fp32": max(
            r.get("median_rel", 0.0) for r in eg32["fields"].values()),
        "worst_p99_rel_fp32": max(
            r.get("p99_rel", 0.0) for r in eg32["fields"].values()),
        "worst_median_rel_fp64": max(
            r.get("median_rel", 0.0) for r in eg64["fields"].values()),
        "ms": et32["grad_kernel_ms"], "plain_ms": et32["plain_vjp_ms"],
        "bound_ms": et32["grad_bound_ms"], "bound_by": et32["grad_bound_by"],
        "bound_forward_mode_ms": et32["grad_bound_forward_mode_ms"],
        "mode": "reverse", "library_ms": None}, {
        "name": "primitive_chain", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/primitive_chain.cu",
        "replaces": "aerobulk_tpu/roofline.py:157 (kernel in "
                    "measure_primitive_throughput)",
        "launches": rl["launches"], "max_abs_err": rl["max_abs_err"],
        "max_rel_fp32": rl["max_rel_fp32"], "max_rel_fp64": rl["max_rel_fp64"],
        "ms": rl["ms"], "plain_ms": rl["plain_ms"], "bound_ms": rl["bound"][0],
        "bound_by": rl["bound"][1], "library_ms": None}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
