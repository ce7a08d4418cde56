"""The bench on the card: the modes of the JAX package's ``bench.py`` through
the port's CUDA kernels, timed with CUDA events.

    python3 -m aerobulk_tpu_torch.bench [--all | --grad | --bf16 | --streamed]
                                        [--no-check] [--eager] [--niter N] ...
    python3 -m aerobulk_tpu_torch.cli bench [the same flags]

Each mode runs bench.py's workload (its shapes, seeds, ``niter``, records
and carries) and prints one JSON line per row under bench.py's metric
names:

* no mode flag: the headline, COARE 3.6 + cool skin + warm layer on the
  0.25-degree grid (721 x 1440), ``niter=5`` (``--niter N``), REPS = 20
  records through kernel 1 (``fused_flux_step``), the warm-layer state
  carried from record to record;
* ``--all``: bench.py's six rows: the NCAR small grid (512 x 32 x 128) and
  the COARE 3.0 1-degree month (32 x 181 x 360) through kernel 3
  (``run_series(batch_records=True, backend="fused")``), COARE 3.6 and
  ECMWF + skin through kernel 1, the mixed LG15 ice + ECMWF leads cell
  through kernel 5 and ice_lg15 through kernel 4;
* ``--grad``: one value and gradient of sum(QL + QH) with respect to SST,
  per variant: ``fused_kernel`` (kernel 1, kernel 2 backward: the
  headline), ``fused_eager`` (kernel 1, autograd of the plain step
  backward), ``eager``, ``eager_remat`` (the forward under
  ``torch.utils.checkpoint``); bench.py's ``fused_remat`` is refused by the
  port and the line says so;
* ``--bf16``: the stateless eager path in bf16 against fp32 (no kernel has
  a bf16 build), with bench.py's precision budget;
* ``--streamed``: 48 records (``--nrec``) fed from host numpy in chunks of
  8 (``--chunk``) through ``pipeline.run_series_pipelined(backend=
  "fused")``, wires ``--wire-i16``, ``--wire-i8d``, ``--collect-i16``.

Timing: CUDA events around the chained work after a warm-up, the median
of REPEATS = 7 runs with their spread (``min``, ``max``).  A kernel row also
gives the kernel alone (replays of a CUDA graph, by slope,
``measure.slopes_cuda``) and the host's share per record or call.  Each row
counts the launches of every kernel over its timed runs and fails unless
they are the row's own.  Parity (on unless ``--no-check``): each row's
kernel against the plain PyTorch path on the card on the same inputs,
bench.py's fields and fp32 gates (:func:`parity_fields`).  The C baseline
of the reference's point loop (``bench_baseline/coare36_skin_baseline.c``:
COARE 3.6 + cool skin + warm layer, ``niter=5``, fp64) is built and run
here at first use; every line gives its points/s
(``baseline_cpu_points_per_s``) and names its workload
(``baseline_workload``), and only a row of that workload (the headline and
``--all``'s COARE 3.6 + skin row at ``niter=5``, the streamed row on the
exact f32 wires) divides by it in ``vs_baseline``: every other row has
``vs_baseline`` null and a ``vs_baseline_note`` saying how its workload
differs (bench.py divides every row by it, ice included; not copied).
Every line names the host's CPU and the card (``nvidia-smi``).

There is no CPU route: without a CUDA device the bench exits non-zero.
``--eager`` runs the plain PyTorch path on the card and says so in
``backend``.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import os
import platform
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import measure
from . import pipeline as tpipe
from .api import AeroBulkConfig, flux_step, init_skin_state, run_series
from .kernels import _build
from .kernels import fused as kfused
from .measure import stream_records, streamed_forcing

NY, NX = 721, 1440          # the 0.25-degree global grid
NITER = 5                   # the reference's default nb_iter
REPS = 20                   # records of a stateful row's chained run
#: timed runs per row; a line gives their median and spread
REPEATS = 7
#: the streamed mode's records and records per chunk
NREC, CHUNK = 48, 8
#: the pinned-copy slope of the link: from 8 MB to 64 MB
LINK_BYTES = (8 << 20, 64 << 20)

#: the outputs of a step and the fields of its new warm-layer state
OUTPUTS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s")
STATE = ("dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
MIXED_OUTPUTS = ("QL", "QH", "Tau", "Evap", "T_s")
STREAMED_FIELDS = ("QL", "QH", "Tau", "Evap")
#: the launch counter of each kernel in ``kernels.fused`` (the ECMWF builds
#: of kernels 1 and 2 count in their COARE twins')
COUNTERS = {"fused_step": "LAUNCHES", "fused_grad": "GRAD_LAUNCHES",
            "fused_bulk": "BULK_LAUNCHES", "fused_ice": "ICE_LAUNCHES",
            "fused_mixed": "MIXED_LAUNCHES"}
#: bench.py's --grad variants and the port's: fused_remat has none
GRAD_VARIANTS = ("fused_kernel", "fused_eager", "eager", "eager_remat")
#: the streamed check's gates (median relative, significant fraction):
#: exact fp32, and where a wire quantizes (bench.py's)
STREAMED_GATES = {False: (1e-6, 1e-5), True: (1e-3, 1e-3)}

REPO = Path(__file__).resolve().parent.parent
BASELINE_SOURCE = REPO / "bench_baseline" / "coare36_skin_baseline.c"
#: bench.py's flags for the baseline (Makefile's ``baseline`` target)
BASELINE_FLAGS = ("-O3", "-march=native", "-ffast-math")
#: the baseline's points and time steps (bench.py's reproduction line)
BASELINE_RUN = (200000, 5)


# ---------------------------------------------------------------------------
# the machine: the card, the host's CPU and the C baseline
# ---------------------------------------------------------------------------

def card_info(index=0):
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    name, limit = lines[min(index, len(lines) - 1)].rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def host_cpu():
    """The host CPU: its model name from ``/proc/cpuinfo``, or, where that
    says none (a virtual machine may report ``unknown``), its vendor,
    family and model numbers; with the number of CPUs this process may
    use."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        text = ""

    def field(key):
        m = re.search(rf"^{key}\s*:\s*(.+)$", text, re.M)
        return m.group(1).strip() if m else None

    name = field("model name")
    if name in (None, "unknown"):
        name = (f"{field('vendor_id') or platform.machine()} family "
                f"{field('cpu family')} model {field('model')}")
    return f"{name}, {len(os.sched_getaffinity(0))} CPUs"


def build_baseline(build_dir=_build.BUILD_DIR) -> Path:
    """The C baseline built from ``bench_baseline/coare36_skin_baseline.c``
    with ``cc`` and BASELINE_FLAGS into ``build_dir``, under a name keyed by
    the source and the flags; built once, reused after."""
    key = hashlib.sha256(BASELINE_SOURCE.read_bytes()
                         + " ".join(BASELINE_FLAGS).encode()).hexdigest()[:12]
    exe = Path(build_dir) / f"coare36_skin_baseline_{key}"
    if exe.exists():
        return exe
    exe.parent.mkdir(parents=True, exist_ok=True)
    tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
    res = subprocess.run(["cc", *BASELINE_FLAGS, "-o", str(tmp),
                          str(BASELINE_SOURCE), "-lm"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"the C baseline did not build (cc "
                           f"{' '.join(BASELINE_FLAGS)}): {res.stderr}")
    os.replace(tmp, exe)
    return exe


def cpu_baseline(points=BASELINE_RUN[0], steps=BASELINE_RUN[1],
                 build_dir=_build.BUILD_DIR) -> dict:
    """Run the C baseline over ``points`` points and ``steps`` records on
    one core and return its JSON line (``value``: points/s)."""
    exe = build_baseline(build_dir)
    out = subprocess.run([str(exe), str(points), str(steps)],
                         capture_output=True, text=True, check=True).stdout
    return json.loads([ln for ln in out.splitlines()
                       if ln.startswith("{")][-1])


@functools.cache
def _measured_baseline():
    """The C baseline of this host, measured once a process."""
    return cpu_baseline()


# ---------------------------------------------------------------------------
# parity and timing
# ---------------------------------------------------------------------------

def _host64(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float64)


def parity_fields(names, got, ref):
    """Kernel-against-plain deviation statistics and the fp32 gate of
    bench.py's ``_parity_fields``, field for field, with one difference:
    a field's scale is the median magnitude of the plain value over its
    nonzero points, where bench.py takes it over every point.  A field that
    is zero at most points (the warm layer's dT_wl and Qnt_ac where no layer
    is built) has a median of 0 there, and bench.py then reads each point's
    fp32 rounding as significant; here it keeps the scale of the layers that
    exist.  A field that is zero everywhere is held absolutely, as bench.py
    holds its degenerate fields: both paths agree it is zero to 1e-6.  The
    scale and threshold are ``measure.field_scale``'s, chip_smoke.py's
    rule too."""
    rels, per_var, frac_by_var, sig_fracs = [], {}, {}, []
    for name, a, b in zip(names, got, ref):
        a, b = _host64(a), _host64(b)
        med, thr, zero_field = measure.field_scale(torch.from_numpy(b))
        d = np.abs(a - b)
        if zero_field:
            frac_by_var[name] = {
                "degenerate_zero_field": True,
                "abs_gt_1e6_floor": float(np.mean(d > thr)),
                "max_abs": float(np.max(d)),
                "median_abs_of_field": med,
            }
            per_var[name] = float(np.max(d))
            sig_fracs.append(frac_by_var[name]["abs_gt_1e6_floor"])
            continue
        r = d / np.maximum(np.abs(b), 1e-3 * med)
        frac_by_var[name] = {
            "rel_gt_1e2": float(np.mean(r > 1e-2)),
            "abs_gt_1pct_median": float(np.mean(d > 0.01 * med)),
            "abs_gt_10pct_median": float(np.mean(d > thr)),
            "max_abs": float(np.max(d)),
            "median_abs_of_field": med,
        }
        per_var[name] = float(np.max(r))
        sig_fracs.append(frac_by_var[name]["abs_gt_10pct_median"])
        rels.append(r.ravel())
    # no relative difference where every field is zero everywhere
    rel = np.concatenate(rels) if rels else np.zeros(1)
    frac_sig = float(np.max(sig_fracs))
    median, p99 = float(np.median(rel)), float(np.percentile(rel, 99))
    return {
        "parity_median_rel": median,
        "parity_p99_rel": p99,
        "parity_max_rel": float(np.max(rel)),
        "parity_max_by_var": per_var,
        "parity_frac_by_var": frac_by_var,
        "parity_worst_frac_abs_gt_10pct_median": frac_sig,
        # bench.py's fp32 gate (docs/PARITY.md "The fp32 tail"); the
        # pointwise-relative max measures denominator conditioning at the
        # zero contours and is reported, not gated
        "parity_ok": bool(median < 2e-4 and p99 < 2e-2 and frac_sig < 1e-4),
    }


def launch_counts():
    """Each kernel's launches in this process so far, by COUNTERS' names."""
    return {name: getattr(kfused, attr) for name, attr in COUNTERS.items()}


def _timed_runs(run, launches, repeats=REPEATS, warmup=None):
    """``warmup()`` (by default ``run()``) once, then ``run()`` ``repeats``
    times between CUDA events: the milliseconds of each timed run.  Fails
    unless each run launched every kernel of ``launches`` (a kernel name ->
    launches a run) that many times, and no other kernel."""
    (warmup or run)()
    torch.cuda.synchronize()
    before = launch_counts()
    ms = [measure.timed_call(run)[1] for _ in range(repeats)]
    got = {name: n - before[name] for name, n in launch_counts().items()}
    want = dict.fromkeys(COUNTERS, 0)
    for kernel, n in launches.items():
        want[kernel.removesuffix("_ecmwf")] += n * repeats
    if got != want:
        raise RuntimeError(f"bench: {repeats} runs launched {got}; each run "
                           f"must launch {launches or 'no kernel'}")
    return ms


def _spread(times, scale, key=None):
    """The rates ``scale / t`` over ``times``: their median, min and max as
    ``value``, ``min``, ``max``, or as ``key``, ``key_min``, ``key_max``."""
    rates = sorted(scale / t for t in times)
    stats = (float(np.median(rates)), rates[0], rates[-1])
    names = ("value", "min", "max") if key is None else (
        key, f"{key}_min", f"{key}_max")
    return dict(zip(names, stats))


def _kernel_only(call, points):
    """The kernel alone: the device seconds of one ``call()`` by slope over
    CUDA-graph replays (a graph replays the launches without the host's
    work), REPEATS of them, as points/s (median and spread) and as
    ``kernel_s_per_call`` (the median)."""
    slopes = measure.slopes_cuda(lambda x: (call(), x)[1], None, 1, 9,
                                 REPEATS)
    rec = _spread(slopes, points, "kernel_only_points_per_s")
    rec["kernel_s_per_call"] = float(np.median(slopes))
    return rec


class Bench:
    """One bench invocation: its options, the card, the host's CPU and the
    C baseline; :meth:`emit` completes and prints a row's line."""

    def __init__(self, args):
        self.args = args
        self.dev = torch.device("cuda", torch.cuda.current_device())
        self.check = not args.no_check
        self.eager = args.eager
        self.backend = "eager" if args.eager else "fused"
        self.card = card_info(self.dev.index)
        self.host_cpu = host_cpu()
        self.baseline = _measured_baseline()
        self.lines = []

    def emit(self, rec, *, differs):
        """Complete the row ``rec`` and print its line.  ``differs`` says
        how the row's workload differs from the C baseline's, or is None
        for a row of that workload: only such a row gets ``vs_baseline``,
        every other ``vs_baseline`` null and ``differs`` as its
        ``vs_baseline_note``."""
        points, steps = self.baseline["points"], self.baseline["steps"]
        rec["vs_baseline"] = (rec["value"] / self.baseline["value"]
                              if differs is None else None)
        if differs is not None:
            rec["vs_baseline_note"] = differs
        rec["baseline_cpu_points_per_s"] = self.baseline["value"]
        rec["baseline_workload"] = (
            f"COARE 3.6 + cool skin + warm layer, niter "
            f"{self.baseline['niter']}, fp64 C point loop "
            f"({BASELINE_SOURCE.relative_to(REPO)}), {points} points x "
            f"{steps} records, cc {' '.join(BASELINE_FLAGS)}")
        rec["baseline_provenance"] = (
            f"measured in this run, one core of {self.host_cpu}")
        rec["host_cpu"] = self.host_cpu
        rec["card"] = self.card
        rec["torch_device"] = torch.cuda.get_device_name(self.dev)
        rec["timing"] = f"CUDA events, median of {REPEATS}"
        self.lines.append(rec)
        print(json.dumps(rec), flush=True)

    # -- rows -----------------------------------------------------------------

    def stateful(self, cfg, fields, reps=REPS):
        """A row of ``reps`` chained steps of kernel 1 (``fused_flux_step``;
        the plain step with --eager), the warm-layer state carried: points/s
        of the whole run (the host's time between records included), of the
        kernel alone, the host's seconds per record, the launches, and
        parity of one step from the initial state against the plain step."""
        sst, t, q, u, v, slp, rsw, rlw, lon = fields
        state0 = init_skin_state(cfg, sst.shape, sst.dtype, sst.device)
        step_fn = (kfused.fused_flux_step_plain if self.eager
                   else kfused.fused_flux_step)
        kw = dict(lon=lon, isecday_utc=43200)

        def step(state):
            return step_fn(cfg, sst, t, q, u, v, slp, rsw, rlw,
                           skin_state=state, **kw)[1]

        def chain():
            state = state0
            for _ in range(reps):
                state = step(state)
            return state

        kernel = "fused_step_ecmwf" if cfg.algo == "ecmwf" else "fused_step"
        launches = {} if self.eager else {kernel: reps}
        points = sst.numel()
        ms = _timed_runs(chain, launches)
        rec = {"unit": "points/s", "backend": self.backend,
               "records": reps, "repeats": REPEATS,
               **_spread(ms, 1e3 * reps * points), "launches": launches}
        if not self.eager:
            rec.update(_kernel_only(lambda: step(state0), points))
            rec["host_s_per_record"] = (1e-3 * float(np.median(ms)) / reps
                                        - rec["kernel_s_per_call"])
        if self.check and not self.eager:
            got = kfused.fused_flux_step(cfg, sst, t, q, u, v, slp, rsw, rlw,
                                         skin_state=state0, **kw)
            ref = kfused.fused_flux_step_plain(cfg, sst, t, q, u, v, slp, rsw,
                                               rlw, skin_state=state0, **kw)
            rec.update(parity_fields(OUTPUTS + STATE, (*got[0], *got[1]),
                                     (*ref[0], *ref[1])))
        return rec

    def calls(self, kernel, points, ncalls, call, plain, names):
        """A row of ``ncalls`` back-to-back calls of a stateless kernel's
        wrapper ``call()`` (``plain()`` with --eager), each over ``points``:
        points/s, the kernel alone and the host's seconds per call, the
        launches, and parity of one call against ``plain()`` on ``names``."""
        fn = plain if self.eager else call
        launches = {} if self.eager else {kernel: ncalls}
        ms = _timed_runs(lambda: [fn() for _ in range(ncalls)], launches)
        rec = {"unit": "points/s", "backend": self.backend,
               "calls": ncalls, "repeats": REPEATS,
               **_spread(ms, 1e3 * ncalls * points), "launches": launches}
        if not self.eager:
            rec.update(_kernel_only(call, points))
            rec["host_s_per_call"] = (1e-3 * float(np.median(ms)) / ncalls
                                      - rec["kernel_s_per_call"])
            if self.check:
                rec.update(parity_fields(names, call(), plain()))
        return rec


# ---------------------------------------------------------------------------
# the modes
# ---------------------------------------------------------------------------

def headline_forcing(device, shape=(NY, NX)):
    """bench.py ``main``'s fp32 forcing (sst, t, q, u, v, slp, rsw, rlw,
    lon; seed 42): ``measure.grid_forcing``'s draws, except that the air
    temperature is drawn around the SST already rounded to fp32."""
    draws = measure.bench_draws(shape, q_low=0.004, sst_fp32=True)
    return tuple(measure.first_tensors(draws, 9, device,
                                       torch.float32).values())


def main_headline(b: Bench):
    """bench.py ``main``: COARE 3.6 + skin, 721 x 1440, REPS records."""
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0,
                         niter=b.args.niter, use_skin=True)
    fields = headline_forcing(b.dev)
    b.emit({"metric": "coare3p6_skin_0p25deg_grid_points_per_s_per_chip",
            "niter": b.args.niter, **b.stateful(cfg, fields)},
           differs=_niter_differs(b.args.niter))


def _niter_differs(niter):
    """How a COARE 3.6 + skin row at ``niter`` differs from the C
    baseline's workload (None: it does not)."""
    return None if niter == NITER else \
        f"niter {niter}: the C baseline iterates {NITER} times"


def stateless_row(b: Bench, metric, algo, nt, shape, inner):
    """bench.py ``stateless_batched``: the batched series of a stateless
    config (seed 7) in one launch of kernel 3, ``inner`` launches a run;
    not the C baseline's workload."""
    f = measure.month_forcing((nt,) + shape, b.dev, torch.float32)
    cfg = AeroBulkConfig(algo=algo, niter=NITER, use_skin=False)

    def solve(backend):
        out, _ = run_series(cfg, f, batch_records=True, backend=backend)
        return tuple(getattr(out, n) for n in OUTPUTS)

    b.emit({"metric": metric, **b.calls(
        "fused_bulk", nt * shape[0] * shape[1], inner,
        lambda: solve("fused"), lambda: solve("eager"), OUTPUTS)},
        differs=f"{algo} stateless bulk fluxes without a skin scheme, not "
                "COARE 3.6 + skin")


def main_all(b: Bench):
    """bench.py ``main_all``: its six rows, each through its kernel."""
    # 1: the NCAR small-grid buoy series (bench.py keeps it on the jit path
    # for a TPU compile cost that does not exist here: kernel 3)
    stateless_row(b, "ncar_small_grid_points_per_s", "ncar", 512, (32, 128),
                  inner=128)
    # 2: COARE 3.0 bulk SST, 1-degree global, a month of 32 records
    stateless_row(b, "coare3p0_bulk_1deg_points_per_s", "coare3p0", 32,
                  (181, 360), inner=32)
    # 3, 4: COARE 3.6 and ECMWF + skin, 0.25-degree global, kernel 1
    f = measure.mk_inputs((NY, NX), b.dev, torch.float32)
    fields = tuple(f[k] for k in ("sst", "t", "q", "u", "v", "slp", "rsw",
                                  "rlw", "lon"))
    for metric, algo in (("coare3p6_skin_0p25deg_points_per_s", "coare3p6"),
                         ("ecmwf_skin_0p25deg_points_per_s", "ecmwf")):
        cfg = AeroBulkConfig(algo=algo, niter=NITER, use_skin=True)
        b.emit({"metric": metric, **b.stateful(cfg, fields)},
               differs=None if algo == "coare3p6" else
               f"{algo} + skin, not COARE 3.6 + skin")
    del f, fields
    # 5: the mixed ocean+ice cell, LG15 ice + ECMWF leads, kernel 5; 6: its
    # ice-only companion, ice_lg15, kernel 4; the cold forcing of config 5
    Ts_i, sst, t, q, u, v, slp, frice = measure.cold_forcing(
        (NY, NX), b.dev, torch.float32)
    mixed = (2.0, 10.0, Ts_i, sst, t, q, u, v, slp, frice)
    b.emit({"metric": "mixed_ice_ocean_0p25deg_points_per_s", **b.calls(
        "fused_mixed", NY * NX, 10,
        lambda: kfused.fused_mixed_step(*mixed, niter=NITER),
        lambda: kfused.fused_mixed_step_plain(*mixed, niter=NITER),
        MIXED_OUTPUTS)},
        differs="LG15 sea ice and ECMWF leads blended by ice fraction, not "
                "COARE 3.6 + skin")
    ice = ("ice_lg15", 2.0, 10.0, Ts_i, t, q, u, v, slp)
    b.emit({"metric": "ice_lg15_0p25deg_points_per_s", **b.calls(
        "fused_ice", NY * NX, 80,
        lambda: kfused.fused_ice_step(*ice, frice=frice, niter=NITER),
        lambda: kfused.fused_ice_step_plain(*ice, frice=frice, niter=NITER),
        OUTPUTS)}, differs="ice_lg15 sea-ice fluxes, not COARE 3.6 + skin")


def bf16_budget(cfg, forcing32):
    """bench.py's bf16 precision budget of a stateless config: the
    relative difference of QL, QH and Tau_x in bf16 against fp32 (eager
    ``run_series(batch_records=True)`` on ``forcing32`` and its bf16
    rounding), against max(|fp32|, 1e-3 of its median), and the fraction
    of values that are not finite."""
    outs = {}
    for dtype in (torch.bfloat16, torch.float32):
        out, _ = run_series(cfg, {k: v.to(dtype) for k, v in
                                  forcing32.items()}, batch_records=True)
        outs[dtype] = [_host64(x.float()) for x in (out.QL, out.QH,
                                                    out.Tau_x)]
    rel = np.concatenate([
        (np.abs(x - y) / np.maximum(np.abs(y), 1e-3 * np.median(np.abs(y))))
        .ravel() for x, y in zip(outs[torch.bfloat16], outs[torch.float32])])
    nonfinite = float(np.mean(~np.isfinite(rel)))
    rel = rel[np.isfinite(rel)]    # the Goff 10**x chain overflows bf16
    return {"bf16_vs_fp32_median_rel": float(np.median(rel)),
            "bf16_vs_fp32_p99_rel": float(np.percentile(rel, 99)),
            "bf16_nonfinite_frac": nonfinite}


def main_bf16(b: Bench):
    """bench.py ``main_bf16``: the stateless rows in bf16 on the eager path
    (kernel 3 has no bf16 build, as its Pallas counterpart has none), with
    the precision budget against fp32."""
    for name, algo, nt, shape in (
            ("ncar_small_grid_bf16_points_per_s", "ncar", 512, (32, 128)),
            ("coare3p0_bulk_1deg_bf16_points_per_s", "coare3p0", 32,
             (181, 360))):
        f32 = measure.month_forcing((nt,) + shape, b.dev, torch.float32)
        cfg = AeroBulkConfig(algo=algo, niter=NITER, use_skin=False)
        inner = 128 if nt * shape[0] * shape[1] < 3e6 else 32
        f16 = {k: v.to(torch.bfloat16) for k, v in f32.items()}

        def solve():
            return run_series(cfg, f16, batch_records=True)

        ms = _timed_runs(lambda: [solve() for _ in range(inner)], {},
                         warmup=solve)
        b.emit({"metric": name, "unit": "points/s", "backend": "eager",
                "note": "no kernel: kernel 3 has no bf16 build",
                "calls": inner, "repeats": REPEATS,
                **_spread(ms, 1e3 * inner * nt * shape[0] * shape[1]),
                "launches": {}, **bf16_budget(cfg, f32)},
               differs=f"{algo} stateless bulk fluxes in bf16, not COARE "
                       "3.6 + skin")


def _grad_gate(got, ref, yard=None):
    """bench.py's on-device gradient gate: relative difference against
    max(|ref|, 1e-3 of its median): median < 1e-3, p99 < 5e-2, every value
    finite.  With ``yard``, the fp64 gradient at the same fp32 inputs,
    also ``sig_frac_vs_fp64``: the fraction of the points where ``got`` is
    significant against it (``measure.grad_sig``; ROADMAP.md section 3,
    F8)."""
    g, r = _host64(got), _host64(ref)
    rel = np.abs(g - r) / np.maximum(np.abs(r),
                                     1e-3 * (np.median(np.abs(r)) + 1e-30))
    nonfinite = float(np.mean(~np.isfinite(g)))
    out = {"parity_median_rel": float(np.median(rel)),
           "parity_p99_rel": float(np.percentile(rel, 99)),
           "parity_max_rel": float(np.max(rel)),
           "nonfinite_frac": nonfinite,
           "parity_ok": bool(np.median(rel) < 1e-3
                             and np.percentile(rel, 99) < 5e-2
                             and nonfinite == 0.0)}
    if yard is not None:
        out["sig_frac_vs_fp64"] = _sig_frac(got, yard)
    return out


def _sig_frac(got, yard):
    """The fraction of the points where the gradient ``got`` is significant
    against the fp64 ``yard`` (``measure.grad_sig``)."""
    sig = measure.grad_sig(torch.as_tensor(got), torch.as_tensor(yard))[0]
    return float(sig.double().mean())


def main_grad(b: Bench):
    """bench.py ``main_grad``: value and gradient of sum(QL + QH) with
    respect to SST through the skin step on the 0.25-degree grid, per
    variant; each evaluation's gradient feeds the next input, 8 a run."""
    from torch.utils.checkpoint import checkpoint

    if b.eager:
        sys.exit("bench --grad: --eager does not apply; choose the plain "
                 "variants with --variants=eager,eager_remat")
    niter, reps = b.args.niter, 8
    f = measure.mk_inputs((NY, NX), b.dev, torch.float32)
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=niter,
                         use_skin=True)
    state = init_skin_state(cfg, (NY, NX), torch.float32, b.dev)
    rest = tuple(f[k] for k in ("t", "q", "u", "v", "slp", "rsw", "rlw"))
    kw = dict(lon=f["lon"], isecday_utc=43200, skin_state=state)

    def loss_fused(sst, grad_backend):
        outs, _ = kfused.fused_flux_step(cfg, sst, *rest,
                                         grad_backend=grad_backend, **kw)
        return (outs[0] + outs[1]).sum()

    def loss_eager(sst, f=f, state=state):
        out, _ = flux_step(cfg, sst, *(f[k] for k in ("t", "q", "u", "v",
                                                      "slp")),
                           rad_sw=f["rsw"], rad_lw=f["rlw"], lon=f["lon"],
                           isecday_utc=43200, skin_state=state)
        return (out.QL + out.QH).sum()

    losses = {
        "fused_kernel": (lambda s: loss_fused(s, "kernel"),
                         {"fused_step": reps, "fused_grad": reps}),
        "fused_eager": (lambda s: loss_fused(s, "eager"),
                        {"fused_step": reps}),
        "eager": (loss_eager, {}),
        "eager_remat": (lambda s: checkpoint(loss_eager, s,
                                             use_reentrant=False), {}),
    }

    def grad(loss, sst):
        x = sst.detach().requires_grad_()
        return torch.autograd.grad(loss(x), x)[0]

    names = GRAD_VARIANTS if b.args.variants is None else tuple(
        b.args.variants.split(","))
    unknown = sorted(set(names) - set(GRAD_VARIANTS) - {"fused_remat"})
    if unknown:
        sys.exit(f"bench --grad: unknown variants {unknown}; the port's are "
                 f"{', '.join(GRAD_VARIANTS)}")
    points = NY * NX
    rec = {"metric": "coare3p6_skin_0p25deg_value_and_grad_points_per_s",
           "unit": "points/s", "niter": niter, "evaluations": reps,
           "repeats": REPEATS,
           "note": ("one complete value+gradient (d sum(QL+QH) / d SST) per "
                    "evaluation; fused_kernel = kernel 1 + kernel 2 "
                    "backward; fused_eager = kernel 1 + autograd of the "
                    "plain step backward; eager_remat = the plain forward "
                    "under torch.utils.checkpoint"),
           "fused_remat": ("refused: the port has no grad_backend='remat' "
                           "(a measured negative in the reference)")}
    for name in names:
        if name == "fused_remat":
            continue
        loss, launches = losses[name]

        def chain():
            sst = f["sst"]
            for _ in range(reps):
                # serially dependent: the gradient feeds the next input
                sst = sst + 1.0e-20 * grad(loss, sst)
            return sst

        torch.cuda.reset_peak_memory_stats(b.dev)
        ms = _timed_runs(chain, launches,
                         warmup=lambda: grad(loss, f["sst"]))
        rec.update(_spread(ms, 1e3 * reps * points, f"{name}_points_per_s"))
        rec[f"{name}_launches"] = launches
        rec[f"{name}_peak_memory_bytes"] = torch.cuda.max_memory_allocated(
            b.dev)
        print(f"# {name}: {rec[f'{name}_points_per_s']:.4g} points/s",
              file=sys.stderr, flush=True)

    if b.check:
        g_ref = grad(loss_eager, f["sst"])
        # the fp64 yardstick: the eager gradient at the fp32 inputs upcast
        f64 = {k: v.double() for k, v in f.items()}
        g64 = grad(lambda s: loss_eager(s, f64, type(state)(
            *(x.double() for x in state))), f64["sst"])
        plain = _sig_frac(g_ref, g64)
        rec["grad_plain_sig_frac_vs_fp64"] = plain
        for tag, backend in (("grad", "eager"), ("grad_kernel", "kernel")):
            gate = _grad_gate(grad(lambda s: loss_fused(s, backend),
                                   f["sst"]), g_ref, g64)
            rec.update({f"{tag}_{k}": v for k, v in gate.items()})
        # kernel 2 against fp64 beside the eager fp32 gradient (F5's form)
        rec["grad_kernel_parity_ok"] = bool(
            rec["grad_kernel_parity_ok"] and measure.grad_sig_ok(
                rec["grad_kernel_sig_frac_vs_fp64"], plain))
    head = next((n for n in GRAD_VARIANTS if n in names), None)
    if head is None:
        sys.exit("bench --grad: no variant to measure")
    rec["value"] = rec[f"{head}_points_per_s"]
    rec["headline_variant"] = head
    rec["backend"] = "eager" if head.startswith("eager") else "fused"
    b.emit(rec, differs="a value and gradient of one step, not the forward "
                        "step")


# ---------------------------------------------------------------------------
# the streamed feed (shared with chip_smoke.py's phase 19)
# ---------------------------------------------------------------------------

def resident_reference(cfg, base_dev, offs, n, lon, backend="fused"):
    """The first ``n`` streamed records' QL, QH, Tau and Evap from
    ``run_series`` on forcing built on the device."""
    shape = (n, *base_dev["sst"].shape)
    off = {k: torch.as_tensor(v[:n], device=lon.device)[:, None, None]
           for k, v in offs.items()}
    fc = {k: v.expand(shape).contiguous() for k, v in base_dev.items()}
    fc["sst"] = base_dev["sst"][None] + off["sst"]
    fc["t_zt"] = base_dev["t_zt"][None] + off["t_zt"]
    fc["rad_sw"] = base_dev["rad_sw"][None] * off["rad_sw"]
    isd = [(jt * 3600) % 86400 for jt in range(n)]
    out, _ = run_series(cfg, fc, isecday_utc=isd, lon=lon, backend=backend)
    tau = out.Tau if out.Tau is not None else torch.hypot(out.Tau_x,
                                                          out.Tau_y)
    return out.QL, out.QH, tau, out.Evap


def link_gbps(dev):
    """Pinned host <-> device bandwidth (bytes/s), H2D and D2H, each the
    slope of the best of 5 copies (CUDA events) between LINK_BYTES."""
    def best_ms(nbytes, h2d):
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        card = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        src, dst = (host, card) if h2d else (card, host)
        return min(measure.timed_call(
            lambda: dst.copy_(src, non_blocking=True))[1] for _ in range(5))

    small, big = LINK_BYTES
    return tuple((big - small) / (1e-3 * (best_ms(big, h2d)
                                          - best_ms(small, h2d)))
                 for h2d in (True, False))


def staging_s(dev, base, offs, wire, chunk):
    """Host seconds to stage one chunk (or record) alone, median of 3:
    what the producer does for it with no copy in flight (stacking, or
    stacking and packing, into a pinned buffer that is free, then queueing
    its copy)."""
    recs = list(stream_records(base, offs, chunk or 1))
    feed = tpipe._Feed(dev, 1)
    if chunk is None:
        arrays = {k: v for k, v in recs[0].items() if np.ndim(v)}
    elif wire == "f32":
        arrays = {(k,): [r[k] for r in recs] for k in base}
    else:
        arrays = None
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feed.put(arrays if arrays is not None else tpipe._pack_wire(
            tpipe._stack_chunk([{k: r[k] for k in base} for r in recs]),
            wire))
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return float(np.median(times[1:]))    # the first allocates the buffer


def source_s(base, offs, n):
    """Host seconds to make ``n`` records (what the record source costs the
    producer thread before staging), median of 3."""
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        recs = list(stream_records(base, offs, n))
        times.append(time.perf_counter() - t0)
        del recs
    return float(np.median(times))


def main_streamed(b: Bench):
    """bench.py ``main_streamed``: ``nrec`` records of config 3 fed from
    host numpy through ``run_series_pipelined`` (kernel 1 per record),
    REPEATS runs; beside it the same chunk program on device-resident
    forcing (compute-only), the link, the transfer bound, the producer's
    and each stage's seconds per chunk, a steady-state rate, and the first
    ``2 * chunk`` collected records against a device-resident run."""
    a = b.args
    chunk = a.chunk
    nrec = max(chunk, a.nrec - a.nrec % chunk)     # whole chunks only
    wire = "i8d" if a.wire_i8d else "i16" if a.wire_i16 else "f32"
    collect_wire = "i16" if a.collect_i16 else "f32"
    cfg = AeroBulkConfig(algo="coare3p6", zt=2.0, zu=10.0, niter=a.niter,
                         use_skin=True)
    base, lon, offs = streamed_forcing(nrec, shape=(NY, NX))
    base_dev = {k: torch.as_tensor(v, device=b.dev) for k, v in base.items()}
    lon_dev = torch.as_tensor(lon, device=b.dev)
    points = lon.size
    launches = {} if b.eager else {"fused_step": nrec}
    kw = dict(chunk=chunk, backend=b.backend, lon=lon_dev, inflight=2,
              wire=wire, collect_wire=collect_wire, device=b.dev)

    kept, runs = {}, []

    def streamed():
        # the collect hook runs as each chunk's outputs are queued for
        # collection, once the chunk was staged and its steps dispatched
        stamps = []

        def collect(out):
            stamps.append(time.perf_counter())
            return tpipe._default_collect(out)

        producer = []
        kept["results"], state = tpipe.run_series_pipelined(
            cfg, stream_records(base, offs, nrec), collect=collect,
            producer_seconds=producer, **kw)
        state.dT_wl.sum().item()               # the final true sync
        runs.append((stamps, producer))

    ms = _timed_runs(streamed, launches)
    results = kept.pop("results")
    timed = runs[1:]                           # after the warm-up run
    # steady state: from the first chunk's outputs queued for collection
    # to the last one's, so that the fill and the drain are left out
    steady = [(st[-1] - st[0]) / (len(st) - 1) for st, _ in timed
              if len(st) > 1]
    producer = [s for _, secs in timed for s in secs]
    if len(results) != nrec // chunk:
        raise RuntimeError(f"bench --streamed: {len(results)} collected "
                           f"chunks of {nrec // chunk}")

    # compute-only: the same chunk program, forcing resident on the device
    fc = {k: v.expand(chunk, *lon.shape).contiguous()
          for k, v in base_dev.items()}
    isd = [(jt * 3600) % 86400 for jt in range(chunk)]
    state0 = init_skin_state(cfg, lon.shape, torch.float32, b.dev)

    def compute():
        state = state0
        for _ in range(nrec // chunk):
            _, state = run_series(cfg, fc, skin_state=state, isecday_utc=isd,
                                  lon=lon_dev, backend=b.backend)
        return state

    compute_ms = _timed_runs(compute, launches)
    del fc, state0

    h2d, d2h = link_gbps(b.dev)
    streamed_s = 1e-3 * float(np.median(ms))
    compute_s = 1e-3 * float(np.median(compute_ms))
    streamed_pts = nrec * points / streamed_s
    compute_pts = nrec * points / compute_s
    # bytes per value on the wire: i8d ships one int16 base and (chunk-1)
    # int8 deltas per chunk
    in_width = {"f32": 4.0, "i16": 2.0, "i8d": (chunk + 1) / chunk}[wire]
    out_width = 2 if collect_wire == "i16" else 4
    bytes_in = int(len(base) * in_width * points)
    bytes_out = len(STREAMED_FIELDS) * out_width * points
    transfer_pts = points / (bytes_in / h2d + bytes_out / d2h)
    bound_pts = min(compute_pts, transfer_pts)
    stages = {"record_source": source_s(base, offs, chunk),
              "host_staging": staging_s(b.dev, base, offs, wire, chunk),
              "link": chunk * (bytes_in / h2d + bytes_out / d2h),
              "kernel": compute_s / (nrec // chunk)}

    rec = {
        "metric": "coare3p6_skin_0p25deg_streamed_points_per_s"
                  + {"i16": "_i16wire", "i8d": "_i8dwire"}.get(wire, "")
                  + ("_i16out" if collect_wire == "i16" else ""),
        "unit": "points/s", "niter": a.niter, "nrec": nrec, "chunk": chunk,
        "backend": b.backend, "wire": wire, "collect_wire": collect_wire,
        "repeats": REPEATS, **_spread(ms, 1e3 * nrec * points),
        "launches": launches,
        "streamed_wall_s": streamed_s,
        "records_per_s": nrec / streamed_s,
        **(_spread(steady, chunk * points, "steady_state_points_per_s")
           if steady else {"steady_state_points_per_s": None}),
        "compute_only_points_per_s": compute_pts,
        "overlap_efficiency": streamed_pts / compute_pts,
        "h2d_gbps": h2d / 1e9, "d2h_gbps": d2h / 1e9,
        "bytes_h2d_per_record": bytes_in,
        "bytes_d2h_per_record": bytes_out,
        "bound_points_per_s": bound_pts,
        "overlap_efficiency_vs_bound": streamed_pts / bound_pts,
        "producer_s_per_chunk": {"median": float(np.median(producer)),
                                 "max": float(np.max(producer))},
        "s_per_chunk_by_stage": stages,
        "paced_by": max(stages, key=stages.get),
    }
    if b.check:
        ncheck = min(2 * chunk, nrec)
        ref = resident_reference(cfg, base_dev, offs, ncheck, lon_dev,
                                 b.backend)
        got = [np.concatenate([r[k] for r in results[:ncheck // chunk]])
               for k in STREAMED_FIELDS]
        pf = parity_fields(STREAMED_FIELDS, got, ref)
        med_gate, sig_gate = STREAMED_GATES[wire != "f32"
                                            or collect_wire == "i16"]
        rec.update({
            "streamed_check_records": ncheck,
            "streamed_check_median_rel": pf["parity_median_rel"],
            "streamed_check_p99_rel": pf["parity_p99_rel"],
            "streamed_check_worst_frac_abs_gt_10pct_median":
                pf["parity_worst_frac_abs_gt_10pct_median"],
            "streamed_check_max_by_var": pf["parity_max_by_var"],
            "streamed_check_ok": bool(
                pf["parity_median_rel"] < med_gate
                and pf["parity_worst_frac_abs_gt_10pct_median"] < sig_gate),
        })
    # the C baseline's workload with the host feed in front: the same
    # physics on the same values, read from host memory as the C loop reads
    # them, unless a wire quantizes the forcing or the outputs
    b.emit(rec, differs=_niter_differs(a.niter) or (
        None if (wire, collect_wire) == ("f32", "f32") else
        f"the {wire} wire in, {collect_wire} out: the values quantized on "
        f"the way, not the C baseline's"))


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def add_arguments(p: argparse.ArgumentParser):
    """bench.py's flags (``--jit`` is ``--eager`` here)."""
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--all", action="store_true",
                      help="bench.py's six workload rows")
    mode.add_argument("--bf16", action="store_true",
                      help="the stateless rows in bf16 with the precision "
                           "budget against fp32")
    mode.add_argument("--grad", action="store_true",
                      help="value+gradient throughput per variant")
    mode.add_argument("--streamed", action="store_true",
                      help="config 3 fed from host records (the feed "
                           "included)")
    p.add_argument("--no-check", action="store_true",
                   help="skip the parity check of each row's kernel "
                        "against the plain path")
    p.add_argument("--eager", action="store_true",
                   help="run the plain PyTorch path on the card instead of "
                        "the kernels (bench.py's --jit)")
    p.add_argument("--niter", type=int, default=NITER,
                   help="outer iterations of the headline, --grad and "
                        "--streamed")
    p.add_argument("--variants", default=None,
                   help="--grad: a comma list of " + ",".join(GRAD_VARIANTS))
    p.add_argument("--nrec", type=int, default=NREC,
                   help="--streamed: records (whole chunks)")
    p.add_argument("--chunk", type=int, default=CHUNK,
                   help="--streamed: records per chunk")
    wire = p.add_mutually_exclusive_group()
    wire.add_argument("--wire-i16", action="store_true",
                      help="--streamed: ship the forcing as int16")
    wire.add_argument("--wire-i8d", action="store_true",
                      help="--streamed: ship int16 bases and int8 deltas")
    p.add_argument("--collect-i16", action="store_true",
                   help="--streamed: read the outputs back as int16")


def run(args, prog="python3 -m aerobulk_tpu_torch.bench"):
    """Run the mode ``args`` names on the card; without a CUDA device exit
    non-zero.  Returns the printed lines."""
    if not torch.cuda.is_available():
        sys.exit(f"{prog}: no CUDA device: the bench measures the card (an "
                 "NVIDIA GPU) and has no CPU route")
    b = Bench(args)
    if args.all:
        main_all(b)
    elif args.bf16:
        main_bf16(b)
    elif args.grad:
        main_grad(b)
    elif args.streamed:
        main_streamed(b)
    else:
        main_headline(b)
    return b.lines


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m aerobulk_tpu_torch.bench", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    add_arguments(p)
    run(p.parse_args(argv))


if __name__ == "__main__":
    main()
