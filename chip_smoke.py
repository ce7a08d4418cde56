"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. device  — the card (nvidia-smi name and power limit, torch's name);
  2. build   — nvcc builds the kernels from the sources in this checkout;
  3. parity  — one fused_flux_step through the CUDA kernel against its plain
     PyTorch version on the card, in fp64 and fp32, on the 0.25-degree grid
     (721x1440) with COARE 3.6 + cool skin + warm layer, niter=5;
  4. series  — the main path: run_series(backend="fused") over 24 hourly
     records in fp32, which must launch the kernel once per record, stay
     finite, build and reset the warm layer, and match the eager series;
  5. timing  — one step of the kernel and of the plain version, CUDA events,
     in fp32 and fp64.

Then a ``{"kernels": [...]}`` line and, last, the ``{"ok": true, ...}``
line.  Any failure raises: no ok line and a non-zero exit.  Without a GPU
it exits non-zero before doing anything.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

import aerobulk_tpu_torch as abt
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as kfused

NY, NX = 721, 1440
NITER = 5
NT = 24
FIELDS = ("QL", "QH", "Tau_x", "Tau_y", "Evap", "T_s",
          "dT_wl", "Hz_wl", "Qnt_ac", "Tau_ac")
# gates of docs/PARITY.md "The fp32 tail": the median relative difference
# and the fraction of points whose error exceeds 10% of the field's median
# magnitude
GATES = {torch.float64: (1e-10, 0.0), torch.float32: (2e-4, 1e-4)}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def make_inputs(device, dtype):
    """The forcing of bench.py (seed 42, same distributions, same order)."""
    rng = np.random.default_rng(42)
    shape = (NY, NX)
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


def parity(got, ref, dtype):
    """Compare 10 fields; raise unless they pass the gate of ``dtype``."""
    rels, report = [], {}
    for name, a, b in zip(FIELDS, got, ref):
        a = a.double().cpu().numpy().ravel()
        b = b.double().cpu().numpy().ravel()
        if not np.array_equal(np.isnan(a), np.isnan(b)):
            fail(f"{name}: kernel and plain NaN masks differ")
        keep = ~np.isnan(b)
        a, b = a[keep], b[keep]
        d = np.abs(a - b)
        # the warm-layer state is exactly 0 wherever no layer is built (often
        # most points): its scale is the median over the points it is not
        nonzero = np.abs(b[b != 0])
        med = float(np.median(nonzero)) if nonzero.size else 0.0
        rel = d / np.maximum(np.abs(b), 1e-3 * med) if med >= 1e-20 else d
        if med < 1e-20:   # a field that is zero everywhere
            sig = float(np.mean(d > 1e-6))
        else:
            rels.append(rel)
            sig = float(np.mean(d > 0.1 * med))
        report[name] = {"median_rel": float(np.median(rel)),
                        "max_abs": float(d.max()), "sig_frac": sig,
                        "scale": med}
    median_rel = float(np.median(np.concatenate(rels)))
    worst_sig = max(r["sig_frac"] for r in report.values())
    max_med, max_sig = GATES[dtype]
    res = {"median_rel": median_rel, "worst_sig_frac": worst_sig,
           "max_abs_err": max(r["max_abs"] for r in report.values()),
           "gate": {"median_rel": max_med, "sig_frac": max_sig},
           "fields": report}
    if not (median_rel <= max_med and worst_sig <= max_sig):
        fail(f"{dtype} parity outside the gate: {json.dumps(res)}")
    return res


def cuda_ms(fn, inner, reps=7):
    """Median over ``reps`` of the mean time of ``inner`` calls, CUDA events."""
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
    name = torch.cuda.get_device_name(0)
    print(card, flush=True)
    emit({"phase": "device", "nvidia_smi": card, "torch_device": name,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # --- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln] if log.exists() else []
    emit({"phase": "build", "seconds": build_s, "ptxas": ptxas})

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
    sst, t, q, u, v, slp, rsw, rlw, lon = make_inputs(dev, torch.float32)
    hours = torch.arange(NT, device=dev, dtype=torch.float32)[:, None, None]
    local_h = torch.remainder(hours + lon / 15.0, 24.0)
    sun = torch.clamp(torch.cos((local_h - 12.0) * (np.pi / 12.0)), min=0.0)
    wind = 1.0 + 0.1 * torch.sin(hours * (2.0 * np.pi / NT))
    forcing = {
        "sst": sst.expand(NT, NY, NX).contiguous(),
        "t_zt": t.expand(NT, NY, NX).contiguous(),
        "hum_zt": q.expand(NT, NY, NX).contiguous(),
        "U_zu": (u * wind).contiguous(), "V_zu": (v * wind).contiguous(),
        "slp": slp.expand(NT, NY, NX).contiguous(),
        "rad_sw": (2.0 * rsw * sun).contiguous(),   # diurnal cycle
        "rad_lw": rlw.expand(NT, NY, NX).contiguous(),
    }
    isd = list(range(0, 86400, 3600))
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
    del forcing, f_out, e_out, f_fields, dT, sst, t, q, u, v, slp, rsw, rlw

    # --- 5. timing: one step, kernel and plain, fp32 (the main path) and fp64
    times = {}
    for dtype in (torch.float32, torch.float64):
        *args, lon = make_inputs(dev, dtype)
        state = abt.init_skin_state(cfg, (NY, NX), dtype, dev)
        kw = dict(lon=lon, isecday_utc=43200, skin_state=state)
        k_ms = cuda_ms(lambda: kfused.fused_flux_step(cfg, *args, **kw), 20)
        p_ms = cuda_ms(lambda: kfused.fused_flux_step_plain(cfg, *args, **kw),
                       3)
        times[dtype] = (k_ms, p_ms)
        emit({"phase": "timing", "dtype": str(dtype), "shape": [NY, NX],
              "card": card, "kernel_ms": k_ms, "plain_ms": p_ms,
              "kernel_points_per_s": NY * NX / (k_ms * 1e-3),
              "plain_points_per_s": NY * NX / (p_ms * 1e-3)})
    k_ms, p_ms = times[torch.float32]

    emit({"kernels": [{
        "name": "fused_step", "route": "cuda",
        "source": "aerobulk_tpu_torch/kernels/csrc/fused_step.cu",
        "replaces": "aerobulk_tpu/kernels/fused.py:45 (_kernel)",
        "launches": launches,
        "max_abs_err": par[torch.float32]["max_abs_err"],
        "median_rel_fp32": par[torch.float32]["median_rel"],
        "sig_frac_fp32": par[torch.float32]["worst_sig_frac"],
        "median_rel_fp64": par[torch.float64]["median_rel"],
        "sig_frac_fp64": par[torch.float64]["worst_sig_frac"],
        "ms": k_ms, "plain_ms": p_ms}]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
