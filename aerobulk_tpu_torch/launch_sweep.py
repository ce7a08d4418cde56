"""The numerics and launch-shape sweep of the forward kernels 1 and 3 on one
NVIDIA GPU.

    python3 -m aerobulk_tpu_torch.launch_sweep [--ref DIR] [--out FILE]

Builds ``kernels/csrc/fused_step.cu``, ``fused_step_ecmwf.cu`` and
``bulk_step.cu`` once per variant (under ``kernels/_build/launch_sweep/``,
all nvcc runs in parallel) and times every variant's kernel at the main
path's shapes, fp32 and fp64: the stateful step (COARE 3.6 and ECMWF +
skin, 721x1440, bench.py's forcing, a fresh state) and the stateless step
of the five algorithms on a month of the 1-degree grid (720 x 181 x 360 =
46,915,200 points).  The variants:

  * ``ref`` (with ``--ref DIR``): the sources of another checkout's
    ``csrc/`` (e.g. the parent commit's), built with NVCC_FLAGS alone;
  * numerics, at one 256-thread block per SM and one point per thread:
    ``exact_div`` (NVCC_FLAGS alone), ``approx_div`` (-prec-div=false
    -ftz=false) and ``approx_div_sqrt`` (and -prec-sqrt=false, which is
    ``_build.FORWARD_FLAGS``);
  * launch shapes with the package's numerics (``_build.FORWARD_FLAGS``):
    ``b{B}_p{P}``, ``__launch_bounds__(256, B)`` for B in 1..4 and P points
    per thread for P in 1, 2 (-DABT_SWEEP_MIN_BLOCKS, -DABT_SWEEP_POINTS);
  * ``kept``: the sources and flags the package builds, with its table of
    shapes.

Each kernel is timed with CUDA events in two turns (the variants in order,
then reversed), the median of 5 runs of several launches per turn; a
variant's time is the lower of its two.  Each variant's outputs are
compared with ``kept``'s, and its registers and spills read from ptxas.
Prints one JSON line per kernel and dtype, then the card's name and power
limit, and writes the lines to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from .api import AeroBulkConfig, init_skin_state
from .kernels import _build
from .kernels import fused as kfused
from .measure import cuda_ms, grid_forcing, month_forcing

SOURCES = ("fused_step.cu", "fused_step_ecmwf.cu", "bulk_step.cu")
#: (minimum resident 256-thread blocks per SM, points per thread)
SHAPES = [(b, p) for p in (1, 2) for b in (1, 2, 3, 4)]
ALGOS = ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas")
GRID = (721, 1440)
MONTH = (720, 181, 360)
NITER = 5
ISD = 43200.0


def _shape(b, p):
    return (f"-DABT_SWEEP_MIN_BLOCKS={b}", f"-DABT_SWEEP_POINTS={p}")


def variants(ref=None):
    """label -> (csrc directory, flags beyond NVCC_FLAGS or None for the
    package's own, defines)."""
    approx = ("-prec-div=false", "-ftz=false")
    v = {"ref": (Path(ref), (), ())} if ref else {}
    v["exact_div"] = (_build.CSRC, (), _shape(1, 1))
    v["approx_div"] = (_build.CSRC, approx, _shape(1, 1))
    v["approx_div_sqrt"] = (_build.CSRC, approx + ("-prec-sqrt=false",),
                            _shape(1, 1))
    for b, p in SHAPES:
        v[f"b{b}_p{p}"] = (_build.CSRC, _build.FORWARD_FLAGS, _shape(b, p))
    v["kept"] = (_build.CSRC, None, ())
    return v


def build(vs, root, jobs):
    """Build every (variant, source), at most ``jobs`` nvcc at once:
    {(label, source): (library, flags, ptxas report)}."""
    nvcc = _build.find_nvcc()
    todo = [(label, src) for label in vs for src in SOURCES]
    running, built, failed = [], {}, []
    while todo or running:
        while todo and len(running) < jobs:
            label, src = todo.pop(0)
            csrc, extra, defines = vs[label]
            flags = (_build.flags(src) if extra is None
                     else (*_build.NVCC_FLAGS, *extra))
            out = root / label / f"lib_{Path(src).stem}.so"
            out.parent.mkdir(parents=True, exist_ok=True)
            with open(out.with_suffix(".log"), "w") as log:
                proc = subprocess.Popen(
                    [nvcc, *flags, *defines, "-o", str(out), str(csrc / src)],
                    stdout=log, stderr=subprocess.STDOUT)
            running.append((proc, label, src, out, flags + defines))
        for job in [j for j in running if j[0].poll() is not None]:
            running.remove(job)
            proc, label, src, out, flags = job
            text = out.with_suffix(".log").read_text()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {label}/{src}:\n{text[-4000:]}")
            built[(label, src)] = (out, flags, _build.ptxas_report(text))
        time.sleep(0.1)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def _entry(lib, src, name):
    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = _build._ENTRIES[src][1]
    fn.restype = ctypes.c_int
    return fn


def targets(dev, dtype):
    """(kernel, algo, source, entry name, kernel name in ptxas, run) for
    each kernel at ``dtype``; ``run(fn)`` launches fn once and returns its
    outputs."""
    t = "f" if dtype == torch.float32 else "d"
    bits = "f32" if dtype == torch.float32 else "f64"
    out = []
    grid = grid_forcing(GRID, dev, dtype)
    for algo, src in (("coare3p6", "fused_step.cu"),
                      ("ecmwf", "fused_step_ecmwf.cu")):
        cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                             use_skin=True)
        ins = (*grid, *init_skin_state(cfg, GRID, dtype, dev))

        def run(fn, cfg=cfg, ins=ins):
            outs = [torch.empty_like(ins[0]) for _ in range(10)]
            kfused._call(fn, ins[0], (*ins, *outs), cfg, ISD)
            return outs
        stem = src[:-3]
        out.append(("step", algo, src, f"abt_{stem}_{bits}",
                    rf"fused_step_kernelI{t}", run))
    month = month_forcing(MONTH, dev, dtype)
    flat = [x.reshape(-1) for x in month.values()]
    for algo in ALGOS:
        law, visc, *z0t = kfused._coare_args(algo)
        args = (kfused._BULK_ALGOS[algo], NITER, law, visc, 0, *z0t, 2.0,
                10.0)

        def run(fn, args=args):
            return kfused._launch_flat(fn, flat, 6, *args)
        out.append(("bulk", algo, "bulk_step.cu", f"abt_bulk_step_{bits}",
                    rf"bulk_step_kernelI{t}Li{kfused._BULK_ALGOS[algo]}E",
                    run))
    return out


def _vs_kept(outs, kept):
    worst, equal = 0.0, True
    for a, b in zip(outs, kept):
        equal = equal and torch.equal(a, b)
        scale = float(b.abs().max())
        worst = max(worst, float((a - b).abs().max()) / scale if scale else 0)
    return equal, worst


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref", help="another checkout's kernels/csrc/ to time "
                                  "beside this one's")
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "launch_sweep"
                                         / "results.jsonl"))
    ap.add_argument("--jobs", type=int, default=12,
                    help="nvcc processes at once")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("launch_sweep: no CUDA device; this sweep runs only on a GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    vs = variants(args.ref)
    t0 = time.perf_counter()
    built = build(vs, _build.BUILD_DIR / "launch_sweep", args.jobs)
    lines = [{"part": "build", "seconds": time.perf_counter() - t0,
              "card": card, "variants": {
                  label: {"flags": list(built[(label, SOURCES[0])][1])}
                  for label in vs}}]
    print(json.dumps(lines[0]), flush=True)
    for dtype in (torch.float32, torch.float64):
        for kernel, algo, src, name, mangled, run in targets(dev, dtype):
            fns = {label: _entry(built[(label, src)][0], src, name)
                   for label in vs}
            kept = run(fns["kept"])
            rec = {"part": "kernel", "kernel": kernel, "algo": algo,
                   "dtype": str(dtype), "card": card, "ms": {},
                   "registers_spill_stores_spill_loads": {},
                   "bitwise_equal_to_kept": {}, "max_rel_vs_kept": {}}
            for label, fn in fns.items():
                eq, rel = _vs_kept(run(fn), kept)
                rec["bitwise_equal_to_kept"][label] = eq
                rec["max_rel_vs_kept"][label] = rel
                rec["registers_spill_stores_spill_loads"][label] = next(
                    (v for k, v in built[(label, src)][2].items()
                     if re.search(mangled, k)), None)
            del kept
            inner = 20 if kernel == "step" else 3
            for turn in (list(fns), list(fns)[::-1]):
                for label in turn:
                    rec["ms"].setdefault(label, []).append(
                        cuda_ms(lambda fn=fns[label]: run(fn), inner, reps=5))
            best = {label: min(t) for label, t in rec["ms"].items()}
            shapes = [f"b{b}_p{p}" for b, p in SHAPES]
            rec["best_ms"] = best
            rec["fastest_shape"] = min(shapes, key=best.get)
            lines.append(rec)
            print(json.dumps(rec), flush=True)
            torch.cuda.empty_cache()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("".join(json.dumps(x) + "\n" for x in lines))
    print(card, flush=True)


if __name__ == "__main__":
    main()
