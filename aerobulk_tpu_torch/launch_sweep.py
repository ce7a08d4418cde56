"""The numerics and launch-shape sweep of the forward kernels 1, 3, 4 and 5
on one NVIDIA GPU.

    python3 -m aerobulk_tpu_torch.launch_sweep [--ref [LABEL=]DIR ...]
        [--kernels step,bulk,ice,mixed] [--out FILE]

Builds the forward sources of ``kernels/csrc/`` (``fused_step.cu``,
``fused_step_ecmwf.cu``, ``bulk_step.cu``, ``ice_step.cu`` and the mixed
kernel's ``mixed_step_<ocean>.cu``) once per variant (under
``kernels/_build/launch_sweep/``, all nvcc runs in parallel) and times every variant's kernel at the main
path's shapes, fp32 and fp64: the stateful step (``step``: COARE 3.6 and
ECMWF + skin, 721x1440, bench.py's forcing, a fresh state), the stateless
step of the five algorithms on a month of the 1-degree grid (``bulk``: 720 x
181 x 360 = 46,915,200 points), the ice-only step of the seven sea-ice
algorithms (``ice``) and the mixed cell of LG15 ice with each of the five
ocean algorithms and LG15_IO (``mixed``), both on BASELINE config 5's cold
forcing (721x1440).  The variants:

  * ``ref`` (with ``--ref DIR``; ``LABEL`` with ``--ref LABEL=DIR``,
    repeatable): the sources of another checkout's ``csrc/`` (e.g. the
    parent commit's), built with the flags of that checkout's
    ``kernels/_build.py`` (NVCC_FLAGS alone where there is none);
  * numerics, at one 256-thread block per SM and one point per thread:
    ``exact_div`` (NVCC_FLAGS alone), ``approx_div`` (-prec-div=false
    -ftz=false) and ``approx_div_sqrt`` (and -prec-sqrt=false, which is
    ``_build.FORWARD_FLAGS``);
  * launch shapes with the package's numerics (``_build.FORWARD_FLAGS``):
    ``b{B}_p{P}``, ``__launch_bounds__(256, B)`` for B in 1..4 and P points
    per thread for P in 1, 2 (-DABT_SWEEP_MIN_BLOCKS, -DABT_SWEEP_POINTS);
  * ``kept``: the sources and flags the package builds, with its tables of
    shapes.

Kernels 1 and 3 are timed per wrapper-like call (outputs allocated each
time) with CUDA events; kernels 4 and 5, whose launch is a tenth of a
millisecond, by themselves: the launch into outputs allocated once,
replayed from a CUDA graph and timed by slope (``measure.graph_ms``).
Each kernel is timed in two turns (the variants in order, then reversed),
the median of 5 runs per turn; a variant's time is the lower of its two.
Each variant's outputs are compared with ``kept``'s, and its registers and
spills read from ptxas.  Prints one JSON line per kernel and dtype, then
the card's name and power limit, and writes the lines to ``--out``.
"""

from __future__ import annotations

import argparse
import importlib.util
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
from .measure import cold_forcing, cuda_ms, graph_ms, grid_forcing, \
    month_forcing

#: the sources each kernel group builds
KERNELS = {"step": ("fused_step.cu", "fused_step_ecmwf.cu"),
           "bulk": ("bulk_step.cu",), "ice": ("ice_step.cu",),
           "mixed": _build.MIXED_SOURCES}
SOURCES = tuple(s for group in KERNELS.values() for s in group)
#: (minimum resident 256-thread blocks per SM, points per thread)
SHAPES = [(b, p) for p in (1, 2) for b in (1, 2, 3, 4)]
ALGOS = ("coare3p0", "coare3p6", "ecmwf", "ncar", "andreas")
#: the mixed cells timed: (ice algorithm, ocean algorithm, simultaneous)
MIXED = [("ice_lg15", o, False) for o in ALGOS] + \
    [("ice_lg15", "ecmwf", True)]
GRID = (721, 1440)
MONTH = (720, 181, 360)
NITER = 5
ISD = 43200.0


def _shape(b, p):
    return (f"-DABT_SWEEP_MIN_BLOCKS={b}", f"-DABT_SWEEP_POINTS={p}")


def ref_flags(csrc: Path):
    """The flags function of the checkout that holds ``csrc``: its
    ``kernels/_build.py``'s ``flags``, or NVCC_FLAGS alone without one."""
    path = csrc.parent / "_build.py"
    if not path.exists():
        return lambda source: _build.NVCC_FLAGS
    spec = importlib.util.spec_from_file_location("_ref_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, "flags", lambda source: mod.NVCC_FLAGS)


def variants(refs=()):
    """label -> (csrc directory, flags function of a source, defines);
    ``refs`` are ``DIR`` or ``LABEL=DIR`` strings."""
    approx = (*_build.NVCC_FLAGS, "-prec-div=false", "-ftz=false")
    v = {}
    for ref in refs:
        label, _, d = ref.rpartition("=")
        v[label or "ref"] = (Path(d), ref_flags(Path(d)), ())
    v["exact_div"] = (_build.CSRC, lambda s: _build.NVCC_FLAGS, _shape(1, 1))
    v["approx_div"] = (_build.CSRC, lambda s: approx, _shape(1, 1))
    v["approx_div_sqrt"] = (_build.CSRC,
                            lambda s: (*approx, "-prec-sqrt=false"),
                            _shape(1, 1))
    for b, p in SHAPES:
        v[f"b{b}_p{p}"] = (_build.CSRC,
                           lambda s: (*_build.NVCC_FLAGS,
                                      *_build.FORWARD_FLAGS), _shape(b, p))
    v["kept"] = (_build.CSRC, _build.flags, ())
    return v


def build(vs, root, jobs, sources=SOURCES):
    """Build every (variant, source) whose source exists in the variant's
    directory, at most ``jobs`` nvcc at once: {(label, source): (library,
    flags, ptxas report)}."""
    nvcc = _build.find_nvcc()
    todo = [(label, src) for label in vs for src in sources
            if (vs[label][0] / src).exists()]
    running, built, failed = [], {}, []
    while todo or running:
        while todo and len(running) < jobs:
            label, src = todo.pop(0)
            csrc, flags_of, defines = vs[label]
            flags = tuple(flags_of(src))
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


def _m(k):
    """An int template argument as the Itanium ABI mangles it."""
    return f"Li{'n' if k < 0 else ''}{abs(k)}E"


def targets(dev, dtype, kernels):
    """(kernel, algo, source, kernel name in ptxas, run, timer) for each
    kernel of the groups ``kernels`` at ``dtype``: ``run(fn)`` launches fn,
    the source's entry in a variant's build, once and returns its outputs,
    ``timer(fn)`` gives its ms."""
    t = "f" if dtype == torch.float32 else "d"
    out = []
    if "step" in kernels:
        grid = grid_forcing(GRID, dev, dtype)
        for algo, src in (("coare3p6", "fused_step.cu"),
                          ("ecmwf", "fused_step_ecmwf.cu")):
            cfg = AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=NITER,
                                 use_skin=True)
            ins = (*grid, *init_skin_state(cfg, GRID, dtype, dev))

            def run(fn, cfg=cfg, ins=ins):
                outs = [torch.empty_like(ins[0]) for _ in range(10)]
                _build.launch(fn, (*ins, *outs), *kfused._skin_args(cfg, ISD))
                return outs
            out.append(("step", algo, src, rf"fused_step_kernelI{t}", run,
                        lambda fn, run=run: cuda_ms(lambda: run(fn), 20,
                                                    reps=5)))
    if "bulk" in kernels:
        month = month_forcing(MONTH, dev, dtype)
        flat = [x.reshape(-1) for x in month.values()]
        for algo in ALGOS:
            args = kfused._bulk_args(AeroBulkConfig(
                algo=algo, zt=2.0, zu=10.0, niter=NITER, use_skin=False))

            def run(fn, args=args):
                outs = [torch.empty_like(flat[0]) for _ in range(6)]
                _build.launch(fn, (*flat, *outs), *args)
                return outs
            out.append(("bulk", algo, "bulk_step.cu",
                        rf"bulk_step_kernelI{t}{_m(kfused._BULK_ALGOS[algo])}",
                        run, lambda fn, run=run: cuda_ms(lambda: run(fn), 3,
                                                         reps=5)))
    cold = cold_forcing(GRID, dev, dtype) if {"ice", "mixed"} & kernels \
        else None
    binds = []
    if "ice" in kernels:
        Ts_i, _, ta, q, u, v, slp, frice = cold
        for algo, index in kfused._ICE_ALGOS.items():
            binds.append((
                "ice", algo, "ice_step.cu", rf"ice_step_kernelI{t}{_m(index)}",
                lambda fn, algo=algo: kfused.ice_step_launch(
                    algo, 2.0, 10.0, Ts_i, ta, q, u, v, slp, frice=frice,
                    niter=NITER, fn=fn)))
    if "mixed" in kernels:
        for ice, ocean, simul in MIXED:
            src = kfused.mixed_source(ocean, simul)
            k = -1 if simul else kfused._BULK_ALGOS[ocean]
            ice_k = kfused._ICE_ALGOS["ice_lg15_io" if simul else ice]
            binds.append((
                "mixed", "lg15_io" if simul else f"{ice}+{ocean}", src,
                rf"mixed_step_kernelI{t}{_m(k)}{_m(ice_k)}[NE]",
                lambda fn, ice=ice, ocean=ocean, simul=simul:
                    kfused.mixed_step_launch(
                        2.0, 10.0, *cold, ice_algo=ice, ocean_algo=ocean,
                        niter=NITER, simultaneous=simul, fn=fn)))
    for kernel, algo, src, mangled, bind in binds:
        def run(fn, bind=bind):
            launch, outs = bind(fn)
            launch()
            return outs

        def timer(fn, bind=bind):
            return graph_ms(bind(fn)[0], repeats=5)
        out.append((kernel, algo, src, mangled, run, timer))
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
    ap.add_argument("--ref", action="append", default=[],
                    help="[LABEL=]DIR: another checkout's kernels/csrc/ to "
                         "time beside this one's (repeatable)")
    ap.add_argument("--kernels", default=",".join(KERNELS),
                    help="the kernel groups to sweep, of "
                         f"{','.join(KERNELS)}")
    ap.add_argument("--out", default=str(_build.BUILD_DIR / "launch_sweep"
                                         / "results.jsonl"))
    ap.add_argument("--jobs", type=int, default=12,
                    help="nvcc processes at once")
    args = ap.parse_args(argv)
    kernels = set(args.kernels.split(","))
    if not kernels <= set(KERNELS):
        ap.error(f"--kernels: unknown {sorted(kernels - set(KERNELS))}")
    if not torch.cuda.is_available():
        sys.exit("launch_sweep: no CUDA device; this sweep runs only on a GPU")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    vs = variants(args.ref)
    sources = [s for k in KERNELS if k in kernels for s in KERNELS[k]]
    t0 = time.perf_counter()
    built = build(vs, _build.BUILD_DIR / "launch_sweep", args.jobs, sources)
    lines = [{"part": "build", "seconds": time.perf_counter() - t0,
              "card": card, "variants": {
                  label: {src: list(built[(label, src)][1])
                          for src in sources if (label, src) in built}
                  for label in vs}}]
    print(json.dumps(lines[0]), flush=True)
    for dtype in (torch.float32, torch.float64):
        for kernel, algo, src, mangled, run, timer in targets(
                dev, dtype, kernels):
            fns = {label: _build.entry(src, dtype, built[(label, src)][0])
                   for label in vs if (label, src) in built}
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
            for turn in (list(fns), list(fns)[::-1]):
                for label in turn:
                    rec["ms"].setdefault(label, []).append(timer(fns[label]))
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
