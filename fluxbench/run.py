"""One run of one cell of the benchmark of ``aerobulk_tpu_torch`` on the
card.

    python3 fluxbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

1. Set-up (``setup_s``): torch and the program imported, the cell's
   configuration (``configs/<config>.json``) and traffic mix
   (``traffic/<mix>.json``) read by the names ``BENCHMARK.json`` gives, the
   forcing made from ``--seed``, the kernel libraries loaded (built with
   nvcc into the program's build directory in the checkout the first time),
   and warm calls.
2. A closed loop: one caller makes calls back to back until ``--seconds``
   have passed; the window ends with the call in progress.  With
   ``--trace 1`` the loop runs under ``torch.profiler``.
3. The check: a sample of the window's calls, drawn from the seed, against
   the plain reference in float64 (``reference/``), each number beside its
   limit (``limits/<cell>.json``).
4. The metrics (``metrics/<metric>.py``, each a reader of the run) and one
   JSON line on standard output.

Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result; it never falls back to the CPU.  It exits 3 and prints no
result if ``jax``, ``jaxlib``, ``flax`` or ``aerobulk_tpu`` (the JAX
package, compared by whole top-level name) was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fluxbench import trace as tr  # noqa: E402

#: top-level module names no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "aerobulk_tpu")


def forbidden_modules():
    """The forbidden top-level names among the loaded modules."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_module(path: Path):
    """Import the file ``path`` as a module of its own."""
    if not path.exists():
        raise FileNotFoundError(f"fluxbench: {path.relative_to(ROOT)} is "
                                "missing")
    name = "_fluxbench_" + path.relative_to(HERE).as_posix().replace(
        "/", "__").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path):
    if not path.exists():
        raise FileNotFoundError(f"fluxbench: {path.relative_to(ROOT)} is "
                                "missing")
    return json.loads(path.read_text())


class Cell:
    """A workload of ``BENCHMARK.json`` and what it names: its config, its
    mix, its entry, its metrics and its limits, each from its own file."""

    def __init__(self, bench: dict, workload: str):
        cells = {w["name"]: w for w in bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"fluxbench: no workload {workload!r} in "
                           f"BENCHMARK.json ({sorted(cells)})")
        self.name = workload
        self.spec = cells[workload]
        configs = {c["name"]: c for c in bench["configs"]}
        self.cfg = read_json(ROOT / configs[self.spec["config"]]["file"])
        self.mix = read_json(HERE / "traffic" / f"{self.spec['traffic']}.json")
        self.entry = load_module(HERE / "entries" / f"{self.mix['entry']}.py")
        self.chips = int(self.spec["chips"])

        def mine(m):
            return workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]
        self.limits_path = HERE / "limits" / f"{workload}.json"

    def readers(self, traced: bool):
        metrics = self.per_layer if traced else self.end_to_end
        return [(m, load_module(HERE / "metrics" / f"{m['name']}.py"))
                for m in metrics]

    def limits(self):
        """{number: {"limit": ..., "lower": ..., "upper": ...}}; a key
        starting with "_" is a note."""
        return {k: v for k, v in read_json(self.limits_path).items()
                if not k.startswith("_")}


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell: Cell, call, device_kind: str):
        self.workload = cell.name
        self.cfg, self.mix = cell.cfg, cell.mix
        self.kernels = call.kernels
        self.device_kind = device_kind
        self.points_per_call = call.points
        self.records_per_call = call.records
        self.points_per_record = call.points // call.records
        self.counters = call.counters
        self.setup_s = None
        self.window_s = None
        self.calls = 0
        self.call_seconds = []
        self.trace = None


def card_power_limit():
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else f"nvidia-smi exit {r.returncode}"
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi unavailable: {e}"


def measure(cell: Cell, seed: int, seconds: float, traced: bool,
            device: torch.device, shape=None, t0=None, log=print):
    """Set up, run the window and check one run of ``cell``; returns
    (result line as a dict, the check's lines).  ``shape`` replaces the
    config's grid (the CPU tests' small runs); ``t0`` is the host clock at
    which set-up began."""
    t0 = time.perf_counter() if t0 is None else t0
    shape = tuple(cell.cfg["grid"]) if shape is None else tuple(shape)
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    stages = {"start": time.perf_counter() - t0}
    call = cell.entry.Call(cell.cfg, cell.mix, seed, shape, device)
    stages["forcing"] = time.perf_counter() - t0
    keep = int(cell.mix["check_calls"])
    # warm-up: every kernel built and loaded, and the allocator's pool
    # holding as many calls' outputs as the window keeps at once
    warm = [call()]
    stages["first_call"] = time.perf_counter() - t0
    warm += [call() for _ in range(int(cell.mix["warm_calls"]) - 1)]
    del warm
    for v in call.counters.values():
        v.clear()
    run = Run(cell, call, kind)
    run.setup_s = time.perf_counter() - t0
    readers = cell.readers(traced)

    sampler = np.random.default_rng([int(seed) % 2 ** 64, 1])
    kept, failed, first_error = [], 0, None
    with tr.profiled(traced, cuda) as prof:
        with torch.profiler.record_function(tr.WINDOW_SPAN):
            start = time.perf_counter()
            deadline = start + seconds
            while True:
                c0 = time.perf_counter()
                try:
                    with torch.profiler.record_function("fluxbench.call"):
                        result = call()
                except Exception:      # a failed call is counted, not fatal
                    failed += 1
                    first_error = first_error or traceback.format_exc()
                    result = None
                c1 = time.perf_counter()
                run.call_seconds.append(c1 - c0)
                # reservoir sampling: each call kept with equal chance
                n = len(run.call_seconds)
                if result is not None:
                    if len(kept) < keep:
                        kept.append((n - 1, result))
                    else:
                        j = int(sampler.integers(n))
                        if j < keep:
                            kept[j] = (n - 1, result)
                del result
                if c1 >= deadline:
                    break
    run.window_s = c1 - start
    run.calls = len(run.call_seconds) - failed
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if prof is not None:
        t = time.perf_counter()
        run.trace = tr.Trace(prof)
        del prof
        log(f"trace: {len(run.trace.dev_name)} device operations, "
            f"{len(run.trace.host)} host operations, reduced in "
            f"{time.perf_counter() - t:.1f} s")

    metrics = {}
    for spec, reader in readers:
        value = reader.read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value),
                                     "unit": spec["unit"]}
    in_order = [1e3 * s for s in run.call_seconds]
    ms = sorted(in_order)
    quarters = [statistics.median(q) for q in np.array_split(
        in_order, min(4, len(in_order))) if len(q)]
    log(json.dumps({"workload": cell.name, "seed": seed, "calls": len(ms),
                    "failed": failed, "window_s": run.window_s,
                    "call_ms_median": statistics.median(ms),
                    "call_ms_p95": float(np.percentile(ms, 95)),
                    "call_ms_median_by_quarter": quarters,
                    "setup_s": run.setup_s, "setup_stages_s": stages,
                    "kept_calls": [i for i, _ in kept]}))
    if first_error:
        log(first_error)

    # the check, after the window, with the program's forcing released
    call.release()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    reference = call.reference(torch.float64)
    numbers = {}
    for i, result in kept:
        for name, (value, where) in call.numbers(call.answers(result),
                                                 reference).items():
            if name not in numbers or not value <= numbers[name][0]:
                numbers[name] = (value, f"call {i}, {where}")
    log(f"reference and check: {time.perf_counter() - t:.1f} s")
    limits = cell.limits()
    check = {}
    lines = []
    for name, (value, where) in sorted(numbers.items()):
        limit = limits.get(name, {}).get("limit")
        check[name] = {"value": value, "limit": limit}
        lines.append(f"check {name} {value!r} limit {limit!r} (worst at "
                     f"{where})")
    correct = (bool(kept) and failed == 0 and set(limits) <= set(check)
               and all(c["limit"] is not None and c["value"] <= c["limit"]
                       for c in check.values()))
    device_line = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                   "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace is not None:
        device_line.update(busy_s=run.trace.busy_s(),
                           window_s=run.trace.window_s)
    result = {"correct": correct, "attempted": len(run.call_seconds),
              "failed": failed, "metrics": metrics, "device": device_line}
    if run.trace is not None:
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_by_host()}
    result["check"] = check
    return result, lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cell = Cell(read_json(ROOT / "BENCHMARK.json"), a.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"fluxbench: {a.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count()} device(s); no result",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result, lines = measure(cell, a.seed, a.seconds, bool(a.trace), device,
                            t0=_T0, log=log)
    # after the window and outside set-up: nvidia-smi can take seconds
    log(f"card: {card_power_limit()}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    found = forbidden_modules()
    if found:
        print(f"fluxbench: forbidden modules loaded: {found}; no result",
              file=sys.stderr)
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
