"""The readings the limits of ``limits/<cell>.json`` are set from, on the
card at the cell's own size: for each ``--seeds`` seed, the numbers one
call of the program's timed path gives against the float64 reference (the
lower reading), and for each ``--control-seeds`` seed, the numbers of the
control, the plain reference computed in bfloat16 (the precision below the
configuration's float32; no matrix product runs, so TF32 does not apply)
and put in the program's place (the upper reading).  One JSON line a seed
and side.  The benchmark's runs do not run it.

    python3 fluxbench/control.py --workload <cell> --seeds 1 2 3 --control-seeds 1 2 3
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from fluxbench.run import Cell, read_json  # noqa: E402


def readings(cell: Cell, seed: int, program: bool, control: bool, device,
             shape=None):
    """{"program": numbers, "control": numbers} of one seed, each number as
    (value, where)."""
    shape = tuple(cell.cfg["grid"]) if shape is None else tuple(shape)
    call = cell.entry.Call(cell.cfg, cell.mix, seed, shape, device)
    out = {}
    answers = call.answers(call()) if program else None
    call.release()
    reference = call.reference(torch.float64)
    if program:
        out["program"] = call.numbers(answers, reference)
        del answers
    if control:
        out["control"] = call.numbers(call.reference(torch.bfloat16),
                                      reference)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("fluxbench control: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = Cell(read_json(ROOT / "BENCHMARK.json"), a.workload)
    for seed in dict.fromkeys(a.seeds + a.control_seeds):
        t = time.perf_counter()
        r = readings(cell, seed, seed in a.seeds, seed in a.control_seeds,
                     device)
        for side, numbers in r.items():
            print(json.dumps({"workload": a.workload, "seed": seed,
                              "side": side,
                              "numbers": {k: v for k, (v, _) in
                                          numbers.items()},
                              "where": {k: w for k, (_, w) in
                                        numbers.items()},
                              "seconds": time.perf_counter() - t}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
