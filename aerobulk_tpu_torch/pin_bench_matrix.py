"""Record the bench matrix of the port on the card as a committed artifact:
the counterpart of the JAX package's ``tools/pin_bench_matrix.py``.

    python3 -m aerobulk_tpu_torch.pin_bench_matrix [--commit C] [--out PATH]
    make bench-matrix-torch

Runs the JAX tool's modes as subprocesses of ``python3 -m
aerobulk_tpu_torch.bench`` on the card, adds ``bench_mode`` and
``provenance`` (the commit, the card's name and power limit, the timing)
to every JSON line, and writes them one per line to
``docs/BENCH_TORCH_ALL.json`` (``--out``).  ``docs/BENCH_ALL.json`` is the
JAX package's and is never written here.  Without a CUDA device it exits
non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import json
import subprocess
import sys
from pathlib import Path

import torch

from .bench import REPEATS

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "docs" / "BENCH_TORCH_ALL.json"

#: the modes of tools/pin_bench_matrix.py, with the same bench flags
MODES = [
    ("all", ["--all"]),
    ("niter20", ["--niter", "20"]),
    ("bf16", ["--bf16"]),
    ("grad", ["--grad"]),
    ("streamed", ["--streamed"]),
    ("streamed_i16", ["--streamed", "--wire-i16"]),
]


def _git_commit():
    """``git describe --always --dirty`` of the checkout, or None outside a
    git repository."""
    try:
        res = subprocess.run(["git", "describe", "--always", "--dirty"],
                             cwd=REPO, capture_output=True, text=True)
    except OSError:
        return None
    return res.stdout.strip() if res.returncode == 0 else None


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="python3 -m aerobulk_tpu_torch.pin_bench_matrix",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--commit", default=None,
                   help="the commit measured (default: git describe of the "
                        "checkout)")
    p.add_argument("--out", default=str(OUT), help="the file written")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit(f"{p.prog}: no CUDA device: the bench matrix measures the "
                 "card (an NVIDIA GPU)")
    commit = args.commit or _git_commit() or "unknown"
    stamp = datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y-%m-%dT%H:%MZ")
    out_lines = []
    for mode, flags in MODES:
        cmd = [sys.executable, "-m", "aerobulk_tpu_torch.bench", *flags]
        print(f"=== {' '.join(cmd[1:])} ===", flush=True)
        res = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
        if res.returncode != 0:
            print(res.stderr[-4000:], file=sys.stderr)
            sys.exit(f"bench mode {mode} failed (exit {res.returncode})")
        for ln in res.stdout.splitlines():
            if not ln.startswith("{"):
                continue
            rec = json.loads(ln)
            card = rec["card"]
            rec["bench_mode"] = mode
            rec["provenance"] = (
                f"python3 -m aerobulk_tpu_torch.bench {' '.join(flags)}; "
                f"CUDA events, median of {REPEATS}; {card['name']}, "
                f"{card['power_limit']}; commit {commit}; recorded {stamp}")
            out_lines.append(rec)
            print(json.dumps(rec), flush=True)
    path = Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(json.dumps(rec) + "\n" for rec in out_lines))
    print(f"wrote {path} ({len(out_lines)} records)")


if __name__ == "__main__":
    main()
