"""Where the gradient kernel's time goes, by stage, on one NVIDIA GPU.

    python3 grad_stage_cost.py

Builds copies of ``aerobulk_tpu_torch/kernels/csrc/`` (under
``aerobulk_tpu_torch/kernels/_build/stage_cost/``) in which ``adj::vjp``
returns at once for one group of stages of ``csrc/adjoint.cuh``, and times
each copy's gradient kernel against the full one, in turns, with CUDA
events, at the main path's shape (721x1440, fp32, COARE 3.6 and ECMWF +
skin, niter=5, bench.py's forcing).  A skipped group's time saved is what
its adjoints cost: the dual-number Jacobians of the stages still on duals
(the one-input stages and ECMWF's own), or the written-out ``adj()`` of
the others (for the stages whose forward keeps what their walk back
reads, the cool skin, the warm layer, q_s and COARE's psi, only the walk
back: the forward runs for its values); the gradients of a copy are wrong and are
not compared.  "no_duals" skips every stage still on duals, "no_stages"
every stage: what is left is the sweeps and the adjoints written out
across stages (``bulk_adj``, ``wl_ecmwf_solve_vjp``), less what the
compiler drops as unused.  Prints one JSON line per algorithm, then the
card's name and power limit.
"""

import ctypes
import json
import shutil
import subprocess
import sys

import torch

import aerobulk_tpu_torch as abt
import chip_smoke as cs
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as kfused

#: the stages with a written-out adjoint (adjoint.cuh's ABT_ADJ)
WRITTEN_OUT = ["HumStage", "WindStage", "ThetaStage", "Surface0Stage",
               "SurfaceStage", "DeltaStage", "QnsCoefStage", "RhoStage",
               "FluxStage", "FirstGuessStage<false>", "FirstGuessStage<true>",
               "CoarePreStage", "CoareOolStage", "CoareUbStage", "CoareZ0Stage",
               "CoareScalesStage", "CoareUsStage", "CoareHeightStage",
               "CoareCsStage", "CoareWlStage", "CoareCoefStage"]
DUALS_PSI = ["CoarePsiStage", "EcmwfPsiStage", "EcmwfPsiMzStage",
             "EcmwfPsiHzStage", "EcmwfFmStage"]
DUALS_ALPHA_VISC = ["AlphaStage", "ViscStage"]
DUALS_ECMWF_REST = ["EcmwfPreStage", "EcmwfOolStage", "EcmwfRoughStage",
                    "EcmwfUbStage", "EcmwfScalarStage<false>",
                    "EcmwfScalarStage<true>", "EcmwfFStage", "EcmwfCsStage",
                    "EcmwfWlPreStage", "EcmwfCoefStage"]
#: group -> the stage functors whose adjoints it skips (None: every stage)
GROUPS = {
    "base": [],
    "duals_psi": DUALS_PSI,
    "duals_alpha_visc": DUALS_ALPHA_VISC,
    "duals_ecmwf_rest": DUALS_ECMWF_REST,
    "adj_cool_skin": ["CoareCsStage"],
    "adj_warm_layer": ["CoareWlStage"],
    "written_out": WRITTEN_OUT,
    "no_duals": DUALS_PSI + DUALS_ALPHA_VISC + DUALS_ECMWF_REST,
    "no_stages": None,
}
SOURCES = ("fused_grad.cu", "fused_grad_ecmwf.cu")


def variant_sources(root, skips):
    """csrc/ copied to ``root`` with adj::vjp returning at once for the
    stages ``skips`` (None: for every stage)."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    path = root / "adjoint.cuh"
    text = path.read_text()
    skip_all = "true" if skips is None else "false"
    spec = "".join(f"template <> struct Skip<{t}> {{ static constexpr bool "
                   f"value = true; }};\n" for t in skips or ())
    for anchor, new in (
            ("// *xb[j] += sum_i yb[i] * dy_i / dx_j at x: the stage's adj()",
             f"template <typename F> struct Skip {{ static constexpr bool "
             f"value = {skip_all}; }};\n"),
            ("  if constexpr (HasAdj<F>::value) f.adj(x, yb, xb);",
             "  if constexpr (Skip<F>::value) return;\n"),
            ("  f.bwd(x, t, yb, xb);", "  if constexpr (Skip<F>::value) return;\n"),
            ("  for (int i = 0; i < M; ++i) s += yb[i] * yd[i].d[0];",
             "  if constexpr (Skip<F>::value) return;\n"),
            ("template <typename Solve> struct SkinVjp;", spec)):
        if text.count(anchor) != 1:
            raise RuntimeError(f"adjoint.cuh no longer has {anchor!r}")
        text = text.replace(anchor, new + anchor)
    path.write_text(text)


def main():
    if not torch.cuda.is_available():
        sys.exit("grad_stage_cost: no CUDA device; this script runs only on "
                 "a GPU")
    dev = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    base = _build.BUILD_DIR / "stage_cost"
    jobs = {}
    for group, skips in GROUPS.items():
        variant_sources(base / group, skips)
        for src in SOURCES:
            out = base / group / f"lib_{src[:-3]}.so"
            jobs[(group, src)] = (subprocess.Popen(
                [nvcc, *_build.flags(src), "-o", str(out),
                 str(base / group / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
    libs = {}
    for key, (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        libs[key] = ctypes.CDLL(str(out))

    for algo in ("coare3p6", "ecmwf"):
        cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=cs.NITER,
                                 use_skin=True)
        src = "fused_grad_ecmwf.cu" if algo == "ecmwf" else "fused_grad.cu"
        entry = ("abt_fused_grad_ecmwf_f32" if algo == "ecmwf"
                 else "abt_fused_grad_f32")
        ins = (*cs.make_inputs(dev, torch.float32),
               *abt.init_skin_state(cfg, (cs.NY, cs.NX), torch.float32, dev))
        cts = cs.cotangents((cs.NY, cs.NX), torch.float32, dev, seed=8)
        ms = {}
        for turn in (list(GROUPS), list(GROUPS)[::-1]):
            for group in turn:
                fn = getattr(libs[(group, src)], entry)
                fn.argtypes = _build._STEP_ARGTYPES
                fn.restype = ctypes.c_int

                def run(fn=fn):
                    grads = [torch.empty_like(ins[0]) for _ in range(13)]
                    kfused._call(fn, ins[0], (*ins, *cts, *grads), cfg,
                                 43200.0)
                ms.setdefault(group, []).append(cs.cuda_ms(run, 5))
        base_ms = min(ms["base"])
        print(json.dumps({
            "algo": algo, "dtype": "torch.float32", "shape": [cs.NY, cs.NX],
            "ms": ms, "saved_ms": {g: base_ms - min(t) for g, t in ms.items()
                                   if g != "base"}}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
