"""Where the gradient kernel's time goes, by stage, on one NVIDIA GPU.

    python3 grad_stage_cost.py

Builds copies of ``aerobulk_tpu_torch/kernels/csrc/`` (under
``aerobulk_tpu_torch/kernels/_build/stage_cost/``) in which ``adj::vjp``
skips the dual-number Jacobians of one group of stages of
``csrc/adjoint.cuh``, and times each copy's gradient kernel against the
full one, in turns, with CUDA events, at the main path's shape (721x1440,
fp32, COARE 3.6 and ECMWF + skin, niter=5, bench.py's forcing).  A skipped
group's time saved is what its duals cost; the gradients of a copy are
wrong and are not compared.  "no_duals" skips every stage: what is left
is the sweeps in S and the hand-written adjoints.  Prints one JSON line
per algorithm, then the card's name and power limit.
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

#: group -> the stage functors whose duals it skips
GROUPS = {
    "base": [],
    "no_cool_skin": ["CoareCsStage", "EcmwfCsStage"],
    "no_warm_layer": ["CoareWlStage", "EcmwfWlPreStage"],
    "no_surface_q_sat": ["SurfaceStage"],
    "no_bulk_coefs_rho": ["QnsCoefStage", "RhoStage"],
    "no_psi": ["CoarePsiStage", "EcmwfPsiStage", "EcmwfPsiMzStage",
               "EcmwfPsiHzStage", "EcmwfFmStage"],
    "no_prologue_epilogue": ["FirstGuessStage<false>", "FirstGuessStage<true>",
                             "EcmwfPreStage", "ThetaStage", "HumStage",
                             "FluxStage", "CoareCoefStage", "EcmwfCoefStage"],
    "no_loop_rest": ["CoareOolStage", "CoareUbStage", "CoareZ0Stage",
                     "CoareScalesStage", "CoareUsStage", "CoareHeightStage",
                     "DeltaStage", "EcmwfOolStage", "EcmwfRoughStage",
                     "EcmwfUbStage", "EcmwfScalarStage<false>",
                     "EcmwfScalarStage<true>", "EcmwfFStage"],
    "no_duals": None,
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
            ("template <typename S, int M> struct Vec {",
             f"template <typename F> struct Skip {{ static constexpr bool "
             f"value = {skip_all}; }};\n"),
            ("  Dual<S, N> xd[N], yd[M];",
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
