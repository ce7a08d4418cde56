"""Where the gradient kernel's time goes, by stage, on one NVIDIA GPU.

    python3 grad_stage_cost.py              # ms saved by stage group
    python3 grad_stage_cost.py --shapes     # fp32 launch shapes, both builds

Builds copies of ``aerobulk_tpu_torch/kernels/csrc/`` (under
``aerobulk_tpu_torch/kernels/_build/stage_cost/``) in which ``adj::vjp``
returns at once for one group of stages of ``csrc/adjoint.cuh``, and times
each copy's gradient kernel against the full one, in turns, with CUDA
events, at the main path's shape (721x1440, fp32, COARE 3.6 and ECMWF +
skin, niter=5, bench.py's forcing).  A skipped group's time saved is what
its adjoints cost: the dual-number derivatives of the one-input stages
still on duals, or the written-out ``adj()`` of the others (for the stages
whose forward keeps what their walk back reads, the cool skins, the warm
layers, q_s and the psi slopes, only the walk back: the forward runs for
its values); the gradients of a copy are wrong and are not compared.
"no_duals" skips every stage still on duals, "no_stages" every stage: what
is left is the sweeps and the adjoints written out across stages
(``bulk_adj``, ``wl_ecmwf_solve_vjp``), less what the compiler drops as
unused.  Prints first, per build, the stage functors whose adjoint still
goes through dual numbers (``dual_vjp`` or ``vjp_d1``), as one point of a
host build of each build's sweep (g++) finds them; then one JSON line per
algorithm, then the card's name and power limit.

``--shapes`` instead builds ``fused_grad.cu`` and ``fused_grad_ecmwf.cu``
with ``GradShape<Solve, float>`` at 2, 3 and 4 blocks per SM and times the
fp32 kernel of each build at each, in turns, with ptxas's registers and
spill bytes: one JSON line per build.
"""

import argparse
import json
import re
import shutil
import subprocess
import sys

import torch

import aerobulk_tpu_torch as abt
import chip_smoke as cs
from aerobulk_tpu_torch.kernels import _build
from aerobulk_tpu_torch.kernels import fused as kfused

#: the stages with a written-out adjoint (adjoint.cuh's ABT_ADJ): COARE's
#: and those both solves share
WRITTEN_OUT = ["HumStage", "WindStage", "ThetaStage", "Surface0Stage",
               "SurfaceStage", "DeltaStage", "QnsCoefStage", "RhoStage",
               "FluxStage", "FirstGuessStage<false>", "FirstGuessStage<true>",
               "CoarePreStage", "CoareOolStage", "CoareUbStage", "CoareZ0Stage",
               "CoareScalesStage", "CoareUsStage", "CoareHeightStage",
               "CoareCsStage", "CoareWlStage", "CoareCoefStage"]
#: ECMWF's own stages, written out too
ADJ_ECMWF_OWN = ["EcmwfPreStage", "EcmwfOolStage", "EcmwfFmStage",
                 "EcmwfRoughStage", "EcmwfPsiMzStage", "EcmwfPsiHzStage",
                 "EcmwfUbStage", "EcmwfScalarStage<false>",
                 "EcmwfScalarStage<true>", "EcmwfFStage", "EcmwfCsStage",
                 "EcmwfWlPreStage", "EcmwfCoefStage"]
#: the one-input stages, on Dual<S, 1>
DUALS_PSI = ["CoarePsiStage", "EcmwfPsiStage"]
DUALS_ALPHA_VISC = ["AlphaStage", "ViscStage"]
#: group -> the stage functors whose adjoints it skips (None: every stage)
GROUPS = {
    "base": [],
    "duals_psi": DUALS_PSI,
    "duals_alpha_visc": DUALS_ALPHA_VISC,
    "adj_ecmwf_own": ADJ_ECMWF_OWN,
    "adj_cool_skin": ["CoareCsStage", "EcmwfCsStage"],
    "adj_warm_layer": ["CoareWlStage", "EcmwfWlPreStage"],
    "written_out": WRITTEN_OUT + ADJ_ECMWF_OWN,
    "no_duals": DUALS_PSI + DUALS_ALPHA_VISC,
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


#: a host build of each build's sweep at one point: prints the stage
#: functors whose adjoint went through dual numbers, one per line, after
#: "coare:" and "ecmwf:"
DUALS_HARNESS = r"""
#include <cstdio>
#include <set>
#include <string>
static std::set<std::string> on_duals;
#define ABT_ON_DUALS on_duals.insert(__PRETTY_FUNCTION__)
#include "adjoint.cuh"

template <typename Solve> static void one_point(const char* name) {
  // COARE 3.6's arguments, specific humidity, zt 2 m, zu 10 m, noon UTC
  const abt::Params p{5, 1, 1, 0, 0.00016, 5.8e-05, 0.72, 1.2, 2.0, 10.0,
                      3600.0, 1.0, 43200.0};
  const double x[13] = {290.0, 288.5, 0.009, 6.0, -3.0, 101000.0, 400.0,
                        350.0, 10.0, 0.1, 3.0, 1.0e4, 20.0};
  double ct[10], g[13];
  for (int i = 0; i < 10; ++i) ct[i] = 1.0;
  on_duals.clear();
  abt::adj::flux_point_vjp<Solve>(x, ct, g, p);
  std::printf("%s:\n", name);
  for (const std::string& f : on_duals) std::printf("%s\n", f.c_str());
}

int main() {
  one_point<abt::CoareSkin>("coare");
  one_point<abt::EcmwfSkin>("ecmwf");
  return 0;
}
"""
_FUNCTOR = re.compile(r"F = (?:abt::adj::)?([^;\]]+)")


def stages_on_duals(root):
    """{"coare": [...], "ecmwf": [...]}: each build's stage functors whose
    adjoint goes through dual_vjp or vjp_d1, from a host build (g++) of a
    copy of csrc/ at ``root`` that names them as it runs one point."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("grad_stage_cost: the list of stages on duals "
                           "needs a host C++ compiler (g++)")
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    path = root / "adjoint.cuh"
    text = path.read_text()
    for anchor in ("  Dual<S, N> xd[N], yd[M];\n",
                   "  S s = S(0);\n#pragma unroll\n"
                   "  for (int i = 0; i < M; ++i) s += yb[i] * yd[i].d[0];"):
        if text.count(anchor) != 1:
            raise RuntimeError(f"adjoint.cuh no longer has {anchor!r}")
        text = text.replace(anchor, "  ABT_ON_DUALS;\n" + anchor)
    path.write_text(text)
    (root / "on_duals.cpp").write_text(DUALS_HARNESS)
    exe = root / "on_duals"
    subprocess.run([cxx, "-std=c++17", "-O0", f"-I{root}", "-o", str(exe),
                    str(root / "on_duals.cpp")], check=True)
    found, build = {}, None
    for line in subprocess.run([str(exe)], capture_output=True, text=True,
                               check=True).stdout.splitlines():
        if line.endswith(":") and " " not in line:
            build = line[:-1]
            found[build] = []
        else:
            found[build].append(_FUNCTOR.search(line).group(1).strip())
    return {b: sorted(set(names)) for b, names in found.items()}


def _nvcc(nvcc, root, src):
    """Start nvcc on ``root / src`` into ``root / lib_<src>.so``."""
    out = root / f"lib_{src[:-3]}.so"
    return subprocess.Popen([nvcc, *_build.flags(src), "-o", str(out),
                             str(root / src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), out


def _load(jobs):
    """Wait for nvcc jobs {key: (proc, out)}: {key: (library, nvcc's
    log)}."""
    libs = {}
    for key, (proc, out) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log[-4000:]}")
        libs[key] = (out, log)
    return libs


def _runner(lib, src, ins, cts, cfg):
    """One launch of the fp32 gradient kernel of ``src`` built at ``lib``,
    into fresh gradients."""
    fn = _build.entry(src, torch.float32, lib)

    def run():
        grads = [torch.empty_like(ins[0]) for _ in range(13)]
        _build.launch(fn, (*ins, *cts, *grads),
                      *kfused._skin_args(cfg, 43200.0))
    return run


def _grad_case(algo, dev):
    """The config, the 13 inputs and the 10 cotangents of the timings."""
    cfg = abt.AeroBulkConfig(algo=algo, zt=2.0, zu=10.0, niter=cs.NITER,
                             use_skin=True)
    ins = (*cs.make_inputs(dev, torch.float32),
           *abt.init_skin_state(cfg, (cs.NY, cs.NX), torch.float32, dev))
    cts = cs.cotangents((cs.NY, cs.NX), torch.float32, dev, seed=8)
    return cfg, ins, cts


def stage_groups(dev, nvcc, base):
    """The ms each group's adjoints cost, per algorithm: one JSON line each."""
    jobs = {}
    for group, skips in GROUPS.items():
        variant_sources(base / group, skips)
        for src in SOURCES:
            jobs[(group, src)] = _nvcc(nvcc, base / group, src)
    libs = _load(jobs)
    for algo in ("coare3p6", "ecmwf"):
        cfg, ins, cts = _grad_case(algo, dev)
        src = "fused_grad_ecmwf.cu" if algo == "ecmwf" else "fused_grad.cu"
        ms = {}
        for turn in (list(GROUPS), list(GROUPS)[::-1]):
            for group in turn:
                run = _runner(libs[(group, src)][0], src, ins, cts, cfg)
                ms.setdefault(group, []).append(cs.cuda_ms(run, 5))
        base_ms = min(ms["base"])
        print(json.dumps({
            "algo": algo, "dtype": "torch.float32", "shape": [cs.NY, cs.NX],
            "ms": ms, "saved_ms": {g: base_ms - min(t) for g, t in ms.items()
                                   if g != "base"}}), flush=True)


#: the blocks per SM --shapes builds GradShape<Solve, float> at (a
#: specialization of each solve put before the kernel)
SHAPE_BLOCKS = (2, 3, 4)
#: each fp32 build --shapes times: its source and skin solve
SHAPE_BUILDS = {"coare3p6": ("fused_grad.cu", "abt::CoareSkin"),
                "ecmwf": ("fused_grad_ecmwf.cu", "abt::EcmwfSkin")}
_PRIMARY_SHAPE = "template <typename S, typename Shape = GradShape"


def shape_sources(root, blocks):
    """csrc/ copied to ``root`` with GradShape<Solve, float> at ``blocks``
    blocks per SM for each solve of SHAPE_BUILDS."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(_build.CSRC, root)
    path = root / "fused_grad.cu"
    text = path.read_text()
    if text.count(_PRIMARY_SHAPE) != 1:
        raise RuntimeError(f"fused_grad.cu no longer has {_PRIMARY_SHAPE!r}")
    text = text.replace(_PRIMARY_SHAPE, "".join(
        f"template <> struct GradShape<{solve}, float> {{\n"
        f"  static constexpr int kMinBlocks = {blocks};\n}};\n\n"
        for _, solve in SHAPE_BUILDS.values()) + _PRIMARY_SHAPE)
    path.write_text(text)


def shapes(dev, nvcc, base):
    """Each fp32 gradient build at each of SHAPE_BLOCKS, in turns: one
    JSON line a build of ms and ptxas's registers and spill bytes."""
    jobs = {}
    for blocks in SHAPE_BLOCKS:
        shape_sources(base / f"blocks{blocks}", blocks)
        for src, _ in SHAPE_BUILDS.values():
            jobs[(blocks, src)] = _nvcc(nvcc, base / f"blocks{blocks}", src)
    libs = _load(jobs)
    for algo, (src, _) in SHAPE_BUILDS.items():
        cfg, ins, cts = _grad_case(algo, dev)
        ms = {}
        for turn in range(3):
            order = SHAPE_BLOCKS if turn % 2 == 0 else SHAPE_BLOCKS[::-1]
            for blocks in order:
                run = _runner(libs[(blocks, src)][0], src, ins, cts, cfg)
                ms.setdefault(blocks, []).append(cs.cuda_ms(run, 5))
        print(json.dumps({
            "algo": algo, "dtype": "torch.float32",
            "shape": [cs.NY, cs.NX], "ms": ms,
            "min_ms": {b: min(t) for b, t in ms.items()},
            "registers_spill_stores_spill_loads": {
                b: _build.ptxas_report(libs[(b, src)][1])
                for b in SHAPE_BLOCKS}}), flush=True)
        del ins, cts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--shapes", action="store_true",
                        help="time each fp32 gradient build at 2, 3 and 4 "
                             "blocks per SM instead of the stage groups")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("grad_stage_cost: no CUDA device; this script runs only on "
                 "a GPU")
    dev = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    base = _build.BUILD_DIR / "stage_cost"
    print(json.dumps({"on_duals": stages_on_duals(base / "on_duals")}),
          flush=True)
    if args.shapes:
        shapes(dev, nvcc, base)
    else:
        stage_groups(dev, nvcc, base)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
