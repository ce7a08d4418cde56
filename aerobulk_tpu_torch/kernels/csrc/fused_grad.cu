// The gradient of one stateful COARE 3.0 / 3.6 + cool-skin + warm-layer flux
// step per grid point (its vector-Jacobian product), as one CUDA kernel for
// Hopper (sm_90a).
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_grad_kernel (its
// body is jax.vjp of api.flux_step on one VMEM tile; launched by
// _fused_grad and _fused_bwd_pallas).  The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_flux_step_vjp_plain, i.e.
// torch autograd of the port's eager api.flux_step.
//
// What it computes: for each point, given the 13 inputs x (sst t_zt hum_zt
// U_zu V_zu slp rad_sw rad_lw lon, state dT_wl Hz_wl Qnt_ac Tau_ac) and the
// 10 cotangents c of the outputs (QL QH Tau_x Tau_y Evap T_s, new state x4),
// the 13 gradients g_j = sum_i c_i * J_ij of the step's Jacobian J (10 x
// 13).  isecday_utc is a scalar argument and gets none.
//
// How: by reverse mode, as jax.vjp does, one thread per point, with no tape
// beyond the iteration checkpoints (csrc/adjoint.cuh): a forward
// sweep that keeps the outer loop's carried state at the start of each
// iteration, then a reverse sweep over the epilogue, the iterations (each
// recomputed from its checkpoint) and the first guess.  Every stage with
// two or more inputs, of either solve, walks back through an adjoint
// written out by hand (adjoint.cuh's adj(), or fwd / bwd for the stages
// whose forward keeps what their walk back reads), not through duals over
// its inputs; the one-input stages (psi, alpha, the viscosity) keep dual
// numbers (dual.cuh), which for one input cost what a reverse adjoint would.
// The rules at the points that are not differentiable live in dual.cuh
// alone (the Dual overloads and the share helpers every adj() calls), so
// the gradient agrees with jax.vjp there.
//
// What bounds it on this card: per point it reads 23 fields (13 inputs + 10
// cotangents) and writes 13, ~144 B at fp32, against the VJP's ~12.6k
// operations (COARE 3.6 + skin; roofline.CENSUS "grad_skin_coare3p6", the
// JAX graph of jax.vjp): bound by arithmetic, and above the census by
// what the reverse sweep recomputes (each iteration's primal again; a
// stage's few intermediates in its adj()).  Every walk back through a
// quotient takes 1/b and a/b^2, so it divides more than kernel 1; in fp32
// a division is div.full.f32 (an inline sequence around one reciprocal,
// with no slow path to call) and a square root sqrt.approx.f32, which
// share one pipe with the transcendentals; fp64 keeps the IEEE sequences.
// Its time on an H100 by stage group (grad_stage_cost.py) is in PERF.md
// §5: the forward sweep, then the cool skin's and the warm layer's walk
// back, are its largest parts.  The checkpoints (~13 scalars per
// iteration) and the spills go to local memory.  The grid is the
// flattened field (blockDim 256) with a bounds mask.
//
// Numerics: the rules of fused_step.cu hold in full (no --use_fast_math,
// denormals kept, libdevice's transcendentals, T(...) on every constant,
// NaN-propagating maxp/minp, FMA contraction as the expected ulp-level
// source of kernel/plain differences, powers through pow_pos, fp32
// division and square root under kernels/_build.py's FORWARD_FLAGS).  The
// reverse sweep recomputes kernel 1's forward from the same primal source
// (flux_point.cuh), and the values it differentiates come from kernel 1;
// built with kernel 1's flags, it takes the gradient through the
// arithmetic that produced those values, not through another rounding of
// the same expressions.
//
// Plain C interface (abt_fused_grad_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError(), or cudaErrorInvalidValue for niter outside [0,
// abt::adj::kMaxIter] without launching.

#include <cuda_runtime.h>
#include <cstdint>

#include "adjoint.cuh"

// the skin solve and the entry names: COARE's here, ECMWF's when
// fused_grad_ecmwf.cu includes this file
#ifndef ABT_GRAD_SOLVE
#define ABT_GRAD_SOLVE abt::CoareSkin
#define ABT_GRAD_ENTRY(dtype) abt_fused_grad_##dtype
#endif

namespace {

using abt::Params;

constexpr int kIn = 13, kOut = 10, kBlock = 256;

template <typename S> struct GradFields {
  const S* in[kIn];    // sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, state x4
  const S* ct[kOut];   // cotangents of QL QH Tau_x Tau_y Evap T_s, new state x4
  S* grad[kIn];        // gradients of the 13 inputs
};

// The launch shape of one build (skin solve) and dtype: at least kMinBlocks
// blocks of kBlock threads resident per SM, so at most 65536 / (kBlock
// kMinBlocks) registers a thread.  The fastest of two, three and four
// blocks per SM on an H100, in turns (PERF.md §6; grad_stage_cost.py
// --shapes): three for fp64 (80 registers; the spills cost less than the
// occupancy two blocks would lose); two for fp32 in both builds (128
// registers: with no division or square-root slow path to call, they
// spill less there than at three).
template <typename Solve, typename S> struct GradShape {
  static constexpr int kMinBlocks = 3;
};
template <typename Solve> struct GradShape<Solve, float> {
  static constexpr int kMinBlocks = 2;
};

template <typename S, typename Shape = GradShape<ABT_GRAD_SOLVE, S>>
__global__ void __launch_bounds__(kBlock, Shape::kMinBlocks)
fused_grad_kernel(GradFields<S> f, int64_t n, Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  S x[kIn], ct[kOut], g[kIn];
#pragma unroll
  for (int j = 0; j < kIn; ++j) x[j] = f.in[j][i];
#pragma unroll
  for (int o = 0; o < kOut; ++o) ct[o] = f.ct[o][i];
  abt::adj::flux_point_vjp<ABT_GRAD_SOLVE>(x, ct, g, p);
#pragma unroll
  for (int j = 0; j < kIn; ++j) f.grad[j][i] = g[j];
}

template <typename S>
int launch(void* const* ptrs, int64_t n, int niter, int charn_law,
           int visc_at_tzu, int humidity, double z0t_max, double z0t_coef,
           double z0t_pow, double beta0, double zt, double zu, double rdt,
           double gdept, double isecday_utc, void* stream) {
  GradFields<S> f;
  for (int k = 0; k < kIn; ++k) f.in[k] = static_cast<const S*>(ptrs[k]);
  for (int k = 0; k < kOut; ++k) f.ct[k] = static_cast<const S*>(ptrs[kIn + k]);
  for (int k = 0; k < kIn; ++k) f.grad[k] = static_cast<S*>(ptrs[kIn + kOut + k]);
  Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
           z0t_pow, beta0, zt, zu, rdt, gdept, isecday_utc};
  if (niter < 0 || niter > abt::adj::kMaxIter) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    fused_grad_kernel<S><<<static_cast<unsigned>(blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(f, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: 36 device pointers in the order of GradFields (13 in, 10 cotangents,
// 13 gradients); the scalar arguments are those of abt_fused_step_*.
#define ABT_ENTRY(name, S)                                                       \
  extern "C" int name(void* const* ptrs, int64_t n, int niter, int charn_law,   \
                      int visc_at_tzu, int humidity, double z0t_max,            \
                      double z0t_coef, double z0t_pow, double beta0, double zt, \
                      double zu, double rdt, double gdept, double isecday_utc,  \
                      void* stream) {                                           \
    return launch<S>(ptrs, n, niter, charn_law, visc_at_tzu, humidity,          \
                     z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, rdt, gdept,     \
                     isecday_utc, stream);                                      \
  }

ABT_ENTRY(ABT_GRAD_ENTRY(f32), float)
ABT_ENTRY(ABT_GRAD_ENTRY(f64), double)
