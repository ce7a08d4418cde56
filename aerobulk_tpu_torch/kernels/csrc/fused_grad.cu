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
// How: CUDA has no autodiff, so the derivative comes from forward-mode
// tangents through the same templated body as the forward kernel
// (flux_point.cuh instantiated with Dual<S, K> of dual.cuh).  Each pass
// seeds K unit tangents among the 13 inputs and gives K columns of J; the
// kernel runs ceil(13 / K) passes.  K is a template parameter, set at
// build time (-DABT_GRAD_K, from kernels/_build.py).  At the points where a
// function is not differentiable the duals follow JAX's reverse-mode
// conventions (dual.cuh), so forward and reverse mode agree there too.
//
// What bounds it on this card: per point it reads 23 fields (13 inputs + 10
// cotangents) and writes 13, ~144 B at fp32, against ceil(13/K) passes of
// the ~2k-operation forward body, each with K tangent updates per operation
// on top.  So it is bound by arithmetic, even more than the forward kernel.
// K trades passes against registers: K = 1 runs the primal (and each
// transcendental's derivative) 13 times with one tangent, in the fewest
// registers (fp32 180, no spills); K = 13 runs them once with 13 tangents
// per value, at 255 registers and a few KB of spills per thread that stay
// mostly on chip.  Measured on an H100 at 721x1440, fewer passes won over
// fewer spills: K = 13 takes 0.59x K = 1's time in fp32 and 0.66x in fp64
// (PERF.md), so K = 13 is the default.  One thread owns one point, as in
// the forward kernel; the grid is the flattened field (blockDim 256) with
// a bounds mask.
//
// Numerics: the rules of fused_step.cu hold (no --use_fast_math, T(...) on
// every constant, NaN-propagating maxp/minp, FMA contraction as the
// expected ulp-level source of kernel/plain differences).  The primal of
// each pass is the forward kernel's arithmetic on the same inputs.
//
// Plain C interface (abt_fused_grad_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "dual.cuh"
#include "flux_point.cuh"

#ifndef ABT_GRAD_K
#error "build with -DABT_GRAD_K=<tangents per pass> (kernels/_build.py)"
#endif

// the skin solve and the entry names: COARE's here, ECMWF's when
// fused_grad_ecmwf.cu includes this file
#ifndef ABT_GRAD_SOLVE
#define ABT_GRAD_SOLVE abt::CoareSkin
#define ABT_GRAD_ENTRY(dtype) abt_fused_grad_##dtype
#endif

namespace {

using abt::Dual;
using abt::Params;

constexpr int kIn = 13, kOut = 10;

template <typename S> struct GradFields {
  const S* in[kIn];    // sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, state x4
  const S* ct[kOut];   // cotangents of QL QH Tau_x Tau_y Evap T_s, new state x4
  S* grad[kIn];        // gradients of the 13 inputs
};

template <typename S, int K>
__global__ void __launch_bounds__(256)
fused_grad_kernel(GradFields<S> f, int64_t n, Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  S x[kIn], ct[kOut], g[kIn];
#pragma unroll
  for (int j = 0; j < kIn; ++j) x[j] = f.in[j][i];
#pragma unroll
  for (int o = 0; o < kOut; ++o) ct[o] = f.ct[o][i];

  constexpr int kPasses = (kIn + K - 1) / K;
#pragma unroll 1
  for (int pass = 0; pass < kPasses; ++pass) {
    // input j carries tangent k where j == pass * K + k
    Dual<S, K> in[kIn], out[kOut];
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
      in[j].v = x[j];
#pragma unroll
      for (int k = 0; k < K; ++k) in[j].d[k] = (pass * K + k == j) ? S(1) : S(0);
    }
    abt::flux_point<ABT_GRAD_SOLVE>(in, out, p);
#pragma unroll
    for (int j = 0; j < kIn; ++j) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (pass * K + k == j) {
          S s = S(0);
#pragma unroll
          for (int o = 0; o < kOut; ++o) s += ct[o] * out[o].d[k];
          g[j] = s;
        }
      }
    }
  }
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
  constexpr int kBlock = 256;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  if (n > 0) {
    fused_grad_kernel<S, ABT_GRAD_K><<<static_cast<unsigned>(blocks), kBlock, 0,
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
