// One stateful COARE 3.0 / 3.6 + cool-skin + warm-layer flux step per grid
// point, as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_kernel (its body
// is api.flux_step on one VMEM tile; launched by _fused and fused_flux_step).
// The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_flux_step_plain, i.e. the eager
// api.flux_step of the port.
//
// What bounds it on this card: per point it reads 13 fields (9 inputs + 4
// warm-layer state) and writes 10 (6 outputs + 4 state), ~92 B at fp32,
// against ~4.2k floating-point operations (6.5k for ECMWF), most of the
// issue time in transcendentals and divisions (exp, log, pow, atan, sqrt
// and / in the niter-unrolled Monin-Obukhov loop, the 4-pass cool skin and
// the 5-pass warm-layer depth solve).  So it is bound by the issue of its
// op mix, not by bandwidth.  The design keeps the whole solve in registers:
// one thread owns one point, reads its inputs once and writes its outputs
// once, with no shared memory and no inter-thread traffic.  Tensor cores,
// TMA, shared memory and clusters have nothing to do here: the work is a
// pointwise scalar solve with no matrix product.  The grid is the flattened
// field (blocks of 256 threads, StepShape per build and dtype) with a
// bounds mask; the TPU wrapper's edge padding to (32, 256) tiles is not
// needed.
//
// Everything that is uniform across the grid (niter, the COARE version's
// constants, zt, zu, rdt, gdept, the humidity kind and isecday_utc) is a
// kernel argument, so its branches cost no divergence.
//
// Numerics, kept deliberately:
//  * not --use_fast_math, which would flush denormals and swap every
//    transcendental for its approximation; three approximations are taken
//    where the issue time goes (PERF.md §5-6), each within a few ulp:
//    - fp32 division and square root are nvcc's -prec-div=false
//      (div.full.f32: within 2 ulp over the full range) and
//      -prec-sqrt=false (sqrt.approx.f32) (kernels/_build.py
//      FORWARD_FLAGS), in this source and the others of kernels 1, 3, 4
//      and 5, and in the gradient kernels 2 and 2e (fused_grad.cu,
//      fused_grad_ecmwf.cu), whose reverse sweep recomputes this forward
//      and so takes its arithmetic; -ftz=false keeps denormals; fp64
//      division and square root are exact in every build;
//    - every power raises a positive base to a constant or grid-uniform
//      exponent and goes through common.cuh's pow_pos, exp2(c log2 x):
//      within |c log2 x| + 2 ulp, a few ulp at the sites' ranges;
//  * every other transcendental is libdevice's (atan and cbrt too, not
//    the TPU compiler's stand-ins);
//  * every constant is T(...) of a double, as PyTorch casts a Python float
//    to the tensor's dtype, and constant sub-expressions that Python folds
//    in double are folded in double here;
//  * maxp/minp propagate NaN like torch.maximum/torch.clamp (fmax/fmin
//    would drop it);
//  * floor_mod is the floor-mod of jnp.mod/torch.remainder (C fmod
//    truncates), trunc is Fortran INT(), step(x) is x >= 0, fsign is
//    copysign;
//  * nvcc contracts a*b+c into one FMA (-fmad=true, the default) where the
//    eager path rounds twice.
// These, not the algorithm, are the sources of the kernel/plain
// differences that the parity gates of chip_smoke.py bound.
//
// The per-point body lives in flux_point.cuh, a template on the scalar type
// that the backward kernel (fused_grad.cu) instantiates with dual numbers,
// and on the skin solve.  This file builds COARE's; fused_step_ecmwf.cu
// builds it again with ECMWF's (ABT_STEP_SOLVE, ABT_STEP_ENTRY), as a
// library of its own.
//
// Plain C interface (abt_fused_step_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "flux_point.cuh"

#ifndef ABT_STEP_SOLVE
#define ABT_STEP_SOLVE abt::CoareSkin
#define ABT_STEP_ENTRY(dtype) abt_fused_step_##dtype
#define ABT_STEP_F32_MIN_BLOCKS 3
#endif

namespace {

using abt::Params;

template <typename T> struct Fields {
  const T* in[13];     // sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, state x4
  T* out[10];          // QL QH Tau_x Tau_y Evap T_s, new state x4
};

constexpr int kBlock = 256;

// The launch shape of one build (skin solve) and dtype: at least kMinBlocks
// blocks of kBlock threads resident per SM (so at most 65536 / (kBlock
// kMinBlocks) registers a thread) and kPoints points per thread.  A sweep's
// build sets one shape for all with -DABT_SWEEP_MIN_BLOCKS=B
// -DABT_SWEEP_POINTS=P.
#ifdef ABT_SWEEP_MIN_BLOCKS
template <typename Solve, typename T> struct StepShape {
  static constexpr int kMinBlocks = ABT_SWEEP_MIN_BLOCKS, kPoints = ABT_SWEEP_POINTS;
};
#else
// The fastest shape of the sweep on an H100 (PERF.md §6): three blocks per
// SM, except ABT_STEP_F32_MIN_BLOCKS = 4 for the fp32 ECMWF step (64
// registers, 8 B of spills).  fp32 COARE keeps its 76 registers; fp64 (130
// registers COARE, 146 ECMWF uncapped: one block per SM) runs at 80 with
// ~0.3 KB of spills.
template <typename Solve, typename T> struct StepShape {
  static constexpr int kMinBlocks = sizeof(T) == 4 ? ABT_STEP_F32_MIN_BLOCKS : 3;
  static constexpr int kPoints = 1;
};
#endif

// A block covers kBlock * kPoints consecutive points; thread t takes points
// t, t + kBlock, ..., so every load and store of a warp is coalesced.
template <typename T, typename Shape = StepShape<ABT_STEP_SOLVE, T>>
__global__ void __launch_bounds__(kBlock, Shape::kMinBlocks)
fused_step_kernel(Fields<T> f, int64_t n, Params p) {
  constexpr int kPoints = Shape::kPoints;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kBlock * kPoints) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int64_t i = first + j * kBlock;
    if (i >= n) return;
    T in[13], out[10];
#pragma unroll
    for (int k = 0; k < 13; ++k) in[k] = f.in[k][i];
    abt::flux_point<ABT_STEP_SOLVE>(in, out, p);
#pragma unroll
    for (int k = 0; k < 10; ++k) f.out[k][i] = out[k];
  }
}

template <typename T>
int launch(void* const* ptrs, int64_t n, int niter, int charn_law,
           int visc_at_tzu, int humidity, double z0t_max, double z0t_coef,
           double z0t_pow, double beta0, double zt, double zu, double rdt,
           double gdept, double isecday_utc, void* stream) {
  Fields<T> f;
  for (int k = 0; k < 13; ++k) f.in[k] = static_cast<const T*>(ptrs[k]);
  for (int k = 0; k < 10; ++k) f.out[k] = static_cast<T*>(ptrs[13 + k]);
  Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
           z0t_pow, beta0, zt, zu, rdt, gdept, isecday_utc};
  constexpr int64_t kSpan = kBlock * StepShape<ABT_STEP_SOLVE, T>::kPoints;
  const int64_t blocks = (n + kSpan - 1) / kSpan;
  if (n > 0) {
    fused_step_kernel<T><<<static_cast<unsigned>(blocks), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(f, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: 23 device pointers in the order of Fields (13 in, 10 out).
#define ABT_ENTRY(name, T)                                                       \
  extern "C" int name(void* const* ptrs, int64_t n, int niter, int charn_law,   \
                      int visc_at_tzu, int humidity, double z0t_max,            \
                      double z0t_coef, double z0t_pow, double beta0, double zt, \
                      double zu, double rdt, double gdept, double isecday_utc,  \
                      void* stream) {                                           \
    return launch<T>(ptrs, n, niter, charn_law, visc_at_tzu, humidity,          \
                     z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, rdt, gdept,     \
                     isecday_utc, stream);                                      \
  }

ABT_ENTRY(ABT_STEP_ENTRY(f32), float)
ABT_ENTRY(ABT_STEP_ENTRY(f64), double)
