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
// against ~2k floating-point operations, most of them transcendental (exp,
// log, pow, atan, sqrt in the niter-unrolled Monin-Obukhov loop, the 4-pass
// cool skin and the 5-pass warm-layer depth solve).  So it is compute- and
// SFU-bound, not bandwidth-bound.  The design keeps the whole solve in
// registers: one thread owns one point, reads its inputs once and writes
// its outputs once, with no shared memory and no inter-thread traffic.
// The grid is the flattened field (blockDim 256) with a bounds mask; the
// TPU wrapper's edge padding to (32, 256) tiles is not needed.
//
// Everything that is uniform across the grid (niter, the COARE version's
// constants, zt, zu, rdt, gdept, the humidity kind and isecday_utc) is a
// kernel argument, so its branches cost no divergence.
//
// Numerics, kept deliberately:
//  * built without --use_fast_math: fast math changes the transcendentals'
//    precision and flushes denormals;
//  * every constant is T(...) of a double, as PyTorch casts a Python float
//    to the tensor's dtype, and constant sub-expressions that Python folds
//    in double are folded in double here;
//  * maxp/minp propagate NaN like torch.maximum/torch.clamp (fmax/fmin
//    would drop it);
//  * floor_mod is the floor-mod of jnp.mod/torch.remainder (C fmod
//    truncates), trunc is Fortran INT(), step(x) is x >= 0, fsign is
//    copysign;
//  * atan and cbrt are libdevice's, not the TPU compiler's stand-ins;
//  * nvcc contracts a*b+c into one FMA (-fmad=true, the default) where the
//    eager path rounds twice: that is the expected ulp-level source of
//    kernel/plain differences.
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
#endif

namespace {

using abt::Params;

template <typename T> struct Fields {
  const T* in[13];     // sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, state x4
  T* out[10];          // QL QH Tau_x Tau_y Evap T_s, new state x4
};

template <typename T>
__global__ void __launch_bounds__(256)
fused_step_kernel(Fields<T> f, int64_t n, Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T in[13], out[10];
#pragma unroll
  for (int k = 0; k < 13; ++k) in[k] = f.in[k][i];
  abt::flux_point<ABT_STEP_SOLVE>(in, out, p);
#pragma unroll
  for (int k = 0; k < 10; ++k) f.out[k][i] = out[k];
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
  constexpr int kBlock = 256;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
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
