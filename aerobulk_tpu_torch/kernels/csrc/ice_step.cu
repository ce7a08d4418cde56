// The ice-only flux step (api.flux_step_ice) of the seven sea-ice algorithms,
// one grid point per thread, as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_ice_kernel (its
// body is api.flux_step_ice on one VMEM tile; launched by _fused_ice and
// fused_ice_step).  The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_ice_step_plain, the eager
// api.flux_step_ice of the port.
//
// What bounds it on this card: per point it reads 7 fields (6 when the
// algorithm takes no ice concentration) and writes 6, 52 B at fp32, against
// 187 (NEMO) to 1576 (BEST) floating-point operations per point with
// niter = 5 (the census of the JAX graph, chip_smoke.py ICE_OPS_PER_POINT).
// At the card's 67 TFLOP/s fp32 and 3.35 TB/s that is 3-24 us of arithmetic
// per million points against 16 us of memory: NEMO and LU12 are bound by
// bytes, the five iterated algorithms by operations.  The design is
// bulk_step.cu's: one thread owns one point, reads its inputs once, runs the
// whole solve in registers and writes its outputs once; no shared memory,
// no inter-thread traffic, a bounds mask over the flattened field (no
// padding to tiles).
//
// The algorithm is a template parameter, so no point branches on it: the host
// switch picks one of 7 x 2 (float, double) instantiations.  niter, zt, zu,
// the humidity kind and ice_easy's scalar coefficients (with sqrt(CdN),
// log(zt/zu) and log(zu/10) computed on the host in double) are kernel
// arguments, uniform over the grid.
//
// Numerics: the rules of fused_step.cu hold (no --use_fast_math, T(...) of a
// double on every constant, Python's double folds folded in double, Python's
// association order, NaN-propagating maxp/minp, FMA contraction as the
// expected ulp-level source of kernel/plain differences), except that fp32
// division is exact (kernels/_build.py's NVCC_FLAGS alone) and the ice
// algorithms' own powers are libdevice's pow.
//
// Plain C interface (abt_ice_step_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "ice_point.cuh"

namespace {

using abt::IceKw;
using abt::Params;

template <typename T> struct IceFields {
  const T* in[7];      // Ts_i t_zt hum_zt U_zu V_zu slp frice (null if unused)
  T* out[6];           // QL QH Tau_x Tau_y Evap T_s
};

template <typename T, int kIce>
__global__ void __launch_bounds__(256)
ice_step_kernel(IceFields<T> f, int64_t n, Params p, IceKw kw) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T in[7], out[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) in[k] = f.in[k][i];
  in[6] = abt::ice_needs_frice(kIce) ? f.in[6][i] : T(0);
  abt::ice_point<T, kIce>(in, out, p, kw);
#pragma unroll
  for (int k = 0; k < 6; ++k) f.out[k][i] = out[k];
}

template <typename T, int kIce>
void start(const IceFields<T>& f, int64_t n, const Params& p, const IceKw& kw,
           cudaStream_t stream) {
  constexpr int kBlock = 256;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  ice_step_kernel<T, kIce><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(f, n, p, kw);
}

template <typename T>
int launch(void* const* ptrs, int64_t n, int algo, int niter, int humidity, double zt,
           double zu, double CdN, double ChN, double CeN, double sqrt_CdN,
           double log_ztzu, double log_zu10, void* stream) {
  IceFields<T> f;
  for (int k = 0; k < 7; ++k) f.in[k] = static_cast<const T*>(ptrs[k]);
  for (int k = 0; k < 6; ++k) f.out[k] = static_cast<T*>(ptrs[7 + k]);
  const Params p{niter, 0, 0, humidity, 0.0, 0.0, 0.0, 0.0, zt, zu, 0.0, 0.0, 0.0};
  const IceKw kw{CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (abt::ice_needs_frice(algo) && f.in[6] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    switch (algo) {
      case abt::kIceNemo: start<T, abt::kIceNemo>(f, n, p, kw, s); break;
      case abt::kIceEasy: start<T, abt::kIceEasy>(f, n, p, kw, s); break;
      case abt::kIceAn05: start<T, abt::kIceAn05>(f, n, p, kw, s); break;
      case abt::kIceLu12: start<T, abt::kIceLu12>(f, n, p, kw, s); break;
      case abt::kIceLg15: start<T, abt::kIceLg15>(f, n, p, kw, s); break;
      case abt::kIceLg15Io: start<T, abt::kIceLg15Io>(f, n, p, kw, s); break;
      case abt::kIceBest: start<T, abt::kIceBest>(f, n, p, kw, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: 13 device pointers in the order of IceFields (7 in, 6 out; frice may
// be null for the algorithms that do not take it); algo is the index of
// abt::IceAlgo (kernels/fused.py _ICE_ALGOS).
#define ABT_ENTRY(name, T)                                                           \
  extern "C" int name(void* const* ptrs, int64_t n, int algo, int niter, int humidity, \
                      double zt, double zu, double CdN, double ChN, double CeN,      \
                      double sqrt_CdN, double log_ztzu, double log_zu10,            \
                      void* stream) {                                               \
    return launch<T>(ptrs, n, algo, niter, humidity, zt, zu, CdN, ChN, CeN,         \
                     sqrt_CdN, log_ztzu, log_zu10, stream);                         \
  }

ABT_ENTRY(abt_ice_step_f32, float)
ABT_ENTRY(abt_ice_step_f64, double)
