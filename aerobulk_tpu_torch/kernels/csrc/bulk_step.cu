// The stateless flux step (api.flux_step with use_skin=False) of the five
// ocean algorithms, one grid point per thread, as one CUDA kernel for Hopper
// (sm_90a).
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_bulk_kernel (its
// body is api.flux_step on one VMEM tile; launched by _fused_bulk and
// fused_bulk_step).  The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_bulk_step_plain, the eager
// api.flux_step of the port.
//
// What bounds it on this card: per point it reads 6 fields and writes 6, 48 B
// at fp32, against 1151 (NCAR) to 2809 (Andreas) floating-point operations per
// point with niter = 5 (the census of docs/ROOFLINE.json: 2050 for COARE 3.0),
// a tenth of them transcendental.  At the card's 67 TFLOP/s fp32 and 3.35 TB/s
// that is 17-42 us of arithmetic per million points against 14 us of memory:
// bound by operations (and the SFU's transcendentals), like fused_step.cu.  So
// the design is fused_step.cu's: one thread owns one point, reads its 6 inputs
// once, runs the whole solve in registers and writes its 6 outputs once; no
// shared memory, no inter-thread traffic.  The inputs are flattened to one
// axis of n points (any shape, broadcast by the wrapper) with a bounds mask;
// the TPU wrapper's edge padding to (32, 256) tiles is not needed.
//
// The algorithm is a template parameter, so each instantiation holds one
// algorithm's registers and no point branches on it; the host switch picks
// one of 5 x 2 (float, double) instantiations.  niter, zt, zu, the humidity
// kind and the COARE version constants are kernel arguments (Params), uniform
// over the grid.  COARE runs flux_point.cuh's turb_coare with the skin
// compiled out, the one COARE source of all three kernels; ECMWF, NCAR and
// Andreas are in algos_point.cuh.
//
// Numerics: the rules of fused_step.cu hold (no --use_fast_math, T(...) of a
// double on every constant, constant sub-expressions that Python folds in
// double folded in double, Python's association order, NaN-propagating
// maxp/minp, FMA contraction as the expected ulp-level source of
// kernel/plain differences).  Andreas' LKB table is in __constant__ memory,
// selected by an unrolled compare on its edges.
//
// Plain C interface (abt_bulk_step_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "algos_point.cuh"

namespace {

using abt::Params;

template <typename T> struct BulkFields {
  const T* in[6];      // sst t_zt hum_zt U_zu V_zu slp
  T* out[6];           // QL QH Tau_x Tau_y Evap T_s
};

template <typename T, int kAlgo>
__global__ void __launch_bounds__(256)
bulk_step_kernel(BulkFields<T> f, int64_t n, Params p) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  T in[6], out[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) in[k] = f.in[k][i];
  abt::bulk_point<T, kAlgo>(in, out, p);
#pragma unroll
  for (int k = 0; k < 6; ++k) f.out[k][i] = out[k];
}

template <typename T, int kAlgo>
void start(const BulkFields<T>& f, int64_t n, const Params& p, cudaStream_t stream) {
  constexpr int kBlock = 256;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  bulk_step_kernel<T, kAlgo><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(f, n, p);
}

template <typename T>
int launch(void* const* ptrs, int64_t n, int algo, int niter, int charn_law,
           int visc_at_tzu, int humidity, double z0t_max, double z0t_coef,
           double z0t_pow, double beta0, double zt, double zu, void* stream) {
  BulkFields<T> f;
  for (int k = 0; k < 6; ++k) f.in[k] = static_cast<const T*>(ptrs[k]);
  for (int k = 0; k < 6; ++k) f.out[k] = static_cast<T*>(ptrs[6 + k]);
  const Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                 z0t_pow, beta0, zt, zu, 0.0, 0.0, 0.0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    switch (algo) {
      case abt::kCoare3p0: start<T, abt::kCoare3p0>(f, n, p, s); break;
      case abt::kCoare3p6: start<T, abt::kCoare3p6>(f, n, p, s); break;
      case abt::kEcmwf: start<T, abt::kEcmwf>(f, n, p, s); break;
      case abt::kNcar: start<T, abt::kNcar>(f, n, p, s); break;
      case abt::kAndreas: start<T, abt::kAndreas>(f, n, p, s); break;
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: 12 device pointers in the order of BulkFields (6 in, 6 out); algo is
// the index of abt::BulkAlgo (kernels/fused.py _BULK_ALGOS).
#define ABT_ENTRY(name, T)                                                         \
  extern "C" int name(void* const* ptrs, int64_t n, int algo, int niter,          \
                      int charn_law, int visc_at_tzu, int humidity,               \
                      double z0t_max, double z0t_coef, double z0t_pow,            \
                      double beta0, double zt, double zu, void* stream) {         \
    return launch<T>(ptrs, n, algo, niter, charn_law, visc_at_tzu, humidity,      \
                     z0t_max, z0t_coef, z0t_pow, beta0, zt, zu, stream);          \
  }

ABT_ENTRY(abt_bulk_step_f32, float)
ABT_ENTRY(abt_bulk_step_f64, double)
