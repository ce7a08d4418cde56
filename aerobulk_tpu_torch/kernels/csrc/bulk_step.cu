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
// bound by operations, and in practice by the issue of its op mix (PERF.md
// §5: 1.2-2x its serial-issue bound).  So the design is fused_step.cu's: one
// thread owns one point, reads its 6 inputs once, runs the whole solve in
// registers and writes its 6 outputs once; no shared memory, no inter-thread
// traffic.  Tensor cores, TMA, shared memory and clusters have nothing to do
// here: the work is a pointwise scalar solve with no matrix product.  The
// inputs are flattened to one axis of n points (any shape, broadcast by the
// wrapper) with a bounds mask; the TPU wrapper's edge padding to (32, 256)
// tiles is not needed.
//
// The algorithm is a template parameter, so each instantiation holds one
// algorithm's registers and no point branches on it; the host switch picks
// one of 5 x 2 (float, double) instantiations.  niter, zt, zu, the humidity
// kind and the COARE version constants are kernel arguments (Params), uniform
// over the grid.  COARE runs flux_point.cuh's turb_coare with the skin
// compiled out, the one COARE source of all three kernels; ECMWF, NCAR and
// Andreas are in algos_point.cuh.  Each instantiation has its own launch
// shape (BulkShape: blocks of 256 threads, a minimum of resident blocks per
// SM and so a register cap, points per thread), the fastest of the sweep of
// aerobulk_tpu_torch/launch_sweep.py.
//
// Numerics: the rules of fused_step.cu hold, its approximations included
// (fp32 division and square root approximate, every power through pow_pos;
// the build flags of kernels/_build.py FORWARD_FLAGS).  Andreas' LKB table
// is in __constant__ memory, selected by an unrolled compare on its edges.
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

constexpr int kBlock = 256;

// The launch shape of one instantiation: at least kMinBlocks blocks of kBlock
// threads resident per SM (so at most 65536 / (kBlock kMinBlocks) registers a
// thread) and kPoints points per thread.  A sweep's build sets one shape for
// every instantiation with -DABT_SWEEP_MIN_BLOCKS=B -DABT_SWEEP_POINTS=P.
#ifdef ABT_SWEEP_MIN_BLOCKS
template <typename T, int kAlgo> struct BulkShape {
  static constexpr int kMinBlocks = ABT_SWEEP_MIN_BLOCKS, kPoints = ABT_SWEEP_POINTS;
};
#else
// {kMinBlocks, kPoints} by abt::BulkAlgo, the fastest shape of the sweep on
// an H100 (PERF.md §6).  fp32 COARE and ECMWF use 60-64 registers, so one to
// three blocks give the same code and the pick is within the sweep's 1%;
// NCAR gains ~2% from two points a thread, Andreas ~1% from four blocks
// (63 registers, 72 uncapped).  fp64 COARE and ECMWF (98
// registers uncapped) run three blocks at 80 with 32 B of spills, NCAR and
// Andreas four at 64 with 8 and 56 B.
constexpr int kBulkShape[2][5][2] = {
    {{3, 1}, {1, 1}, {3, 1}, {4, 2}, {4, 1}},   // float
    {{3, 1}, {3, 1}, {3, 1}, {4, 1}, {4, 1}}};  // double
template <typename T, int kAlgo> struct BulkShape {
  static constexpr int kMinBlocks = kBulkShape[sizeof(T) == 8][kAlgo][0];
  static constexpr int kPoints = kBulkShape[sizeof(T) == 8][kAlgo][1];
};
#endif

// A block covers kBlock * kPoints consecutive points; thread t takes points
// t, t + kBlock, ..., so every load and store of a warp is coalesced.
template <typename T, int kAlgo, typename Shape = BulkShape<T, kAlgo>>
__global__ void __launch_bounds__(kBlock, Shape::kMinBlocks)
bulk_step_kernel(BulkFields<T> f, int64_t n, Params p) {
  constexpr int kPoints = Shape::kPoints;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kBlock * kPoints) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const int64_t i = first + j * kBlock;
    if (i >= n) return;
    T in[6], out[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) in[k] = f.in[k][i];
    abt::bulk_point<T, kAlgo>(in, out, p);
#pragma unroll
    for (int k = 0; k < 6; ++k) f.out[k][i] = out[k];
  }
}

template <typename T, int kAlgo>
void start(const BulkFields<T>& f, int64_t n, const Params& p, cudaStream_t stream) {
  constexpr int64_t kSpan = kBlock * BulkShape<T, kAlgo>::kPoints;
  const int64_t blocks = (n + kSpan - 1) / kSpan;
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
