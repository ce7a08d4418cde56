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
// arguments, uniform over the grid.  Each instantiation has its own launch
// shape (IceShape: blocks of 256 threads, a minimum of resident blocks per SM
// and so a register cap, points per thread), the fastest of the sweep of
// aerobulk_tpu_torch/launch_sweep.py, as bulk_step.cu's.
//
// Numerics: the rules of fused_step.cu hold, its approximations included:
// fp32 division and square root approximate (kernels/_build.py
// FORWARD_FLAGS; fp64 stays exact), and every power, the ice algorithms' own
// included, through common.cuh's pow_pos (ice_point.cuh says why each base
// is positive or 0).
//
// Plain C interface (abt_ice_step_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().  abt_ice_step_shape reports an instantiation's shape.

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

constexpr int kBlock = 256;

// The launch shape of one instantiation: at least kMinBlocks blocks of kBlock
// threads resident per SM (so at most 65536 / (kBlock kMinBlocks) registers a
// thread) and kPoints points per thread.  A sweep's build sets one shape for
// every instantiation with -DABT_SWEEP_MIN_BLOCKS=B -DABT_SWEEP_POINTS=P.
#ifdef ABT_SWEEP_MIN_BLOCKS
template <typename T, int kIce> struct IceShape {
  static constexpr int kMinBlocks = ABT_SWEEP_MIN_BLOCKS, kPoints = ABT_SWEEP_POINTS;
};
#else
// {kMinBlocks, kPoints} by abt::IceAlgo, the fastest shape of the sweep on an
// H100 (PERF.md §6).  fp32 uses 24-62 registers, so no cap up to four blocks
// binds and the pick is within the sweep's 0.1%.  fp64 gains 10-20% from
// three or four blocks: LG15 at 64 registers with 144 B of spills, AN05 and
// BEST at 80 with 16 B.  Two points a thread were slower everywhere.
constexpr int kIceShape[2][7][2] = {
    {{1, 1}, {2, 1}, {3, 1}, {3, 1}, {3, 1}, {2, 1}, {2, 1}},   // float
    {{2, 1}, {4, 1}, {3, 1}, {2, 1}, {4, 1}, {4, 1}, {3, 1}}};  // double
template <typename T, int kIce> struct IceShape {
  static constexpr int kMinBlocks = kIceShape[sizeof(T) == 8][kIce][0];
  static constexpr int kPoints = kIceShape[sizeof(T) == 8][kIce][1];
};
#endif

// A block covers kBlock * kPoints consecutive points; thread t takes points
// t, t + kBlock, ..., so every load and store of a warp is coalesced.
template <typename T, int kIce, typename Shape = IceShape<T, kIce>>
__global__ void __launch_bounds__(kBlock, Shape::kMinBlocks)
ice_step_kernel(IceFields<T> f, int64_t n, Params p, IceKw kw) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kBlock * Shape::kPoints) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < Shape::kPoints; ++j) {
    const int64_t i = first + j * kBlock;
    if (i >= n) return;
    T in[7], out[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) in[k] = f.in[k][i];
    in[6] = abt::ice_needs_frice(kIce) ? f.in[6][i] : T(0);
    abt::ice_point<T, kIce>(in, out, p, kw);
#pragma unroll
    for (int k = 0; k < 6; ++k) f.out[k][i] = out[k];
  }
}

template <typename T, int kIce>
void start(const IceFields<T>& f, int64_t n, const Params& p, const IceKw& kw,
           cudaStream_t stream) {
  constexpr int64_t kSpan = kBlock * IceShape<T, kIce>::kPoints;
  const int64_t blocks = (n + kSpan - 1) / kSpan;
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
    if (!abt::with_ice_algo(algo, [&](auto k) { start<T, decltype(k)::value>(f, n, p, kw, s); }))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// shape = {kMinBlocks, kPoints} of the instantiation of algo
template <typename T> int shape_of(int algo, int* shape) {
  const bool known = abt::with_ice_algo(algo, [&](auto k) {
    shape[0] = IceShape<T, decltype(k)::value>::kMinBlocks;
    shape[1] = IceShape<T, decltype(k)::value>::kPoints;
  });
  return known ? 0 : static_cast<int>(cudaErrorInvalidValue);
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

// shape = {kMinBlocks, kPoints} of the instantiation of algo at fp64 (f64 != 0)
// or fp32; returns cudaErrorInvalidValue for an unknown algo
extern "C" int abt_ice_step_shape(int algo, int f64, int* shape) {
  return f64 ? shape_of<double>(algo, shape) : shape_of<float>(algo, shape);
}
