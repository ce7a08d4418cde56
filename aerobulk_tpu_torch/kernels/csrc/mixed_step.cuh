// The mixed ocean+ice cell (api.flux_step_mixed), one grid point per thread,
// as CUDA kernels for Hopper (sm_90a): the ice algorithm over the ice
// fraction, the ocean algorithm (no skin) over the leads, and the area-
// weighted net; or the LG15_IO solve of both surfaces in one pass
// (simultaneous=True).
//
// Replaces the TPU kernel aerobulk_tpu/kernels/fused.py::_mixed_kernel (its
// body is api.flux_step_mixed on one VMEM tile; launched by _fused_mixed and
// fused_mixed_step).  The plain version it is held to is
// aerobulk_tpu_torch/kernels/fused.py::fused_mixed_step_plain, the eager
// api.flux_step_mixed of the port reduced to the net (QL QH Tau Evap T_s).
//
// What bounds it on this card: per point it reads 8 fields and writes 5, 52
// B at fp32, against 4059 floating-point operations per point for LG15 ice +
// ECMWF leads with niter = 5 (2502 for LG15_IO; aerobulk_tpu_torch/
// roofline.py CENSUS): 61 us of arithmetic per million points at 67 TFLOP/s
// against 16 us of memory at 3.35 TB/s, so bound by operations, and in
// practice by the issue of its op mix.  The design is bulk_step.cu's: one
// thread per point, everything in registers, a bounds mask over the
// flattened field.  The per-point body is mixed_point.cuh's.
//
// Both algorithms are template parameters, so each instantiation holds the
// registers of one ice solve and one ocean solve: with the ice algorithm a
// runtime switch, every instantiation held the registers of the largest of
// six ice solves beside its ocean solve (fp32 LG15 + ECMWF 66 against 64,
// + Andreas 79 against 74) and ran 1-6% slower (PERF.md §6).  Each ocean
// algorithm's 6 ice sides x 2 dtypes build as one library from its own
// source, mixed_step_<ocean>.cu (mixed_step_lg15_io.cu: the simultaneous
// solve), so their nvcc runs go in parallel.  Each (ocean, dtype) has its
// own launch shape (MixedShape, as bulk_step.cu's BulkShape), the fastest of
// the sweep of aerobulk_tpu_torch/launch_sweep.py over LG15 ice; the other
// ice sides take their ocean's.
//
// Numerics: the rules of fused_step.cu hold, its approximations included:
// fp32 division and square root approximate (kernels/_build.py
// FORWARD_FLAGS; fp64 stays exact), every power through common.cuh's
// pow_pos.  The blend is frice * ice + (1 - frice) * ocean in that order
// (api.py's blend); Tau is the stress magnitude.
//
// Plain C interface, loaded with ctypes: ABT_MIXED_ENTRIES(name, kOcean)
// defines name_f32 / name_f64 (the launch, on the caller's stream; allocates
// nothing and returns cudaGetLastError()) and name_shape (an instantiation's
// launch shape).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "mixed_point.cuh"

namespace {

using abt::IceKw;
using abt::Params;

template <typename T> struct MixedFields {
  const T* in[8];      // Ts_i sst t_zt hum_zt U_zu V_zu slp frice
  T* out[5];           // QL QH Tau Evap T_s
};

constexpr int kBlock = 256;

// The launch shape of one instantiation: at least kMinBlocks blocks of kBlock
// threads resident per SM and kPoints points per thread, as bulk_step.cu's
// BulkShape; -DABT_SWEEP_MIN_BLOCKS=B -DABT_SWEEP_POINTS=P set one for all.
#ifdef ABT_SWEEP_MIN_BLOCKS
template <typename T, int kOcean> struct MixedShape {
  static constexpr int kMinBlocks = ABT_SWEEP_MIN_BLOCKS, kPoints = ABT_SWEEP_POINTS;
};
#else
// {kMinBlocks, kPoints} by kOcean + 1 (LG15_IO, then abt::BulkAlgo), the
// fastest shape of the sweep on an H100 with LG15 ice (PERF.md §6).  fp32
// LG15 cells use 54-74 registers: up to three blocks give the same code and
// the pick is within 0.3%, Andreas gains 0.5% at four (63).  fp64 (102-108
// registers uncapped) gains 3-10% from three blocks at 80 with about 100 B of
// spills, LG15_IO 13% from four at 64 with 176 B.  Two points a thread were
// slower everywhere.
constexpr int kMixedShape[2][6][2] = {
    {{2, 1}, {2, 1}, {2, 1}, {1, 1}, {1, 1}, {4, 1}},   // float
    {{4, 1}, {3, 1}, {3, 1}, {3, 1}, {3, 1}, {3, 1}}};  // double
template <typename T, int kOcean> struct MixedShape {
  static constexpr int kMinBlocks = kMixedShape[sizeof(T) == 8][kOcean + 1][0];
  static constexpr int kPoints = kMixedShape[sizeof(T) == 8][kOcean + 1][1];
};
#endif

// kOcean: an abt::BulkAlgo, or abt::kSimultaneous; kIce: an abt::IceAlgo.  A
// block covers kBlock * kPoints consecutive points; thread t takes points t,
// t + kBlock, ..., so every load and store of a warp is coalesced.
template <typename T, int kOcean, int kIce, typename Shape = MixedShape<T, kOcean>>
__global__ void __launch_bounds__(kBlock, Shape::kMinBlocks)
mixed_step_kernel(MixedFields<T> f, int64_t n, Params p, IceKw kw) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * (kBlock * Shape::kPoints) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < Shape::kPoints; ++j) {
    const int64_t i = first + j * kBlock;
    if (i >= n) return;
    T in[8], out[5];
#pragma unroll
    for (int k = 0; k < 8; ++k) in[k] = f.in[k][i];
    abt::mixed_point<T, kOcean, kIce>(in, out, p, kw);
#pragma unroll
    for (int k = 0; k < 5; ++k) f.out[k][i] = out[k];
  }
}

template <typename T, int kOcean, int kIce>
void start(const MixedFields<T>& f, int64_t n, const Params& p, const IceKw& kw,
           cudaStream_t stream) {
  constexpr int64_t kSpan = kBlock * MixedShape<T, kOcean>::kPoints;
  const int64_t blocks = (n + kSpan - 1) / kSpan;
  mixed_step_kernel<T, kOcean, kIce><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      f, n, p, kw);
}

// Calls fn(std::integral_constant<int, kIce>()) for the ice side of ice_algo
// in a cell with kOcean leads: LG15_IO's (instantiated once, as kIceLg15Io)
// for the simultaneous solve, else ice_algo's, with kIceLg15Io taken as
// kIceLg15 (the same ice side); false for an unknown ice_algo
template <int kOcean, typename Fn> bool with_ice_side(int ice_algo, Fn&& fn) {
  if (ice_algo < abt::kIceNemo || ice_algo > abt::kIceBest) return false;
  if constexpr (kOcean == abt::kSimultaneous) {
    fn(std::integral_constant<int, abt::kIceLg15Io>());
    return true;
  } else {
    return abt::with_ice_algo(ice_algo == abt::kIceLg15Io ? abt::kIceLg15 : ice_algo,
                              [&](auto k) {
                                if constexpr (decltype(k)::value != abt::kIceLg15Io) fn(k);
                              });
  }
}

// ocean_algo and simultaneous must name this library's kOcean
template <typename T, int kOcean>
int launch(void* const* ptrs, int64_t n, int ice_algo, int ocean_algo, int simultaneous,
           int niter, int charn_law, int visc_at_tzu, int humidity, double z0t_max,
           double z0t_coef, double z0t_pow, double beta0, double zt, double zu,
           double CdN, double ChN, double CeN, double sqrt_CdN, double log_ztzu,
           double log_zu10, void* stream) {
  if (simultaneous ? kOcean != abt::kSimultaneous : ocean_algo != kOcean)
    return static_cast<int>(cudaErrorInvalidValue);
  MixedFields<T> f;
  for (int k = 0; k < 8; ++k) f.in[k] = static_cast<const T*>(ptrs[k]);
  for (int k = 0; k < 5; ++k) f.out[k] = static_cast<T*>(ptrs[8 + k]);
  const Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                 z0t_pow, beta0, zt, zu, 0.0, 0.0, 0.0};
  const IceKw kw{CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool known = with_ice_side<kOcean>(ice_algo, [&](auto k) {
    if (n > 0) start<T, kOcean, decltype(k)::value>(f, n, p, kw, s);
  });
  if (!known) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// shape = {kMinBlocks, kPoints} of the instantiation of ice_algo
template <typename T, int kOcean> int shape_of(int ice_algo, int* shape) {
  const bool known = with_ice_side<kOcean>(ice_algo, [&](auto) {
    shape[0] = MixedShape<T, kOcean>::kMinBlocks;
    shape[1] = MixedShape<T, kOcean>::kPoints;
  });
  return known ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// name_f32 / name_f64: ptrs holds 13 device pointers in the order of
// MixedFields (8 in, 5 out); ice_algo is the index of abt::IceAlgo and
// ocean_algo of abt::BulkAlgo (kernels/fused.py _ICE_ALGOS, _BULK_ALGOS),
// ocean_algo ignored when simultaneous is set.  name_shape(ice_algo, f64,
// shape): shape = {kMinBlocks, kPoints} of the instantiation at fp64
// (f64 != 0) or fp32; cudaErrorInvalidValue for an unknown ice_algo.
#define ABT_MIXED_ENTRY(name, T, kOcean)                                           \
  extern "C" int name(void* const* ptrs, int64_t n, int ice_algo, int ocean_algo,   \
                      int simultaneous, int niter, int charn_law, int visc_at_tzu, \
                      int humidity, double z0t_max, double z0t_coef, double z0t_pow, \
                      double beta0, double zt, double zu, double CdN, double ChN,  \
                      double CeN, double sqrt_CdN, double log_ztzu,                \
                      double log_zu10, void* stream) {                             \
    return launch<T, kOcean>(ptrs, n, ice_algo, ocean_algo, simultaneous, niter,   \
                             charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,  \
                             z0t_pow, beta0, zt, zu, CdN, ChN, CeN, sqrt_CdN,      \
                             log_ztzu, log_zu10, stream);                          \
  }
#define ABT_MIXED_ENTRIES(name, kOcean)                                            \
  ABT_MIXED_ENTRY(name##_f32, float, kOcean)                                       \
  ABT_MIXED_ENTRY(name##_f64, double, kOcean)                                      \
  extern "C" int name##_shape(int ice_algo, int f64, int* shape) {                 \
    return f64 ? shape_of<double, kOcean>(ice_algo, shape)                         \
               : shape_of<float, kOcean>(ice_algo, shape);                         \
  }
