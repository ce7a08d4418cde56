// The primitive-throughput microbenchmark: K chained applications of one op
// class along P independent chains per element, summed, as one CUDA kernel
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `kernel` of aerobulk_tpu/roofline.py::
// measure_primitive_throughput (a Pallas body over (256, 256) tiles).  The
// plain version it is held to is aerobulk_tpu_torch/kernels/roofline.py::
// primitive_chain_plain.
//
// What it computes, per element x: lanes p = 0..P-1 start at x + 0.01 p,
// each lane takes K applications of the op, and the lanes are summed.  The
// ops are those of roofline._OPS: exp(-|x| 0.5) + 0.1, log(|x| + 1.1),
// (|x| + 1.1)^0.72, sqrt(|x| + 1.1), 1.7 / (|x| + 1.2), atan(0.9 x + 0.05)
// and the "cheap" x 1.000001 + 1e-6 (one FMA: nvcc contracts it).  Each is
// libdevice's IEEE form: the kernel is built without --use_fast_math, as
// kernels 1-5 are, so it measures what they pay.  |x| and the sums around
// each op are free modifiers or FMA partners on this card's ALUs.
//
// What bounds it: per element one read and one write (8 or 16 bytes)
// against K * P applications, so with K = 64 it is bound by operations by
// far.  The design exposes exactly that: one thread per element (a bounds
// mask, any n), no shared memory, the K loop fully unrolled (kOp, P and K
// are template parameters, as the Pallas body is a Python loop), and P
// independent chains to give each warp instruction-level parallelism.  The
// chains are serially dependent along K, so nothing can be hoisted.
//
// Instantiated for P in {1, 2, 4, 8} and float/double: K = 64 for the seven
// classes, K in {64, 128, 256} for the cheap class.  Plain C interface (abt_primitive_chain_f32 / _f64),
// loaded with ctypes: the launch goes on the caller's stream, allocates
// nothing and returns cudaGetLastError(), or cudaErrorInvalidValue for a
// class, P or K that is not instantiated.

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace {

using abt::m_abs;

// the classes in the order of roofline._OPS
enum Op { kExp = 0, kLog, kPow, kSqrt, kDiv, kAtan, kCheap };

template <int kOp, typename T> __device__ __forceinline__ T apply(T x) {
  if constexpr (kOp == kExp) return abt::m_exp(-m_abs(x) * T(0.5)) + T(0.1);
  else if constexpr (kOp == kLog) return abt::m_log(m_abs(x) + T(1.1));
  else if constexpr (kOp == kPow) return abt::m_pow(m_abs(x) + T(1.1), T(0.72));
  else if constexpr (kOp == kSqrt) return abt::m_sqrt(m_abs(x) + T(1.1));
  else if constexpr (kOp == kDiv) return T(1.7) / (m_abs(x) + T(1.2));
  else if constexpr (kOp == kAtan) return abt::m_atan(x * T(0.9) + T(0.05));
  else return x * T(1.000001) + T(1e-6);
}

template <int kOp, int P, int K, typename T>
__global__ void __launch_bounds__(256)
chain_kernel(const T* __restrict__ x, T* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T x0 = x[i];
  T lanes[P];
#pragma unroll
  for (int p = 0; p < P; ++p) lanes[p] = x0 + T(0.01 * p);
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int p = 0; p < P; ++p) lanes[p] = apply<kOp>(lanes[p]);
  }
  T acc = lanes[0];
#pragma unroll
  for (int p = 1; p < P; ++p) acc = acc + lanes[p];
  out[i] = acc;
}

template <typename T, int kOp, int P, int K>
int launch(const void* x, void* out, int64_t n, cudaStream_t stream) {
  constexpr int kBlock = 256;
  if (n > 0) {
    const int64_t blocks = (n + kBlock - 1) / kBlock;
    chain_kernel<kOp, P, K, T><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(out), n);
  }
  return static_cast<int>(cudaGetLastError());
}

// K = 64 for every class; the deeper chains only for the cheap class, which
// alone uses them (the FMA ceiling).  A fully unrolled chain of 256 x 8
// inlined pow or atan costs minutes of ptxas and measures nothing new.
template <typename T, int kOp, int P>
int by_k(int K, const void* x, void* out, int64_t n, cudaStream_t s) {
  if (K == 64) return launch<T, kOp, P, 64>(x, out, n, s);
  if constexpr (kOp == kCheap) {
    if (K == 128) return launch<T, kOp, P, 128>(x, out, n, s);
    if (K == 256) return launch<T, kOp, P, 256>(x, out, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int kOp>
int by_p(int P, int K, const void* x, void* out, int64_t n, cudaStream_t s) {
  switch (P) {
    case 1: return by_k<T, kOp, 1>(K, x, out, n, s);
    case 2: return by_k<T, kOp, 2>(K, x, out, n, s);
    case 4: return by_k<T, kOp, 4>(K, x, out, n, s);
    case 8: return by_k<T, kOp, 8>(K, x, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int by_op(int op, int P, int K, const void* x, void* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kExp: return by_p<T, kExp>(P, K, x, out, n, s);
    case kLog: return by_p<T, kLog>(P, K, x, out, n, s);
    case kPow: return by_p<T, kPow>(P, K, x, out, n, s);
    case kSqrt: return by_p<T, kSqrt>(P, K, x, out, n, s);
    case kDiv: return by_p<T, kDiv>(P, K, x, out, n, s);
    case kAtan: return by_p<T, kAtan>(P, K, x, out, n, s);
    case kCheap: return by_p<T, kCheap>(P, K, x, out, n, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: n device values; op: the class index of Op; P, K as above.
extern "C" int abt_primitive_chain_f32(const void* x, void* out, int64_t n, int op, int P,
                                       int K, void* stream) {
  return by_op<float>(op, P, K, x, out, n, stream);
}

extern "C" int abt_primitive_chain_f64(const void* x, void* out, int64_t n, int op, int P,
                                       int K, void* stream) {
  return by_op<double>(op, P, K, x, out, n, stream);
}
