// The primitive-throughput microbenchmark's chain, shared by the two
// translation units that build it: primitive_chain.cu (the seven op classes
// of aerobulk_tpu.roofline, IEEE forms) and primitive_chain_forward.cu (the
// forms kernels 1, 3, 4 and 5 run, built with their flags).  Each source
// instantiates by_op for its own classes: nvcc's flags apply per file, so
// the same expression (1.7 / y, sqrt(y)) compiles to div.rn.f32 and
// sqrt.rn.f32 in one and div.full.f32 and sqrt.approx.f32 in the other.
//
// What it computes, per element x: lanes p = 0..P-1 start at x + 0.01 p,
// each lane takes K applications of the op, and the lanes are summed.
//
// What bounds it: per element one read and one write (8 or 16 bytes)
// against K * P applications, so with K = 64 it is bound by operations by
// far.  The design exposes exactly that: one thread per element (a bounds
// mask, any n), no shared memory, the K loop fully unrolled (kOp, P and K
// are template parameters, as the Pallas body is a Python loop), and P
// independent chains to give each warp instruction-level parallelism.  The
// chains are serially dependent along K, so nothing can be hoisted.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "common.cuh"

namespace abt_chain {

using abt::m_abs;

// the classes in the order of kernels/roofline.py's CLASSES + FORMS: the
// seven of roofline._OPS, then pow_pos (exp2(0.72 log2 y) through
// common.cuh's pow_pos), div_approx and sqrt_approx (the div and sqrt
// expressions, compiled with FORWARD_FLAGS)
enum Op { kExp = 0, kLog, kPow, kSqrt, kDiv, kAtan, kCheap,
          kPowPos, kDivApprox, kSqrtApprox };

template <int kOp, typename T> __device__ __forceinline__ T apply(T x) {
  if constexpr (kOp == kExp) return abt::m_exp(-m_abs(x) * T(0.5)) + T(0.1);
  else if constexpr (kOp == kLog) return abt::m_log(m_abs(x) + T(1.1));
  else if constexpr (kOp == kPow) return abt::m_pow(m_abs(x) + T(1.1), T(0.72));
  else if constexpr (kOp == kSqrt || kOp == kSqrtApprox)
    return abt::m_sqrt(m_abs(x) + T(1.1));
  else if constexpr (kOp == kDiv || kOp == kDivApprox)
    return T(1.7) / (m_abs(x) + T(1.2));
  else if constexpr (kOp == kAtan) return abt::m_atan(x * T(0.9) + T(0.05));
  else if constexpr (kOp == kPowPos) return abt::pow_pos(m_abs(x) + T(1.1), T(0.72));
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

}  // namespace abt_chain
