// The primitive-throughput microbenchmark (kernel 6): K chained applications
// of one op class along P independent chains per element, summed, as one
// CUDA kernel for Hopper (sm_90a).  The chain itself, what bounds it and its
// design are in primitive_chain.cuh.
//
// Replaces the TPU kernel `kernel` of aerobulk_tpu/roofline.py::
// measure_primitive_throughput (a Pallas body over (256, 256) tiles).  The
// plain version it is held to is aerobulk_tpu_torch/kernels/roofline.py::
// primitive_chain_plain.
//
// This source builds the seven classes of roofline._OPS: exp(-|x| 0.5) +
// 0.1, log(|x| + 1.1), (|x| + 1.1)^0.72, sqrt(|x| + 1.1), 1.7 / (|x| +
// 1.2), atan(0.9 x + 0.05) and the "cheap" x 1.000001 + 1e-6 (one FMA: nvcc
// contracts it).  Each is libdevice's IEEE form (powf, div.rn, sqrt.rn):
// built with NVCC_FLAGS alone, not --use_fast_math.  The forms kernels 1-5
// run instead (pow_pos, div.full.f32, sqrt.approx.f32) are built by
// primitive_chain_forward.cu.  |x| and the sums around each op are free
// modifiers or FMA partners on this card's ALUs.
//
// Instantiated for P in {1, 2, 4, 8} and float/double: K = 64 for the seven
// classes, K in {64, 128, 256} for the cheap class.  Plain C interface
// (abt_primitive_chain_f32 / _f64), loaded with ctypes: the launch goes on
// the caller's stream, allocates nothing and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a class, P or K that is not instantiated.

#include "primitive_chain.cuh"

namespace {

using namespace abt_chain;

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
