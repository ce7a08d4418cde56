// Kernel 6's chain (primitive_chain.cuh) for the forms kernels 1-5 run,
// built as they are built: with kernels/_build.py's FORWARD_FLAGS
// (-prec-div=false -prec-sqrt=false -ftz=false), which apply to this whole
// file.  Their census prices its pow, div and sqrt at these rates; the
// IEEE forms of primitive_chain.cu price every fp64 build.
//
// Replaces, with primitive_chain.cu, the TPU kernel `kernel` of
// aerobulk_tpu/roofline.py::measure_primitive_throughput; the plain version
// it is held to is aerobulk_tpu_torch/kernels/roofline.py::
// primitive_chain_plain.
//
// The forms:
//  * pow_pos: (|x| + 1.1)^0.72 as exp2(0.72 log2(.)), common.cuh's pow_pos,
//    float and double: every power of the flux step;
//  * div_approx: 1.7 / (|x| + 1.2), float only: div.full.f32 (within 2 ulp
//    over the full range) under -prec-div=false;
//  * sqrt_approx: sqrt(|x| + 1.1), float only: sqrt.approx.f32 under
//    -prec-sqrt=false.
// fp64 division and square root are exact under any flag, so their double
// forms are primitive_chain.cu's.
//
// Instantiated for P in {1, 2, 4, 8} at K = 64.  Plain C interface
// (abt_primitive_chain_forward_f32 / _f64, the op index of primitive_chain.
// cuh's Op), loaded with ctypes: the launch goes on the caller's stream,
// allocates nothing and returns cudaGetLastError(), or
// cudaErrorInvalidValue for a form, P, K or type that is not instantiated.

#include "primitive_chain.cuh"

namespace {

using namespace abt_chain;

template <typename T>
int by_op(int op, int P, int K, const void* x, void* out, int64_t n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (op == kPowPos) return by_p<T, kPowPos>(P, K, x, out, n, s);
  if constexpr (sizeof(T) == 4) {
    if (op == kDivApprox) return by_p<T, kDivApprox>(P, K, x, out, n, s);
    if (op == kSqrtApprox) return by_p<T, kSqrtApprox>(P, K, x, out, n, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: n device values; op: the form's index in Op; P, K as above.
extern "C" int abt_primitive_chain_forward_f32(const void* x, void* out, int64_t n, int op,
                                               int P, int K, void* stream) {
  return by_op<float>(op, P, K, x, out, n, stream);
}

extern "C" int abt_primitive_chain_forward_f64(const void* x, void* out, int64_t n, int op,
                                               int P, int K, void* stream) {
  return by_op<double>(op, P, K, x, out, n, stream);
}
