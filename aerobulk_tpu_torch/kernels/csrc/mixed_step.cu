// The mixed ocean+ice cell (api.flux_step_mixed), one grid point per thread,
// as one CUDA kernel for Hopper (sm_90a): the ice algorithm over the ice
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
// ECMWF leads with niter = 5 (2502 for LG15_IO; chip_smoke.py
// ICE_OPS_PER_POINT): 61 us of arithmetic per million points at 67 TFLOP/s
// against 16 us of memory at 3.35 TB/s, so bound by operations.  The design
// is bulk_step.cu's: one thread per point, everything in registers, a
// bounds mask over the flattened field.
//
// The ocean algorithm is a template parameter; the ice algorithm is a
// runtime switch that is uniform over the grid (every thread takes the same
// case, so no warp diverges on it).  That keeps the library at 5 x 2
// instantiations, plus 2 of LG15_IO, instead of 7 x 5 x 2: each would inline
// an ocean solve as large as a whole bulk_step.cu instantiation.  The ice
// solves are ice_point.cuh's, the ocean solves algos_point.cuh's ocean_turb
// (kernel 3's per-point solve), so all three kernels share one source of
// each algorithm.  The shared inputs (humidity, wind, theta at zt) are
// computed once: api.flux_step_ice and api.flux_step compute them by the
// same expressions.
//
// Numerics: the rules of fused_step.cu hold, except that fp32 division is
// exact (kernels/_build.py's NVCC_FLAGS alone).  The blend is frice * ice +
// (1 - frice) * ocean in that order (api.py's blend); Tau is the stress
// magnitude.
//
// Plain C interface (abt_mixed_step_f32 / _f64), loaded with ctypes.  The
// launch goes on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <cstdint>

#include "algos_point.cuh"
#include "ice_point.cuh"

namespace {

using abt::Bulk;
using abt::IceKw;
using abt::Params;
using abt::Turb;

template <typename T> struct MixedFields {
  const T* in[8];      // Ts_i sst t_zt hum_zt U_zu V_zu slp frice
  T* out[5];           // QL QH Tau Evap T_s
};

template <typename T>
__device__ __forceinline__ Turb<T> ice_side(int ice_algo, const Params& p, const IceKw& kw,
                                            T Ts_i, T theta_zt, T qs_i, T q_zt, T wnd,
                                            T frice) {
  switch (ice_algo) {
    case abt::kIceNemo:
      return abt::turb_ice<T, abt::kIceNemo>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
    case abt::kIceEasy:
      return abt::turb_ice<T, abt::kIceEasy>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
    case abt::kIceAn05:
      return abt::turb_ice<T, abt::kIceAn05>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
    case abt::kIceLu12:
      return abt::turb_ice<T, abt::kIceLu12>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
    case abt::kIceBest:
      return abt::turb_ice<T, abt::kIceBest>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
    default:   // kIceLg15, kIceLg15Io: the same ice-side solve
      return abt::turb_ice<T, abt::kIceLg15>(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
  }
}

template <typename T> __device__ __forceinline__ T blend(T frice, T i, T w) {
  return frice * i + (T(1) - frice) * w;
}

// kOcean: an abt::BulkAlgo, or -1 for the simultaneous LG15_IO solve
template <typename T, int kOcean>
__global__ void __launch_bounds__(256)
mixed_step_kernel(MixedFields<T> f, int64_t n, int ice_algo, Params p, IceKw kw) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const T Ts_i = f.in[0][i], sst = f.in[1][i], t_zt = f.in[2][i], hum = f.in[3][i];
  const T U = f.in[4][i], V = f.in[5][i], slp = f.in[6][i], frice = f.in[7][i];

  const abt::IceAir<T> a = abt::ice_air(p, Ts_i, t_zt, hum, U, V, slp);
  const T ssq = T(abt::rdct_qsat_salt) * abt::q_sat(sst, slp);
  Turb<T> ri, rw;
  if constexpr (kOcean < 0) {
    ri = abt::turb_ice_lg15(p, Ts_i, a.theta_zt, a.qs_i, a.q_zt, a.wnd, frice);
    rw = abt::turb_water_lg15_io(p, sst, a.theta_zt, ssq, a.q_zt, a.wnd);
  } else {
    ri = ice_side(ice_algo, p, kw, Ts_i, a.theta_zt, a.qs_i, a.q_zt, a.wnd, frice);
    rw = abt::ocean_turb<T, kOcean>(p, sst, ssq, a.theta_zt, a.q_zt, a.wnd, slp);
  }
  const Bulk<T> bi = abt::bulk_of<T, true>(p.zu, ri, a.wnd, slp);
  const Bulk<T> bw = abt::bulk_of<T, false>(p.zu, rw, a.wnd, slp);

  f.out[0][i] = blend(frice, bi.Qlat, bw.Qlat);
  f.out[1][i] = blend(frice, bi.Qsen, bw.Qsen);
  f.out[2][i] = blend(frice, bi.Tau, bw.Tau);
  f.out[3][i] = blend(frice, bi.Evap, bw.Evap);
  f.out[4][i] = blend(frice, ri.T_s, rw.T_s);
}

template <typename T, int kOcean>
void start(const MixedFields<T>& f, int64_t n, int ice_algo, const Params& p,
           const IceKw& kw, cudaStream_t stream) {
  constexpr int kBlock = 256;
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  mixed_step_kernel<T, kOcean><<<static_cast<unsigned>(blocks), kBlock, 0, stream>>>(
      f, n, ice_algo, p, kw);
}

template <typename T>
int launch(void* const* ptrs, int64_t n, int ice_algo, int ocean_algo, int simultaneous,
           int niter, int charn_law, int visc_at_tzu, int humidity, double z0t_max,
           double z0t_coef, double z0t_pow, double beta0, double zt, double zu,
           double CdN, double ChN, double CeN, double sqrt_CdN, double log_ztzu,
           double log_zu10, void* stream) {
  MixedFields<T> f;
  for (int k = 0; k < 8; ++k) f.in[k] = static_cast<const T*>(ptrs[k]);
  for (int k = 0; k < 5; ++k) f.out[k] = static_cast<T*>(ptrs[8 + k]);
  const Params p{niter, charn_law, visc_at_tzu, humidity, z0t_max, z0t_coef,
                 z0t_pow, beta0, zt, zu, 0.0, 0.0, 0.0};
  const IceKw kw{CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ice_algo < abt::kIceNemo || ice_algo > abt::kIceBest)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    if (simultaneous) {
      start<T, -1>(f, n, ice_algo, p, kw, s);
    } else {
      switch (ocean_algo) {
        case abt::kCoare3p0: start<T, abt::kCoare3p0>(f, n, ice_algo, p, kw, s); break;
        case abt::kCoare3p6: start<T, abt::kCoare3p6>(f, n, ice_algo, p, kw, s); break;
        case abt::kEcmwf: start<T, abt::kEcmwf>(f, n, ice_algo, p, kw, s); break;
        case abt::kNcar: start<T, abt::kNcar>(f, n, ice_algo, p, kw, s); break;
        case abt::kAndreas: start<T, abt::kAndreas>(f, n, ice_algo, p, kw, s); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
      }
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ptrs: 13 device pointers in the order of MixedFields (8 in, 5 out);
// ice_algo is the index of abt::IceAlgo and ocean_algo of abt::BulkAlgo
// (kernels/fused.py _ICE_ALGOS, _BULK_ALGOS); both are ignored when
// simultaneous is set.
#define ABT_ENTRY(name, T)                                                          \
  extern "C" int name(void* const* ptrs, int64_t n, int ice_algo, int ocean_algo,   \
                      int simultaneous, int niter, int charn_law, int visc_at_tzu, \
                      int humidity, double z0t_max, double z0t_coef, double z0t_pow, \
                      double beta0, double zt, double zu, double CdN, double ChN,  \
                      double CeN, double sqrt_CdN, double log_ztzu,                \
                      double log_zu10, void* stream) {                             \
    return launch<T>(ptrs, n, ice_algo, ocean_algo, simultaneous, niter, charn_law, \
                     visc_at_tzu, humidity, z0t_max, z0t_coef, z0t_pow, beta0, zt, \
                     zu, CdN, ChN, CeN, sqrt_CdN, log_ztzu, log_zu10, stream);     \
  }

ABT_ENTRY(abt_mixed_step_f32, float)
ABT_ENTRY(abt_mixed_step_f64, double)
