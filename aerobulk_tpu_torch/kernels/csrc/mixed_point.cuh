// The per-point body of the mixed ocean+ice cell (mixed_step.cu):
// api.flux_step_mixed reduced to the net.  The ice algorithm over the ice
// fraction, the ocean algorithm (no skin) over the leads and the area-weighted
// net; or the LG15_IO solve of both surfaces in one pass.  Templates on the
// scalar type T under the rules of common.cuh; the ice solves are
// ice_point.cuh's, the ocean solves algos_point.cuh's ocean_turb (kernel 3's
// per-point solve), so all three kernels share one source of each algorithm.

#pragma once

#include "algos_point.cuh"
#include "ice_point.cuh"

namespace abt {

// the kOcean of the simultaneous LG15_IO solve
constexpr int kSimultaneous = -1;

// api.py's blend, in its order
template <typename T> ABT_DI T blend(T frice, T i, T w) {
  return frice * i + (T(1) - frice) * w;
}

// One point: in = (Ts_i sst t_zt hum_zt U_zu V_zu slp frice), out = the net
// (QL QH Tau Evap T_s), Tau the stress magnitude.  kOcean: an abt::BulkAlgo,
// or kSimultaneous (kIce is then not read); kIce: an abt::IceAlgo
// (kIceLg15Io runs LG15's ice side, as api.flux_step_mixed does).  The shared
// inputs (humidity, wind, theta at zt) are computed once: api.flux_step_ice
// and api.flux_step compute them by the same expressions.
template <typename T, int kOcean, int kIce>
ABT_DI void mixed_point(const T (&in)[8], T (&out)[5], const Params& p, const IceKw& kw) {
  const T Ts_i = in[0], sst = in[1], t_zt = in[2], hum = in[3];
  const T U = in[4], V = in[5], slp = in[6], frice = in[7];

  const IceAir<T> a = ice_air(p, Ts_i, t_zt, hum, U, V, slp);
  const T ssq = T(rdct_qsat_salt) * q_sat(sst, slp);
  Turb<T> ri, rw;
  if constexpr (kOcean == kSimultaneous) {
    ri = turb_ice_lg15(p, Ts_i, a.theta_zt, a.qs_i, a.q_zt, a.wnd, frice);
    rw = turb_water_lg15_io(p, sst, a.theta_zt, ssq, a.q_zt, a.wnd);
  } else {
    ri = turb_ice<T, kIce>(p, kw, Ts_i, a.theta_zt, a.qs_i, a.q_zt, a.wnd, frice);
    rw = ocean_turb<T, kOcean>(p, sst, ssq, a.theta_zt, a.q_zt, a.wnd, slp);
  }
  const Bulk<T> bi = bulk_of<T, true>(p.zu, ri, a.wnd, slp);
  const Bulk<T> bw = bulk_of<T, false>(p.zu, rw, a.wnd, slp);

  out[0] = blend(frice, bi.Qlat, bw.Qlat);
  out[1] = blend(frice, bi.Qsen, bw.Qsen);
  out[2] = blend(frice, bi.Tau, bw.Tau);
  out[3] = blend(frice, bi.Evap, bw.Evap);
  out[4] = blend(frice, ri.T_s, rw.T_s);
}

}  // namespace abt
