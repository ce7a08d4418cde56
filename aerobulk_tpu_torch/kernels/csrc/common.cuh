// Per-point helpers shared by every kernel of the package: the constants,
// float/double math overloads, the thermodynamics of the flux step (humidity,
// potential temperature, q_sat, ...), the bulk formula and the stress split,
// and the arguments every per-point body takes.  Everything is a template on
// the scalar type T: the only operations on T are + - * /, comparisons, ?:
// selects, the m_* math overloads, maxp/minp and T(double) for constants, so
// the dual numbers of dual.cuh run the same code.
//
// Included by flux_point.cuh (the COARE + skin step of fused_step.cu and
// fused_grad.cu), algos_point.cuh (the other algorithms, bulk_step.cu) and
// ice_point.cuh (the sea-ice algorithms, ice_step.cu and mixed_step.cu).
// Numerics rules are in fused_step.cu's header.
//
// Every power of the flux step raises a positive base to an exponent that is
// a constant or uniform over the grid: pow_pos computes it as exp2(c log2 x),
// the cost of two SFU-class calls, where libdevice's general powf/pow (any
// sign, any exponent, correctly rounded) costs about 55 FMAs in fp32.

#pragma once

#include <cmath>
#include <cstdint>

// A host compiler (the CPU tests of the per-point bodies) sees plain inline
// functions and host-side tables; ABT_HD marks what both the host side of a
// kernel's source and its device code call.
#ifdef __CUDACC__
#define ABT_DI __device__ __forceinline__
#define ABT_HD __host__ __device__
#else
#define ABT_DI inline
#define ABT_HD
#define __constant__
#endif

namespace abt {

// ---------------------------------------------------------------------------
// constants (aerobulk_tpu_torch/constants.py; the tests compare them)
// ---------------------------------------------------------------------------
constexpr double grav = 9.8;
constexpr double rpi = 3.141592653589793;
constexpr double rt0 = 273.15;
constexpr double rCp0_w = 4190.0;
constexpr double rho0_w = 1025.0;
constexpr double rnu0_w = 1e-06;
constexpr double rk0_w = 0.6;
constexpr double rCp_dry = 1005.0;
constexpr double rCp_vap = 1860.0;
constexpr double R_dry = 287.05;
constexpr double R_vap = 461.495;
constexpr double R_gas = 8.31451;
constexpr double rmm_dryair = 0.0289647;
constexpr double rmm_water = 0.0180153;
constexpr double rLevap = 2460000.0;
constexpr double rLsub = 2834000.0;
constexpr double vkarmn = 0.4;
constexpr double rdct_qsat_salt = 0.98;
constexpr double Cx_min = 0.0001;
constexpr double emiss_w = 0.98;
constexpr double stefan = 5.67e-08;
constexpr double roce_alb0 = 0.066;
constexpr double rcst_cs = -1.871871559444444e-09;
constexpr double sq_radrw = 0.034215956910732065;
constexpr double rCp0_w_pow15 = 271219.5770957547;   // rCp0_w ** 1.5
constexpr double LOG2_10 = 3.321928094887362;        // log2(10)
constexpr double c_b = 4.147199999999999;            // 0.004 * 600 * 1.2**3
constexpr double HWL_MAX = 20.0;
constexpr double RICH0 = 0.65;

constexpr double rpoiss_dry = R_dry / rCp_dry;
constexpr double rgamma_dry = grav / rCp_dry;
constexpr double reps0 = R_dry / R_vap;
constexpr double rctv0 = R_vap / R_dry - 1.0;
constexpr double vkarmn2 = vkarmn * vkarmn;
constexpr double M_ZI0_OV_K = -600.0 / vkarmn;
constexpr double INV_K = 1.0 / vkarmn;
constexpr double INV_G = 1.0 / grav;
constexpr double INV_3 = 1.0 / 3.0;
constexpr double INV_SQRT3 = 1.0 / 1.7320508;

// ---------------------------------------------------------------------------
// math on float or double
// ---------------------------------------------------------------------------
#define ABT_UNARY(name, f32, f64)                        \
  ABT_DI float name(float x) { return f32(x); }         \
  ABT_DI double name(double x) { return f64(x); }
#define ABT_BINARY(name, f32, f64)                                 \
  ABT_DI float name(float x, float y) { return f32(x, y); }        \
  ABT_DI double name(double x, double y) { return f64(x, y); }

ABT_UNARY(m_exp, expf, exp)
ABT_UNARY(m_exp2, exp2f, exp2)
ABT_UNARY(m_log, logf, log)
ABT_UNARY(m_log2, log2f, log2)
ABT_UNARY(m_log10, log10f, log10)
ABT_UNARY(m_sqrt, sqrtf, sqrt)
ABT_UNARY(m_cbrt, cbrtf, cbrt)
ABT_UNARY(m_atan, atanf, atan)
ABT_UNARY(m_abs, fabsf, fabs)
ABT_UNARY(m_trunc, truncf, trunc)
ABT_BINARY(m_pow, powf, pow)
ABT_BINARY(m_fmod, fmodf, fmod)
ABT_BINARY(m_copysign, copysignf, copysign)

#undef ABT_UNARY
#undef ABT_BINARY

// x ** c for x > 0 (NaN for x < 0, 0 at x = 0, as powf with c > 0).  Its
// relative error is about |c log2(x)| + 2 ulp, a few ulp over the sites'
// ranges; dual.cuh overloads it with the derivative c x**c / x.
ABT_DI float pow_pos(float x, float c) { return exp2f(c * log2f(x)); }
ABT_DI double pow_pos(double x, double c) { return exp2(c * log2(x)); }

// MAX/MIN that propagate NaN from either side, like torch.maximum
template <typename T> ABT_DI T maxp(T a, T b) { return (a != a || a > b) ? a : b; }
template <typename T> ABT_DI T minp(T a, T b) { return (a != a || a < b) ? a : b; }

template <typename T> ABT_DI T floor_mod(T a, T b) {
  T r = m_fmod(a, b);
  if (r != T(0) && ((r < T(0)) != (b < T(0)))) r += b;
  return r;
}

// ---------------------------------------------------------------------------
// thermo (aerobulk_tpu_torch/thermo.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T fsign(T a, T b) { return m_copysign(m_abs(a), b); }
template <typename T> ABT_DI T step(T x) { return x >= T(0) ? T(1) : T(0); }
template <typename T> ABT_DI T clip_mag(T x, T cap) { return fsign(minp(m_abs(x), cap), x); }
template <typename T> ABT_DI T nonzero_delta(T dx, T fl) { return fsign(maxp(m_abs(dx), fl), dx); }
template <typename T> ABT_DI T pow23_pos(T x) {
  return x > T(0) ? pow_pos(x, T(2.0 / 3.0)) : T(0);
}

template <typename T> ABT_DI T exp10_(T x) { return m_exp2(x * T(LOG2_10)); }

template <typename T> ABT_DI T e_sat(T Ta) {
  const T ta = maxp(Ta, T(180.0));
  const T ztmp = T(rt0) / ta;
  const T zr = ta / T(rt0);
  return T(100.0) * exp10_(T(10.79574) * (T(1) - ztmp)
                           - T(5.028) * m_log10(zr)
                           + T(1.50475e-4) * (T(1) - exp10_(T(-8.2969) * (zr - T(1))))
                           + T(0.42873e-3) * (exp10_(T(4.76955) * (T(1) - ztmp)) - T(1))
                           + T(0.78614));
}

// q_sat from the saturation vapour pressure es
template <typename T> ABT_DI T q_sat_es(T es, T slp) {
  return T(reps0) * es / (slp - T(1.0 - reps0) * es);
}

template <typename T> ABT_DI T q_sat(T Ta, T slp) { return q_sat_es(e_sat(Ta), slp); }

template <typename T> ABT_DI T q_air_rh(T rha, T Ta, T slp) {
  const T ze = T(0.01) * rha * e_sat(Ta);
  return ze * T(reps0) / maxp(slp - T(1.0 - reps0) * ze, T(1));
}

template <typename T> ABT_DI T q_air_dp(T da, T slp) {
  const T e = maxp(e_sat(da), T(0));
  return e * T(reps0) / maxp(slp - T(1.0 - reps0) * e, T(1));
}

template <typename T> ABT_DI T virt_temp(T Ta, T qa) { return Ta * (T(1) + T(rctv0) * qa); }

// theta at height z from absolute temperature (pz_from_p0_tz_qz + pot_temp).
// The last pass gives pa = slp exp(-e), so (slp / pa) ** (R/Cp) is
// exp(R/Cp e): the same function to rounding, without a pow and a division.
template <typename T> ABT_DI T theta_from_z_p0_t_q(double z, T slp, T Ta, T qa) {
  const T es = e_sat(Ta);
  T pa = slp;
  T e;
  for (int k = 0; k < 3; ++k) {
    const T qsat = T(reps0) * es / (pa - T(1.0 - reps0) * es);
    const T f = qa / qsat;
    const T xm = (T(1) - f) * T(rmm_dryair) + f * T(rmm_water);
    e = T(grav) * xm * T(z) / (T(R_gas) * Ta);
    pa = slp * m_exp(-e);
  }
  return Ta * m_exp(T(rpoiss_dry) * e);
}

template <typename T> ABT_DI T visc_air(T Ta) {
  const T tc = Ta - T(rt0);
  const T tc2 = tc * tc;
  return T(1.326e-5) * (T(1) + T(6.542e-3) * tc + T(8.301e-6) * tc2 - T(4.84e-9) * tc2 * tc);
}

template <typename T> ABT_DI T l_vap(T sst) {
  return (T(2.501) - T(0.00237) * (sst - T(rt0))) * T(1.0e6);
}

template <typename T> ABT_DI T cp_air(T qa) { return T(rCp_dry) + T(rCp_vap) * qa; }

template <typename T> ABT_DI T one_on_l(T Thta, T qa, T us, T ts, T qs) {
  const T zqa = T(1) + T(rctv0) * qa;
  const T ool = T(grav * vkarmn) * (ts * zqa + T(rctv0) * Thta * qs)
                / maxp(us * us * Thta * zqa, T(1.0e-9));
  return clip_mag(ool, T(200));
}

template <typename T> ABT_DI T ri_bulk(double z, T sst, T Thta, T ssq, T qa, T ub) {
  const T sstv = virt_temp(sst, ssq);
  const T dthv = virt_temp(Thta, qa) - sstv;
  const T tv = T(0.5) * (sstv + virt_temp(Thta - T(rgamma_dry * z), qa));
  return T(grav) * dthv * T(z) / (tv * ub * ub);
}

template <typename T> struct Bulk { T Tau, Qsen, Qlat, Evap; };

// bulk_formula over water, or over ice with kIce (sublimation's latent heat of
// the unclamped flux, Evap = MIN(evap, 0)); rho is not needed by the reduced
// outputs
template <typename T, bool kIce = false>
ABT_DI Bulk<T> bulk_formula(double zu, T ts, T qs, T Thta, T qa, T Cd, T Ch, T Ce,
                        T wnd, T Ub, T slp) {
  const T ta = Thta - T(rgamma_dry * zu);
  const T den = T(R_dry) * ta * (T(1) + T(rctv0) * qa);
  T rho = maxp(slp / den, T(0.8));
  rho = maxp((slp - rho * T(grav) * T(zu)) / den, T(0.8));
  const T Urho = Ub * maxp(rho, T(1));
  Bulk<T> b;
  b.Tau = Urho * Cd * wnd;
  const T evap = Urho * Ce * (qa - qs);
  b.Qsen = Urho * Ch * (Thta - ts) * cp_air(qa);
  if constexpr (kIce) {
    b.Qlat = T(rLsub) * evap;
    b.Evap = minp(evap, T(0));
  } else {
    b.Qlat = l_vap(ts) * evap;
    b.Evap = evap;
  }
  return b;
}

// a where positive, else 1: the grad-safe feed of a root whose argument can be
// exactly 0 in a branch the stability mask zeroes out (stability._pos_or_one)
template <typename T> ABT_DI T pos_or_one(T a) { return a > T(0) ? a : T(1); }

// the humidity input as specific humidity (api.flux_step; slp floored at
// 50000 Pa as the reference does)
template <typename T> ABT_DI T q_air_of(int humidity, T hum, T t_zt, T slp) {
  T q_zt = hum;
  if (humidity == 2) q_zt = q_air_dp(hum, maxp(slp, T(50000)));
  else if (humidity == 1) q_zt = q_air_rh(hum, t_zt, maxp(slp, T(50000)));
  return q_zt;
}

// ---------------------------------------------------------------------------
// the arguments of a per-point body and the result of a bulk algorithm
// ---------------------------------------------------------------------------
struct Params {
  int niter;
  int charn_law;       // COARE: 0 charn_coare3p0, 1 charn_coare3p6
  int visc_at_tzu;     // COARE: air viscosity at the first-guess t_zu (3.6) or t_zt
  int humidity;        // 0: specific [kg/kg], 1: relative [%], 2: dew point [K]
  double z0t_max, z0t_coef, z0t_pow, beta0;   // COARE version constants
  double zt, zu, rdt, gdept, isecday_utc;     // rdt..isecday_utc: skin only
};

// what flux_step needs of an algorithm's FluxResult
template <typename T> struct Turb { T Cd, Ch, Ce, t_zu, q_zu, Ub, T_s, q_s; };

// the bulk formula of one surface's transfer coefficients
template <typename T, bool kIce = false>
ABT_DI Bulk<T> bulk_of(double zu, const Turb<T>& r, T wnd, T slp) {
  return bulk_formula<T, kIce>(zu, r.T_s, r.q_s, r.t_zu, r.q_zu, r.Cd, r.Ch, r.Ce,
                               wnd, r.Ub, slp);
}

// bulk formula and stress split: out = (QL QH Tau_x Tau_y Evap T_s)
template <typename T, bool kIce = false>
ABT_DI void flux_outputs(double zu, const Turb<T>& r, T wnd, T U, T V, T slp, T* out) {
  const Bulk<T> b = bulk_of<T, kIce>(zu, r, wnd, slp);
  const T inv_w = wnd > T(1.0e-3) ? T(1) / maxp(wnd, T(1.0e-3)) : T(0);

  out[0] = b.Qlat;
  out[1] = b.Qsen;
  out[2] = b.Tau * inv_w * U;
  out[3] = b.Tau * inv_w * V;
  out[4] = b.Evap;
  out[5] = r.T_s;
}

}  // namespace abt
