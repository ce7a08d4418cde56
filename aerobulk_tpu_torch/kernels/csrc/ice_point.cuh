// The seven sea-ice bulk solves for one point, and the per-point body of the
// ice-only flux step (ice_step.cu): api.flux_step_ice.  Templates on the
// scalar type T under the rules of common.cuh; mixed_point.cuh runs the same
// solves over the ice fraction of a mixed ocean+ice cell.
//
// Each function follows its aerobulk_tpu_torch counterpart (thermo.py's ice
// branch, stability.psi_*_ice, ice/{form_drag,nemo,lu12,easy,an05,best,
// lg15}.py) expression by expression: constants that Python folds in double
// are folded in double here (constexpr, or double arithmetic on zt/zu that is
// uniform over the grid), and Python's association order is kept.  Two folds
// drop terms that are exactly zero in the reference, bit for bit on finite
// values: BEST's form drag (zfo = 0 makes cdn_form_ice == 0 and the terms
// 0 * f) and LU13's frice ** 0.0 (== 1 for every frice, NaN included).
// Every power goes through common.cuh's pow_pos: each site says why its base
// is positive or 0.

#pragma once

#include <type_traits>

#include "common.cuh"

namespace abt {

// ---------------------------------------------------------------------------
// constants (thermo.py, ice/*.py; the tests compare every literal with
// Python's value)
// ---------------------------------------------------------------------------
constexpr double rtt0 = 273.16;
constexpr double rCd_ice = 0.0014;
constexpr double wspd_thrshld_ice = 0.2;
constexpr double RAG_I = -9.09718;
constexpr double RBG_I = -3.56654;
constexpr double RCG_I = 0.876793;
constexpr double RDG_I = 0.7858350313586662;           // math.log10(6.1071)
constexpr double RC3_LOUIS = 75.0;                     // 3.0 * _rc2_louis
constexpr double RAM_LOUIS = 10.0;
constexpr double RAH_LOUIS = 15.0;
constexpr double RCE_0 = 0.00223;
constexpr double LU13_COEF = 1.0714285714285714;       // 1 + 1/(10*1.4)
constexpr double RCE10_I_0 = 0.00346;
constexpr double RBETA_0 = 1.4;
constexpr double RALPHA_0 = 0.2;
constexpr double RZ0_I_S_0 = 0.00069;
constexpr double RZ0_I_F_0 = 0.000454;
constexpr double RZ0_W_0 = 0.000327;
constexpr double LG15_CHF = 4.023594781085251;         // log(1/RALPHA_0)/vkarmn
constexpr double Z0_ICE_BEST = 0.001;
constexpr double Z1_ALPHA_BEST = 5.0;                  // 1.0 / 0.2

enum IceAlgo {
  kIceNemo = 0, kIceEasy = 1, kIceAn05 = 2, kIceLu12 = 3, kIceLg15 = 4,
  kIceLg15Io = 5, kIceBest = 6
};

// the algorithms that take the ice concentration (ICE_ALGOS' needs_frice)
ABT_HD constexpr bool ice_needs_frice(int algo) {
  return algo == kIceLu12 || algo == kIceLg15 || algo == kIceLg15Io;
}

// Calls fn(std::integral_constant<int, kIce>()) for the abt::IceAlgo algo and
// returns true, or false for an unknown algo: the host switch of the kernels
// that instantiate one solve per ice algorithm
template <typename Fn> bool with_ice_algo(int algo, Fn&& fn) {
  switch (algo) {
    case kIceNemo: fn(std::integral_constant<int, kIceNemo>()); return true;
    case kIceEasy: fn(std::integral_constant<int, kIceEasy>()); return true;
    case kIceAn05: fn(std::integral_constant<int, kIceAn05>()); return true;
    case kIceLu12: fn(std::integral_constant<int, kIceLu12>()); return true;
    case kIceLg15: fn(std::integral_constant<int, kIceLg15>()); return true;
    case kIceLg15Io: fn(std::integral_constant<int, kIceLg15Io>()); return true;
    case kIceBest: fn(std::integral_constant<int, kIceBest>()); return true;
    default: return false;
  }
}

// ice_easy's scalar settings, computed on the host in double as the JAX
// package's statics are (easy.py:19-28)
struct IceKw {
  double CdN, ChN, CeN;
  double sqrt_CdN, log_ztzu, log_zu10;
};

// ---------------------------------------------------------------------------
// thermo, ice branch (thermo.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T e_sat_ice(T Ta) {
  const T ta = maxp(Ta, T(180.0));
  const T ztmp = T(rtt0) / ta;
  const T zle = T(RAG_I) * (ztmp - T(1)) + T(RBG_I) * m_log10(ztmp)
                + T(RCG_I) * (T(1) - ta / T(rtt0)) + T(RDG_I);
  return T(100.0) * exp10_(zle);
}

template <typename T> ABT_DI T q_sat_ice(T Ta, T slp) {
  const T es = e_sat_ice(Ta);
  return T(reps0) * es / (slp - T(1.0 - reps0) * es);
}

// The Louis (1979) functions share everything but the last coefficient:
// c3cdn is the product 3 * rc2 * Cdn as Python forms it (a T product for a
// tensor Cdn, a double fold for a float one), zz1 the value zu / z0 + 1.
template <typename T> struct Louis { T fm, fh; };

template <typename T> ABT_DI Louis<T> f_louis(T Rib, T c3cdn, T zz1) {
  const T zstab = step(Rib);
  const T ztu = Rib / (T(1) + c3cdn * m_sqrt(m_abs(-Rib * zz1)));
  const T zts = Rib / m_sqrt(m_abs(T(1) + Rib));
  Louis<T> f;
  f.fm = (T(1) - zstab) * (T(1) - T(RAM_LOUIS) * ztu) + zstab / (T(1) + T(RAM_LOUIS) * zts);
  f.fh = (T(1) - zstab) * (T(1) - T(RAH_LOUIS) * ztu) + zstab / (T(1) + T(RAH_LOUIS) * zts);
  return f;
}

template <typename T> ABT_DI T cd_from_z0(double zu, T z0) {
  const T r = T(1) / m_log(T(zu) / z0);
  return T(vkarmn2) * r * r;
}

// ---------------------------------------------------------------------------
// stability.psi_m_ice / psi_h_ice (Jordan et al. 1999)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T psi_s_holtslag(T zeta) {
  return -(T(0.7) * zeta + T(0.75) * (zeta - T(14.3)) * m_exp(T(-0.35) * zeta) + T(10.7));
}

// x = |1 - 16 zeta| ** 0.25 through pow_pos: pos_or_one gives a positive base
template <typename T> ABT_DI T psi_m_ice(T zeta) {
  const T x = pow_pos(pos_or_one(m_abs(T(1) - T(16) * zeta)), T(0.25));
  const T psi_u = m_log((T(1) + x * x) / T(2)) + T(2) * m_log((T(1) + x) / T(2))
                  - T(2) * m_atan(x) + T(0.5 * rpi);
  const T stb = step(zeta);
  return (T(1) - stb) * psi_u + stb * psi_s_holtslag(zeta);
}

template <typename T> ABT_DI T psi_h_ice(T zeta) {
  const T x = pow_pos(pos_or_one(m_abs(T(1) - T(16) * zeta)), T(0.25));   // as psi_m_ice
  const T psi_u = T(2) * m_log((T(1) + x * x) / T(2));
  const T stb = step(zeta);
  return (T(1) - stb) * psi_u + stb * psi_s_holtslag(zeta);
}

// ---------------------------------------------------------------------------
// ice/nemo.py and ice/lu12.py: no iteration
// ---------------------------------------------------------------------------
template <typename T> ABT_DI Turb<T> neutral_result(T Cd, T Ts_i, T t_zt, T qs_i, T q_zt, T U) {
  Turb<T> r;
  r.Cd = Cd;
  r.Ch = Cd;
  r.Ce = Cd;
  r.t_zu = maxp(t_zt, T(100));
  r.q_zu = maxp(q_zt, T(1.0e-7));
  r.Ub = maxp(U, T(wspd_thrshld_ice));
  r.T_s = Ts_i;
  r.q_s = qs_i;
  return r;
}

// cdn10_f_lu13: RCE_0 * frice ** 0.0 * (1 - frice) ** LU13_COEF, with the
// factor frice ** 0.0 == 1 folded out.  The power goes through pow_pos: for
// frice in [0, 1] the base is >= 0, and at 0 both pow_pos and powf give 0;
// for frice > 1 (a negative base) or NaN both give NaN.
template <typename T> ABT_DI T cdn10_f_lu13(T frice) {
  return T(RCE_0) * pow_pos(T(1) - frice, T(LU13_COEF));
}

// ---------------------------------------------------------------------------
// ice/easy.py
// ---------------------------------------------------------------------------
template <typename T>
ABT_DI Turb<T> turb_ice_easy(const Params& p, const IceKw& kw, T Ts_i, T t_zt, T qs_i,
                             T q_zt, T U_zu) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const T Ub = maxp(U_zu, T(wspd_thrshld_ice));
  T t_zu = maxp(t_zt, T(100));
  T q_zu = maxp(q_zt, T(1.0e-7));
  T Cd = T(kw.CdN), Ch = T(kw.ChN), Ce = T(kw.CeN);

#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    const T dt = t_zu - Ts_i;      // no nonzero floor inside the loop
    const T dq = q_zu - qs_i;

    const T r = m_sqrt(Cd);
    const T us = r * Ub;
    const T inv_r = T(1) / maxp(r, T(1.0e-15));
    const T ts = Ch * dt * inv_r;
    const T qs = Ce * dq * inv_r;

    const T ool = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), T(200));
    const T zeta_u = clip_mag(T(zu) * ool, T(50));

    T t0 = T(1) + T(kw.sqrt_CdN / vkarmn) * (T(kw.log_zu10) - psi_m_ice(zeta_u));
    Cd = minp(maxp(T(kw.CdN) / (t0 * t0), T(Cx_min)), T(1.9e-3));

    const T psi_h_u = psi_h_ice(zeta_u);
    t0 = (T(kw.log_zu10) - psi_h_u) / T(vkarmn) / T(kw.sqrt_CdN);
    const T t1 = m_sqrt(Cd) / T(kw.sqrt_CdN);
    Ch = minp(maxp(T(kw.ChN) * t1 / (T(1) + T(kw.ChN) * t0), T(Cx_min)), T(1.9e-3));
    Ce = minp(maxp(T(kw.CeN) * t1 / (T(1) + T(kw.CeN) * t0), T(Cx_min)), T(1.9e-3));

    if (!zt_eq_zu) {
      const T zeta_t = clip_mag(T(zt) * ool, T(50));
      const T prf = psi_h_u - psi_h_ice(zeta_t) + T(kw.log_ztzu);
      t_zu = t_zt - ts / T(vkarmn) * prf;
      q_zu = maxp(q_zt - qs / T(vkarmn) * prf, T(0));
    }
  }

  Turb<T> r;
  r.Cd = Cd;
  r.Ch = Ch;
  r.Ce = Ce;
  r.t_zu = t_zu;
  r.q_zu = q_zu;
  r.Ub = Ub;
  r.T_s = Ts_i;
  r.q_s = qs_i;
  return r;
}

// ---------------------------------------------------------------------------
// ice/an05.py
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T rough_leng_m(T us, T nua) {
  us = maxp(us, T(1.0e-9));
  const T zz = (us - T(0.18)) / T(0.1);
  return T(0.135) * nua / us
         + T(0.035) * us * us / T(grav) * (T(5) * m_exp(-zz * zz) + T(1));
}

// The reference's 0.5+SIGN regime masks, kept as masks: for Re_r in
// (2.49999, 2.5) all three are 0 and z0t = z0q = z0.
template <typename T> ABT_DI void rough_leng_tq(T z0, T us, T nua, T& z0t, T& z0q) {
  us = maxp(us, T(1.0e-9));
  const T re = maxp(us * z0 / nua, T(0));

  const T smooth = step(T(0.135) - re);
  const T trans = step(T(2.49999) - re) - smooth;
  const T rough = step(re - T(2.5));

  const T lg = m_log(re);
  const T lg2 = lg * lg;

  T b0 = smooth * T(1.25) + trans * T(0.149) + rough * T(0.317);
  T b1 = -trans * T(0.550) - rough * T(0.565);
  T b2 = -rough * T(0.183);
  z0t = z0 * m_exp(b0 + b1 * lg + b2 * lg2);

  b0 = smooth * T(1.61) + trans * T(0.351) + rough * T(0.396);
  b1 = -trans * T(0.628) - rough * T(0.512);
  b2 = -rough * T(0.180);
  z0q = z0 * m_exp(b0 + b1 * lg + b2 * lg2);
}

template <typename T>
ABT_DI Turb<T> turb_ice_an05(const Params& p, T Ts_i, T t_zt, T qs_i, T q_zt, T U_zu) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log_zu = log(zu);
  const double log_ztzu = log(zt / zu);

  const T Ub = maxp(U_zu, T(wspd_thrshld_ice));
  T t_zu = maxp(t_zt, T(100));
  T q_zu = maxp(q_zt, T(1.0e-7));

  T dt = nonzero_delta(t_zu - Ts_i, T(1.0e-6));
  T dq = nonzero_delta(q_zu - qs_i, T(1.0e-9));

  const T nu_a = visc_air(t_zu);

  // crude first guesses (mod_blk_ice_an05.f90:155-169)
  const T z0i = T(8.0e-4);
  T us = T(0.035) * Ub * m_log(T(10) / z0i) / m_log(T(zu) / z0i);
  T z0 = rough_leng_m(us, nu_a);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    us = maxp(Ub * T(vkarmn) / (T(log_zu) - m_log(z0)), T(1.0e-9));
    z0 = rough_leng_m(us, nu_a);
  }
  T z0t, z0q;
  rough_leng_tq(z0, us, nu_a, z0t, z0q);
  T ts = dt * T(vkarmn) / m_log(T(zu) / z0t);
  T qs = dq * T(vkarmn) / m_log(T(zu) / z0q);

#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    const T ool = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), T(200));
    const T zeta_u = clip_mag(T(zu) * ool, T(50));

    z0 = rough_leng_m(us, nu_a);
    rough_leng_tq(z0, us, nu_a, z0t, z0q);

    const T psi_h_u = psi_h_ice(zeta_u);
    ts = dt * T(vkarmn) / (T(log_zu) - m_log(z0t) - psi_h_u);
    qs = dq * T(vkarmn) / (T(log_zu) - m_log(z0q) - psi_h_u);
    us = maxp(Ub * T(vkarmn) / (T(log_zu) - m_log(z0) - psi_m_ice(zeta_u)), T(1.0e-9));

    if (!zt_eq_zu) {
      const T zeta_t = clip_mag(T(zt) * ool, T(50));
      const T prf = T(log_ztzu) + psi_h_u - psi_h_ice(zeta_t);
      t_zu = t_zt - ts / T(vkarmn) * prf;
      q_zu = q_zt - qs / T(vkarmn) * prf;
      dt = nonzero_delta(t_zu - Ts_i, T(1.0e-6));
      dq = nonzero_delta(q_zu - qs_i, T(1.0e-9));
    }
  }

  const T r = us / Ub;
  Turb<T> res;
  res.Cd = r * r;
  res.Ch = r * ts / dt;
  res.Ce = r * qs / dq;
  res.t_zu = t_zu;
  res.q_zu = q_zu;
  res.Ub = Ub;
  res.T_s = Ts_i;
  res.q_s = qs_i;
  return res;
}

// ---------------------------------------------------------------------------
// ice/best.py
// ---------------------------------------------------------------------------
// the Python-float constants of cx_lupkes2015 at zu, folded in double
struct BestConsts {
  double cdn_skin_ice, chn_skin_ice, c3cdn, zz1;
};

ABT_DI BestConsts best_consts(double zu) {
  BestConsts b;
  const double a = vkarmn / log(zu / RZ0_I_S_0 + 1.0);
  b.cdn_skin_ice = a * a;
  b.chn_skin_ice = vkarmn2 / (log(zu / Z0_ICE_BEST + 1.0)
                              * log(zu * Z1_ALPHA_BEST / RZ0_I_S_0 + 1.0));
  b.c3cdn = RC3_LOUIS * b.cdn_skin_ice;
  b.zz1 = zu / RZ0_I_S_0 + 1.0;
  return b;
}

template <typename T> struct CdCh { T Cd, Ch; };

// cx_lupkes2015 with its zero form-drag terms folded out
template <typename T>
ABT_DI CdCh<T> cx_lupkes2015(double zu, const BestConsts& b, T t_zu, T q_zu, T Ui_zu,
                             T Ts_i, T qs_i) {
  const T wndspd = maxp(Ui_zu, T(0.5));
  const T rib = ri_bulk(zu, Ts_i, t_zu, qs_i, q_zu, wndspd);
  const Louis<T> f = f_louis(rib, T(b.c3cdn), T(b.zz1));
  return {T(b.cdn_skin_ice) * f.fm, T(b.chn_skin_ice) * f.fh};
}

template <typename T>
ABT_DI Turb<T> turb_ice_best(const Params& p, T Ts_i, T t_zt, T qs_i, T q_zt, T U_zu) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log_zu10 = log(zu / 10.0);
  const double log_ztzu = log(zt / zu);
  const BestConsts b = best_consts(zu);

  const T Ub = maxp(U_zu, T(wspd_thrshld_ice));
  T t_zu = t_zt;
  T q_zu = q_zt;

  CdCh<T> cx = cx_lupkes2015(zu, b, t_zu, q_zu, Ub, Ts_i, qs_i);
  T Cd = cx.Cd, Ch = cx.Ch;
  T Ce = Ch;
  T sqrt_Cd = m_sqrt(Cd);
  T sqrt_Cdn10 = sqrt_Cd;

#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    const T dt = t_zu - Ts_i;
    const T dq = q_zu - qs_i;

    const T us = sqrt_Cd * Ub;
    const T ts = Ch / sqrt_Cd * dt;
    const T qs = Ce / sqrt_Cd * dq;

    const T ool = one_on_l(t_zu, q_zu, us, ts, qs);
    const T zeta_u = clip_mag(T(zu) * ool, T(10));
    const T psi_h_u = psi_h_ice(zeta_u);

    if (!zt_eq_zu) {
      const T zeta_t = clip_mag(T(zt) * ool, T(10));
      const T prf = T(log_ztzu) + psi_h_u - psi_h_ice(zeta_t);
      t_zu = t_zt - ts / T(vkarmn) * prf;
      q_zu = maxp(q_zt - qs / T(vkarmn) * prf, T(0));
    }

    const T psi_m_u = psi_m_ice(zeta_u);
    const T un10 = maxp(Ub / (T(1) + sqrt_Cdn10 / T(vkarmn) * (T(log_zu10) - psi_m_u)),
                        T(wspd_thrshld_ice));

    cx = cx_lupkes2015(zu, b, t_zu, q_zu, un10, Ts_i, qs_i);
    const T Cx_n10 = cx.Ch;
    sqrt_Cdn10 = m_sqrt(cx.Cd);

    const T t1 = T(1) + sqrt_Cdn10 / T(vkarmn) * (T(log_zu10) - psi_m_u);
    Cd = cx.Cd / (t1 * t1);
    sqrt_Cd = m_sqrt(Cd);

    const T t0 = (T(log_zu10) - psi_h_u) / T(vkarmn) / sqrt_Cdn10;
    const T t2 = sqrt_Cd / sqrt_Cdn10;
    Ch = Cx_n10 * t2 / (T(1) + Cx_n10 * t0);
    Ce = Ch;
  }

  Turb<T> r;
  r.Cd = Cd;
  r.Ch = Ch;
  r.Ce = Ce;
  r.t_zu = t_zu;
  r.q_zu = q_zu;
  r.Ub = Ub;
  r.T_s = Ts_i;
  r.q_s = qs_i;
  return r;
}

// ---------------------------------------------------------------------------
// ice/lg15.py
// ---------------------------------------------------------------------------
template <typename T> struct Neutral { T CdN_s, ChN_s, CdN_f, ChN_f; };

// _neutral_coeffs at the skin roughness z0_s, with form drag when kForm
template <typename T, bool kForm>
ABT_DI Neutral<T> neutral_coeffs(double zu, T z0_s, T frice) {
  Neutral<T> n;
  n.CdN_s = cd_from_z0(zu, z0_s);
  n.ChN_s = T(vkarmn2) / (m_log(T(zu) / z0_s) * m_log(T(zu) / (T(RALPHA_0) * z0_s)));
  if constexpr (kForm) {
    // cdn_f_lg15_light at z0_f = RZ0_I_F_0, a tensor in the reference
    const T z0_f = T(RZ0_I_F_0);
    const T rlog = m_log(T(10) / z0_f) / m_log(T(zu) / z0_f);
    // (1 - frice) ** RBETA_0 through pow_pos, as in cdn10_f_lu13: 0 at
    // frice = 1, NaN for frice > 1 or NaN, as powf gives
    n.CdN_f = T(RCE10_I_0) * rlog * rlog * frice * pow_pos(T(1) - frice, T(RBETA_0));
    n.ChN_f = n.CdN_f / (T(1) + T(LG15_CHF) * m_sqrt(n.CdN_f));
  } else {
    n.CdN_f = T(0);
    n.ChN_f = T(0);
  }
  return n;
}

// One surface's Louis-stability solve (_lg15_surface).  kForm: skin and form
// drag (the ice side); without it the form terms, all exactly 0 in the
// reference, are skipped, not multiplied by 0 (z0_f == 0 would make them NaN
// through zu / 0).  kRibAtZu: RiB at zu from the current t_zu/q_zu (the IO
// variant's water side) instead of at zt with the wind adjusted to zt.
template <typename T, bool kForm, bool kRibAtZu>
ABT_DI Turb<T> lg15_surface(const Params& p, T Ts, T t_zt, T qs, T q_zt, T Ub, T z0_s,
                            const Neutral<T>& n) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log_ztzu = log(zt / zu);

  T t_zu = maxp(t_zt, T(100));
  T q_zu = maxp(q_zt, T(1.0e-7));
  T dt = nonzero_delta(t_zu - Ts, T(1.0e-6));
  T dq = nonzero_delta(q_zu - qs, T(1.0e-9));

  const T z0_f = kForm ? T(RZ0_I_F_0) : T(0);
  const T CdN_tot = kForm ? n.CdN_s + n.CdN_f : n.CdN_s;
  const T z0_tot = kForm ? z0_s + z0_f : z0_s;
  T Cd = CdN_tot;
  T Ch = kForm ? n.ChN_s + n.ChN_f : n.ChN_s;
  T Rib = ri_bulk(zt, Ts, t_zt, qs, q_zt, Ub);

  // the z / z0 + 1 of each Louis call, fixed over the loop
  const T zz1_s = T(zu) / z0_s + T(1);
  const T zz1_f = T(zu) / z0_f + T(1);
  const T zz1_tot_u = T(zu) / z0_tot + T(1);
  const T zz1_tot_t = T(zt) / z0_tot + T(1);
  const T c3_s = T(RC3_LOUIS) * n.CdN_s;
  const T c3_f = T(RC3_LOUIS) * n.CdN_f;
  const T c3_tot = T(RC3_LOUIS) * CdN_tot;

#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    if constexpr (kRibAtZu) {
      Rib = ri_bulk(zu, Ts, t_zu, qs, q_zu, Ub);
    } else {
      T U_zt = Ub;
      if (!zt_eq_zu) {
        const T prf = T(log_ztzu) + f_louis(Rib, c3_tot, zz1_tot_u).fh
                      - f_louis(Rib, c3_tot, zz1_tot_t).fh;
        U_zt = maxp(Ub + m_sqrt(Cd) * Ub * prf, T(wspd_thrshld_ice));
        U_zt = minp(U_zt, Ub);
      }
      Rib = ri_bulk(zt, Ts, t_zt, qs, q_zt, U_zt);
    }

    // Louis-79 stability applied to skin and form parts (Eq. 6 / 10)
    const Louis<T> fs = f_louis(Rib, c3_s, zz1_s);
    Cd = n.CdN_s * fs.fm;
    Ch = n.ChN_s * fs.fh;
    if constexpr (kForm) {
      const Louis<T> ff = f_louis(Rib, c3_f, zz1_f);
      Cd = Cd + n.CdN_f * ff.fm;
      Ch = Ch + n.ChN_f * ff.fh;
    }

    if (!zt_eq_zu) {
      const T prf = T(log_ztzu) + f_louis(Rib, c3_tot, zz1_tot_u).fh
                    - f_louis(Rib, c3_tot, zz1_tot_t).fh;
      const T inv_sq = T(1) / m_sqrt(Cd);
      t_zu = t_zt - (Ch * dt * inv_sq) / T(vkarmn) * prf;
      q_zu = maxp(q_zt - (Ch * dq * inv_sq) / T(vkarmn) * prf, T(0));
      dt = nonzero_delta(t_zu - Ts, T(1.0e-6));
      dq = nonzero_delta(q_zu - qs, T(1.0e-9));
    }
  }

  Turb<T> r;
  r.Cd = Cd;
  r.Ch = Ch;
  r.Ce = Ch;
  r.t_zu = t_zu;
  r.q_zu = q_zu;
  r.Ub = Ub;
  r.T_s = Ts;
  r.q_s = qs;
  return r;
}

// turb_ice_lg15 (and the ice side of turb_ice_lg15_io, the same solve)
template <typename T>
ABT_DI Turb<T> turb_ice_lg15(const Params& p, T Ts_i, T t_zt, T qs_i, T q_zt, T U_zu,
                             T frice) {
  const T Ub = maxp(U_zu, T(wspd_thrshld_ice));
  const T z0_s = T(RZ0_I_S_0);
  const Neutral<T> n = neutral_coeffs<T, true>(p.zu, z0_s, frice);
  return lg15_surface<T, true, false>(p, Ts_i, t_zt, qs_i, q_zt, Ub, z0_s, n);
}

// the water side of turb_ice_lg15_io: skin drag only, at RZ0_W_0, RiB at zu
template <typename T>
ABT_DI Turb<T> turb_water_lg15_io(const Params& p, T sst, T t_zt, T ssq, T q_zt, T U_zu) {
  const T Ub = maxp(U_zu, T(wspd_thrshld_ice));
  const T z0_s = T(RZ0_W_0);
  const Neutral<T> n = neutral_coeffs<T, false>(p.zu, z0_s, T(0));
  return lg15_surface<T, false, true>(p, sst, t_zt, ssq, q_zt, Ub, z0_s, n);
}

// ---------------------------------------------------------------------------
// the ice-only step (api.flux_step_ice -> the algorithm -> the ice branch of
// bulk_formula -> stress split)
// ---------------------------------------------------------------------------
template <typename T, int kIce>
ABT_DI Turb<T> turb_ice(const Params& p, const IceKw& kw, T Ts_i, T theta_zt, T qs_i,
                        T q_zt, T wnd, T frice) {
  if constexpr (kIce == kIceNemo) {
    return neutral_result(T(rCd_ice), Ts_i, theta_zt, qs_i, q_zt, wnd);
  } else if constexpr (kIce == kIceLu12) {
    const T Cd = cd_from_z0(p.zu, T(RZ0_I_S_0)) + cdn10_f_lu13(frice);
    return neutral_result(Cd, Ts_i, theta_zt, qs_i, q_zt, wnd);
  } else if constexpr (kIce == kIceEasy) {
    return turb_ice_easy(p, kw, Ts_i, theta_zt, qs_i, q_zt, wnd);
  } else if constexpr (kIce == kIceAn05) {
    return turb_ice_an05(p, Ts_i, theta_zt, qs_i, q_zt, wnd);
  } else if constexpr (kIce == kIceBest) {
    return turb_ice_best(p, Ts_i, theta_zt, qs_i, q_zt, wnd);
  } else {
    return turb_ice_lg15(p, Ts_i, theta_zt, qs_i, q_zt, wnd, frice);
  }
}

// The inputs every ice-side body derives first (api.flux_step_ice)
template <typename T> struct IceAir { T q_zt, wnd, qs_i, theta_zt; };

template <typename T> ABT_DI IceAir<T> ice_air(const Params& p, T Ts_i, T t_zt, T hum,
                                               T U, T V, T slp) {
  IceAir<T> a;
  a.q_zt = q_air_of(p.humidity, hum, t_zt, slp);
  a.wnd = m_sqrt(U * U + V * V);
  a.qs_i = q_sat_ice(Ts_i, slp);
  a.theta_zt = theta_from_z_p0_t_q(p.zt, slp, t_zt, a.q_zt);
  return a;
}

// One point: in = (Ts_i t_zt hum_zt U_zu V_zu slp frice), out = (QL QH Tau_x
// Tau_y Evap T_s); frice is read only by the algorithms that take it.
template <typename T, int kIce>
ABT_DI void ice_point(const T (&in)[7], T (&out)[6], const Params& p, const IceKw& kw) {
  const T Ts_i = in[0], t_zt = in[1], hum = in[2];
  const T U = in[3], V = in[4], slp = in[5], frice = in[6];
  const IceAir<T> a = ice_air(p, Ts_i, t_zt, hum, U, V, slp);
  const Turb<T> r = turb_ice<T, kIce>(p, kw, Ts_i, a.theta_zt, a.qs_i, a.q_zt, a.wnd, frice);
  flux_outputs<T, true>(p.zu, r, a.wnd, U, V, slp, out);
}

}  // namespace abt
