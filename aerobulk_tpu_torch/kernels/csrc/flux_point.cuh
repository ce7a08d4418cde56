// The COARE 3.0 / 3.6 bulk solve with cool skin and warm layer, the ECMWF
// cool skin and warm layer, and the per-point body of the fused stateful flux
// step, shared by the forward kernel (fused_step.cu, T = float or double) and
// the stages of the backward kernel's adjoint (adjoint.cuh, T = float,
// double or Dual<float|double, K> of dual.cuh).
// The body is a template on the skin solve: COARE's here, ECMWF's in
// algos_point.cuh (fused_step_ecmwf.cu, fused_grad_ecmwf.cu).  The COARE
// solve is a template on kSkin: the stateless kernel (bulk_step.cu) runs it
// with the cool skin and warm layer compiled out.  The rules on T are those
// of common.cuh.
//
// The body is the port's eager api.flux_step (aerobulk_tpu_torch) for one
// point; numerics rules are in fused_step.cu's header.

#pragma once

#include "common.cuh"

namespace abt {

// ---------------------------------------------------------------------------
// skin physics (aerobulk_tpu_torch/thermo.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T qlw_net(T dwlw, T ts) {
  const T t2 = ts * ts;
  return T(emiss_w) * (dwlw - T(stefan) * t2 * t2);
}

template <typename T> struct QnsTau { T Qns, Tau, Qlat; };

template <typename T>
ABT_DI QnsTau<T> update_qnsol_tau(double zu, T ts, T qs, T Thta, T qa, T ust, T tst,
                              T qst, T wnd, T Ub, T slp, T rlw) {
  const T zdt = nonzero_delta(Thta - ts, T(1.0e-9));
  const T zdq = nonzero_delta(qa - qs, T(1.0e-12));
  const T z0 = ust / Ub;
  const T Cd = z0 * z0;
  const T Ch = z0 * tst / zdt;
  const T Ce = z0 * qst / zdq;
  const Bulk<T> b = bulk_formula(zu, ts, qs, Thta, qa, Cd, Ch, Ce, wnd, Ub, slp);
  const T Qlw = qlw_net(rlw, ts);
  QnsTau<T> r;
  r.Qns = b.Qlat + b.Qsen + Qlw;
  r.Tau = b.Tau;
  r.Qlat = b.Qlat;
  return r;
}

template <typename T> ABT_DI T alpha_sw(T sst) {
  const T x = maxp(sst - T(rt0) + T(3.2), T(0));
  return T(2.1e-5) * (x > T(0) ? pow_pos(x, T(0.79)) : T(0));
}

template <typename T> struct SkinCoefs { T coef_y, ztmp, corr; };

// kSaunders: COARE's Saunders term from Qlat (corr); ECMWF has none
template <bool kSaunders, typename T>
ABT_DI SkinCoefs<T> skin_layer_coefs(T alpha, T ustar_a, T Qlat) {
  const T usw = maxp(ustar_a, T(1.0e-4)) * T(sq_radrw);
  const T inv_usw = T(1) / usw;
  const T inv2 = inv_usw * inv_usw;
  SkinCoefs<T> k;
  k.coef_y = alpha * T(rcst_cs) * (inv2 * inv2);
  k.ztmp = T(rnu0_w) * inv_usw;
  if constexpr (kSaunders) {
    k.corr = T(0.026) * minp(Qlat, T(0)) * T(rCp0_w) / T(rLevap) / alpha;
  } else {
    k.corr = T(0);
  }
  return k;
}

template <bool kSaunders, typename T>
ABT_DI T delta_skin_layer(const SkinCoefs<T>& k, T Qd) {
  T zQd = Qd;
  if constexpr (kSaunders) zQd = Qd + k.corr;
  const T ztf = step(zQd);
  const T zy = k.coef_y * zQd;
  const bool pos = zy > T(0);
  const T zs = m_sqrt(pos ? zy : T(1));
  const T lamb = T(6) * (T(1) / m_cbrt(T(1) + (pos ? zs * m_sqrt(zs) : T(0))));
  return (T(1) - ztf) * lamb * k.ztmp + ztf * minp(T(6) * k.ztmp, T(0.007));
}

// ---------------------------------------------------------------------------
// stability (aerobulk_tpu_torch/stability.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T psi_c_conv(T phi_c) {
  return T(1.5) * m_log((T(1) + phi_c + phi_c * phi_c) * T(INV_3))
         - T(1.7320508) * m_atan((T(1) + T(2) * phi_c) * T(INV_SQRT3))
         + T(1.813799447);
}

template <typename T> ABT_DI T psi_m_coare(T zeta) {
  const T phi_m = m_sqrt(m_sqrt(pos_or_one(m_abs(T(1) - T(15) * zeta))));
  const T psi_k = T(2) * m_log((T(1) + phi_m) * T(0.5))
                  + m_log((T(1) + phi_m * phi_m) * T(0.5))
                  - T(2) * m_atan(phi_m) + T(0.5 * rpi);
  const T phi_c = pow_pos(pos_or_one(m_abs(T(1) - T(10.15) * zeta)), T(0.3333));
  const T psi_c = psi_c_conv(phi_c);
  T f = zeta * zeta;
  f = f / (T(1) + f);
  const T cc = minp(T(0.35) * zeta, T(50));
  const T stb = step(zeta);
  return (T(1) - stb) * ((T(1) - f) * psi_k + f * psi_c)
         - stb * (T(1) + zeta + T(0.6667) * (zeta - T(14.28)) * m_exp(-cc) + T(8.525));
}

template <typename T> ABT_DI T psi_h_coare(T zeta) {
  const T phi_h = m_sqrt(pos_or_one(m_abs(T(1) - T(15) * zeta)));
  const T psi_k = T(2) * m_log((T(1) + phi_h) * T(0.5));
  const T phi_c = pow_pos(pos_or_one(m_abs(T(1) - T(34.15) * zeta)), T(0.3333));
  const T psi_c = psi_c_conv(phi_c);
  T f = zeta * zeta;
  f = f / (T(1) + f);
  const T cc = minp(T(0.35) * zeta, T(50));
  const T stb = step(zeta);
  T x32 = m_abs(T(1) + zeta * T(2.0 / 3.0));
  x32 = x32 * m_sqrt(pos_or_one(x32));
  return (T(1) - stb) * ((T(1) - f) * psi_k + f * psi_c)
         - stb * (x32 + T(0.6667) * (zeta - T(14.28)) * m_exp(-cc) + T(8.525));
}

// ---------------------------------------------------------------------------
// closures (aerobulk_tpu_torch/closures.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T charn_coare3p0(T wnd) {
  const T gt10 = step(wnd - T(10));
  const T gt18 = step(wnd - T(18));
  return (T(1) - gt10) * T(0.011)
         + gt10 * ((T(1) - gt18) * (T(0.011) + T(0.018 - 0.011) * (wnd - T(10)) / T(18.0 - 10.0))
                   + gt18 * T(0.018));
}

template <typename T> ABT_DI T charn_coare3p6(T wnd) {
  return maxp(minp(T(0.0017) * wnd - T(0.005), T(0.028)), T(0));
}

template <typename T> ABT_DI T charn_of(int law, T wnd) {
  return law == 0 ? charn_coare3p0(wnd) : charn_coare3p6(wnd);
}

// ---------------------------------------------------------------------------
// skin (aerobulk_tpu_torch/skin.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T wl_absorption(T Hwl) {
  return T(1) - (T(0.28 * 0.014) * (T(1) - m_exp(Hwl * T(-1.0 / 0.014)))
                 + T(0.27 * 0.357) * (T(1) - m_exp(Hwl * T(-1.0 / 0.357)))
                 + T(0.45 * 12.82) * (T(1) - m_exp(Hwl * T(-1.0 / 12.82))))
                / Hwl;
}

// What the cool skin's and the warm layer's passes show a tape: nothing,
// here.  The gradient kernel's recomputed iteration passes a tape that
// keeps what its walk back reads (adjoint.cuh's CsTape, WlTape), so that
// the primal it walks back is this one.
struct NoTape {
  template <typename C, typename T> ABT_DI void cs_pass(int, const C&, T, T) {}
  template <typename T> ABT_DI T absorption(int, T Hwl) { return wl_absorption(Hwl); }
  template <typename T> ABT_DI void wl_coefs(T, T, T) {}
  template <typename T> ABT_DI void wl_pass(int, T, T) {}
  ABT_DI void wl_end(bool, bool) {}
};

// the cool-skin fixed point of both schemes (skin._cs_generic)
template <bool kSaunders, typename T, typename Tape = NoTape>
ABT_DI T cs_generic(double fr0, T Qsw, T Qnsol, T ustar, T alpha, T Qlat, Tape&& tp = Tape{}) {
  const SkinCoefs<T> k = skin_layer_coefs<kSaunders>(alpha, ustar, Qlat);
  T Qabs = Qnsol;
  T delta = delta_skin_layer<kSaunders>(k, Qabs);
  tp.cs_pass(0, k, Qabs, delta);
  for (int it = 0; it < 4; ++it) {
    const T fr = maxp(T(fr0) + T(11) * delta
                      - T(6.6e-5) / delta * (T(1) - m_exp(delta * T(-1.0 / 8.0e-4))),
                      T(0.01));
    Qabs = Qnsol + fr * Qsw;
    delta = delta_skin_layer<kSaunders>(k, Qabs);
    tp.cs_pass(it + 1, k, Qabs, delta);
  }
  return Qabs * delta * T(1.0 / rk0_w);
}

template <typename T, typename Tape = NoTape>
ABT_DI T cs_coare(T Qsw, T Qnsol, T ustar, T alpha, T Qlat, Tape&& tp = Tape{}) {
  return cs_generic<true>(0.137, Qsw, Qnsol, ustar, alpha, Qlat, tp);
}

template <typename T, typename Tape = NoTape>
ABT_DI T cs_ecmwf(T Qsw, T Qnsol, T ustar, T alpha, Tape&& tp = Tape{}) {
  return cs_generic<false>(0.065, Qsw, Qnsol, ustar, alpha, T(0), tp);
}

template <typename T> ABT_DI T local_solar_seconds(T lon, double isecday_utc) {
  T rlag = -floor_mod((T(360) - floor_mod(lon, T(360))) / T(15), T(24));
  rlag = -fsign(minp(m_abs(rlag), m_abs(floor_mod(rlag, T(24)))), rlag + T(12));
  const T ilag_s = m_trunc(rlag * T(3600));
  return floor_mod(T(isecday_utc) + ilag_s, T(24.0 * 3600.0));
}

template <typename T> struct State { T dT_wl, Hz_wl, Qnt_ac, Tau_ac; };

template <typename T, typename Tape = NoTape>
ABT_DI void wl_coare(T Qsw, T Qnsol, T Tau, T alpha, T rhr_sol, double rdt,
                 double gdept, State<T>& st, Tape&& tp = Tape{}) {
  const T dTwl0 = st.dT_wl;
  const T Hwl0 = maxp(minp(st.Hz_wl, T(HWL_MAX)), T(0.1));
  const T qac0 = st.Qnt_ac;
  const T tac0 = st.Tau_ac;

  const T cd1 = m_sqrt(T(2.0 * RICH0 * rCp0_w) / (alpha * T(grav) * T(rho0_w)));
  const T cd2 = m_sqrt(T(2) * alpha * T(grav) / T(RICH0 * rho0_w)) / T(rCp0_w_pow15);

  // early-exit cascade as flags (mod_skin_coare.f90:159-185)
  const bool dawn = (rhr_sol > T(4)) && (rhr_sol <= T(6.5));
  bool destroy = dawn;
  const T Qabs = tp.absorption(0, Hwl0) * Qsw + Qnsol;
  const bool no_wl_yet = !dawn && (m_abs(dTwl0) < T(1.0e-6)) && (Qabs <= T(0));
  const bool exited = dawn || no_wl_yet;
  const T qac_first = qac0 + Qabs * T(rdt);
  const bool drained = !exited && (qac_first <= T(0));
  destroy = destroy || drained;
  const bool active = !(exited || drained);

  // main branch (mod_skin_coare.f90:188-227); a point that is not live
  // keeps qac/Hwl, so the loop stops at the first pass that ends it
  const T tac = tac0 + maxp(Tau, T(0.002)) * T(rdt);
  tp.wl_coefs(cd1, cd2, tac);
  T qac = qac0;
  T Hwl = Hwl0;
  bool live = active;
  for (int k = 0; k < 5 && live; ++k) {
    const T qac_i = k == 0 ? qac_first
                           : qac0 + (tp.absorption(k, Hwl) * Qsw + Qnsol) * T(rdt);
    qac = qac_i;
    const bool cont = qac_i > T(0);
    const T Hwl_i = maxp(minp(cd1 * tac / m_sqrt(maxp(qac_i, T(1.0e-30))), T(HWL_MAX)),
                         T(0.1));
    tp.wl_pass(k, qac_i, Hwl_i);
    if (cont) Hwl = Hwl_i;
    live = cont;
  }

  const bool ran_dry = active && (qac <= T(0));
  destroy = destroy || ran_dry;
  const bool built = active && (qac > T(0));
  tp.wl_end(destroy, built);

  const T qac_pos = maxp(qac, T(1.0e-30));
  T dTwl_new = cd2 * (qac_pos * m_sqrt(qac_pos)) / tac;
  const T flg = step(T(gdept) - Hwl);
  dTwl_new = dTwl_new * (flg + (T(1) - flg) * T(gdept) / Hwl);

  st.dT_wl = destroy ? T(0) : (built ? dTwl_new : dTwl0);
  st.Hz_wl = destroy ? T(HWL_MAX) : (built ? Hwl : Hwl0);
  st.Qnt_ac = destroy ? T(0) : (built ? qac : qac0);
  st.Tau_ac = destroy ? T(0) : (built ? tac : tac0);
}

// Takaya et al. 2010 stability function (skin._phi_takaya)
template <typename T> ABT_DI T phi_takaya(T zeta) {
  const T zt2 = zeta * zeta;
  const T tf = step(zeta);
  return tf * (T(1) + (T(5) * zeta + T(4) * zt2) / (T(1) + T(3) * zeta + T(0.25) * zt2))
         + (T(1) - tf) / m_sqrt(T(1) - T(16) * (-m_abs(zeta)));
}

constexpr double RNUWL0 = 0.5;                 // temperature-profile exponent
constexpr double FLA_ECMWF = 2.231443166940565;   // max(0.3 ** (-2/3), 1): La = 0.3

// The ECMWF warm layer (skin.wl_ecmwf, no Stokes drift): the new dT_wl from
// the state's dT_wl and its fixed depth Hwl; it commits on every call.
template <typename T>
ABT_DI T wl_ecmwf(T Qsw, T Qnsol, T ustar, T alpha, double rdt, double gdept, T dT_wl,
                  T Hwl) {
  constexpr double rhocp_w = rho0_w * rCp0_w;

  const T flg = step(T(gdept) - Hwl);
  const T tcorr = flg + (T(1) - flg) * T(gdept) / Hwl;
  const T dTwl_b = maxp(dT_wl / tcorr, T(0));

  const T fr = T(1) - T(0.28) * m_exp(T(-71.5) * Hwl) - T(0.27) * m_exp(T(-2.8) * Hwl)
               - T(0.45) * m_exp(T(-0.07) * Hwl);
  const T Qabs = fr * Qsw + Qnsol;

  const T usw = maxp(ustar, T(1.0e-4)) * T(sq_radrw);
  const T usw2 = usw * usw;

  const T wf = step(Qabs);
  const T cst1 = T(vkarmn * grav) * alpha;
  const T L2 = cst1 * Qabs / (T(rhocp_w) * usw2 * usw);
  const T cst2 = cst1 / (T(5) * Hwl * usw2);
  const T cst0 = T(rdt * (RNUWL0 + 1.0)) / Hwl;
  const T zA = cst0 * Qabs / T(RNUWL0 * rhocp_w);
  const T cst3 = -cst0 * T(vkarmn) * usw * T(FLA_ECMWF);

  T dTwl_n = dTwl_b;
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    dTwl_n = T(0.5) * (dTwl_n + dTwl_b);
    // the double select keeps sqrt's infinite slope at 0 out of the tangents
    const T y = dTwl_n * cst2;
    const bool pos = y > T(0);
    const T L1 = pos ? m_sqrt(pos ? y : T(1)) : T(0);
    const T zeta = (T(1) - wf) * Hwl * L1 + wf * Hwl * L2;
    const T zB = cst3 / phi_takaya(zeta);
    dTwl_n = maxp(dTwl_b + zA + zB * dTwl_n, T(0));
  }
  return dTwl_n * tcorr;
}

// ---------------------------------------------------------------------------
// COARE first guess (closures.first_guess_coare; ECMWF uses it too).  The
// caller passes the logs of its heights: computing them again here moves the
// float kernels' FMA contraction, and so the bits of fused_step.cu's results.
// ---------------------------------------------------------------------------
template <typename T> struct FirstGuess { T us, ts, qs, t_zu, q_zu, Ub, z0; };

template <typename T>
ABT_DI FirstGuess<T> first_guess_coare(double zt, double zu, bool zt_eq_zu, double log_10,
                                       double log_zt, double log_zu, T T_s, T theta_zt,
                                       T q_s, T q_zt, T wnd, T charn) {
  T us, ts, qs, t_zu, q_zu, Ub, z0;
  const double c_a = 0.035 * log(10.0 / 0.0001) / log(zu / 0.0001);
  t_zu = maxp(theta_zt, T(180));
  q_zu = maxp(q_zt, T(1.0e-6));
  T dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
  T dq = nonzero_delta(q_zu - q_s, T(1.0e-12));
  const T nu_a = visc_air(t_zu);
  Ub = m_sqrt(wnd * wnd + T(0.25));
  us = T(c_a) * Ub;
  z0 = charn * us * us / T(grav) + T(0.11) * nu_a / us;
  z0 = minp(maxp(m_abs(z0), T(1.0e-8)), T(1));
  const T log_z0 = m_log(z0);
  const T cdr = T(vkarmn) / (T(log_zu) - log_z0);
  const T Cd = cdr * cdr;
  const T one_on_sqrt_cd10 = (T(log_10) - log_z0) / T(vkarmn);
  T z0t = T(10) / m_exp(T(vkarmn) / (T(0.00115) * one_on_sqrt_cd10));
  z0t = minp(maxp(m_abs(z0t), T(1.0e-8)), T(1));
  const T log_z0t = m_log(z0t);
  const T Rib = ri_bulk(zu, T_s, t_zu, q_s, q_zu, Ub);
  const T cc = T(vkarmn2) / (Cd * (T(log_zt) - log_z0t));
  const T cc_ri = cc * Rib;
  const T stab = step(Rib);
  const T zeta_u = (T(1) - stab) * cc_ri / (T(1) + Rib * T(-c_b / zu))
                   + stab * (cc_ri + T(27.0 / 9.0) * Rib * Rib);
  us = maxp(Ub * T(vkarmn) / (T(log_zu) - log_z0 - psi_m_coare(zeta_u)), T(1.0e-9));
  const T ztmp = T(vkarmn) / (T(log_zu) - log_z0t - psi_h_coare(zeta_u));
  ts = dt * ztmp;
  qs = dq * ztmp;
  if (!zt_eq_zu) {
    const T zeta_t = T(zt) * zeta_u / T(zu);
    const T prf = T(log(zt / zu)) + psi_h_coare(zeta_u) - psi_h_coare(zeta_t);
    t_zu = theta_zt - ts / T(vkarmn) * prf;
    q_zu = q_zt - qs / T(vkarmn) * prf;
    q_zu = step(q_zu) * q_zu;
    dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
    dq = nonzero_delta(q_zu - q_s, T(1.0e-12));
    ts = dt * ztmp;
    qs = dq * ztmp;
  }
  z0 = charn * us * us / T(grav) + T(0.11) * nu_a / us;
  z0 = minp(maxp(m_abs(z0), T(1.0e-8)), T(1));
  return FirstGuess<T>{us, ts, qs, t_zu, q_zu, Ub, z0};
}

// ---------------------------------------------------------------------------
// the COARE 3.0 / 3.6 solve (algos/coare.turb_coare): with kSkin, cool skin
// and warm layer on (use_cs = use_wl = True), committing the warm layer in
// st; without, the bulk-SST solve (T_s and q_s stay the inputs, st unused)
// ---------------------------------------------------------------------------
template <typename T, bool kSkin>
ABT_DI Turb<T> turb_coare(const Params& p, T sst, T T_s, T q_s, T theta_zt, T q_zt,
                          T wnd, T slp, T Qsw, T rad_lw, T lon, State<T>& st) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log_10 = log(10.0), log_zt = log(zt), log_zu = log(zu);

  const T xSST = sst;
  T alpha, dT_cs, rhr_sol;
  if constexpr (kSkin) {
    alpha = alpha_sw(xSST);
    dT_cs = T(0);
  }

  const FirstGuess<T> fg = first_guess_coare(zt, zu, zt_eq_zu, log_10, log_zt, log_zu, T_s,
                                             theta_zt, q_s, q_zt, wnd,
                                             charn_of(p.charn_law, wnd));
  T us = fg.us, ts = fg.ts, qs = fg.qs, t_zu = fg.t_zu, q_zu = fg.q_zu;
  T Ub = fg.Ub, z0 = fg.z0;
  T log_z0 = m_log(z0);
  const T nu_a = p.visc_at_tzu ? visc_air(t_zu) : visc_air(theta_zt);

  T dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
  T dq = nonzero_delta(q_zu - q_s, T(1.0e-12));

  if constexpr (kSkin) rhr_sol = local_solar_seconds(lon, p.isecday_utc) / T(3600);
  const T beta2 = T(p.beta0 * p.beta0);

#pragma unroll 1
  for (int jit = 1; jit <= p.niter; ++jit) {
    const T us2 = us * us;
    const T one_on_L = clip_mag(one_on_l(t_zu, q_zu, us, ts, qs), T(200));

    const T gust2 = beta2 * us2 * pow23_pos(one_on_L * T(M_ZI0_OV_K));
    Ub = maxp(m_sqrt(wnd * wnd + gust2), T(0.2));

    const T zeta_u = clip_mag(T(zu) * one_on_L, T(50));

    const T Un10 = us * T(INV_K) * (T(log_10) - log_z0);
    const T charn = charn_of(p.charn_law, Un10);
    z0 = charn * us2 * T(INV_G) + T(0.11) * nu_a / us;
    z0 = minp(maxp(m_abs(z0), T(1.0e-9)), T(1));
    log_z0 = m_log(z0);

    const T inv_rer_pow = pow_pos(nu_a / (z0 * us), T(p.z0t_pow));
    T z0t = minp(T(p.z0t_coef) * inv_rer_pow, T(p.z0t_max));
    z0t = minp(maxp(m_abs(z0t), T(1.0e-9)), T(1));
    const T log_z0t = m_log(z0t);

    const T psi_h_u = psi_h_coare(zeta_u);
    const T fac = T(vkarmn) / (T(log_zu) - log_z0t - psi_h_u);
    ts = dt * fac;
    qs = dq * fac;
    us = maxp(Ub * T(vkarmn) / (T(log_zu) - log_z0 - psi_m_coare(zeta_u)), T(1.0e-9));

    if (!zt_eq_zu) {
      const T zeta_t = clip_mag(T(zt) * one_on_L, T(50));
      const T prf = T(log_zt - log_zu) + psi_h_u - psi_h_coare(zeta_t);
      t_zu = theta_zt - ts * T(INV_K) * prf;
      q_zu = q_zt - qs * T(INV_K) * prf;
    }

    if constexpr (kSkin) {
      // cool skin
      {
        const QnsTau<T> r = update_qnsol_tau(zu, T_s, q_s, t_zu, q_zu, us, ts, qs,
                                             wnd, Ub, slp, rad_lw);
        dT_cs = cs_coare(Qsw, r.Qns, us, alpha, r.Qlat);
        T_s = xSST + dT_cs;
        T_s = T_s + st.dT_wl;
        q_s = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), slp);
      }

      // warm layer: commits on every iteration that divides niter
      if (p.niter % jit == 0) {
        const QnsTau<T> r = update_qnsol_tau(zu, T_s, q_s, t_zu, q_zu, us, ts, qs,
                                             wnd, Ub, slp, rad_lw);
        wl_coare(Qsw, r.Qns, r.Tau, alpha, rhr_sol, p.rdt, p.gdept, st);
        T_s = xSST + st.dT_wl;
        T_s = T_s + dT_cs;
        q_s = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), slp);
      }
    }

    dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
    dq = nonzero_delta(q_zu - q_s, T(1.0e-12));
  }

  const T r = us / Ub;
  Turb<T> res;
  res.Cd = maxp(r * r, T(Cx_min));
  res.Ch = maxp(r * ts / dt, T(Cx_min));
  res.Ce = maxp(r * qs / dq, T(Cx_min));
  res.t_zu = t_zu;
  res.q_zu = q_zu;
  res.Ub = Ub;
  res.T_s = T_s;
  res.q_s = q_s;
  return res;
}

// ---------------------------------------------------------------------------
// the stateful step (api.flux_step -> the algorithm with cool skin + warm
// layer -> bulk_formula -> stress split)
// ---------------------------------------------------------------------------

// The skin solve of the stateful step for COARE 3.0 / 3.6 (algos_point.cuh
// has EcmwfSkin): the transfer coefficients, with the warm layer committed
// in st.
struct CoareSkin {
  template <typename T>
  ABT_DI Turb<T> operator()(const Params& p, T sst, T T_s, T q_s, T theta_zt, T q_zt, T wnd,
                            T slp, T Qsw, T rad_lw, T lon, State<T>& st) const {
    return turb_coare<T, true>(p, sst, T_s, q_s, theta_zt, q_zt, wnd, slp, Qsw, rad_lw, lon,
                               st);
  }
};

// One point: in = (sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, dT_wl
// Hz_wl Qnt_ac Tau_ac), out = (QL QH Tau_x Tau_y Evap T_s, new dT_wl Hz_wl
// Qnt_ac Tau_ac).
template <typename Solve = CoareSkin, typename T>
ABT_DI void flux_point(const T (&in)[13], T (&out)[10], const Params& p) {
  const T sst = in[0], t_zt = in[1], hum = in[2];
  const T U = in[3], V = in[4], slp = in[5];
  const T rad_sw = in[6], rad_lw = in[7], lon = in[8];
  State<T> st{in[9], in[10], in[11], in[12]};

  // --- flux_step: humidity, wind, theta, radiation --------------------------
  const T q_zt = q_air_of(p.humidity, hum, t_zt, slp);
  const T wnd = m_sqrt(U * U + V * V);
  const T theta_zt = theta_from_z_p0_t_q(p.zt, slp, t_zt, q_zt);
  const T Qsw = T(1.0 - roce_alb0) * rad_sw;

  // --- turb_*(use_cs=True, use_wl=True): surface first guess --------------
  const T T_s = sst - T(0.25);
  const T q_s = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), slp);
  const Turb<T> r = Solve()(p, sst, T_s, q_s, theta_zt, q_zt, wnd, slp, Qsw, rad_lw, lon, st);

  // --- bulk formula and stress split ----------------------------------------
  flux_outputs(p.zu, r, wnd, U, V, slp, out);
  out[6] = st.dT_wl;
  out[7] = st.Hz_wl;
  out[8] = st.Qnt_ac;
  out[9] = st.Tau_ac;
}

}  // namespace abt
