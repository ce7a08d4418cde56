// The reverse-mode adjoint of one stateful flux step per point (COARE 3.0 /
// 3.6 or ECMWF, with cool skin and warm layer): given the 13 inputs and the
// 10 cotangents of the outputs, the 13 gradients.  The body of fused_grad.cu
// (and fused_grad_ecmwf.cu); a host compiler builds it too, for the CPU test
// tests/test_torch_adjoint_host.py.
//
// The step is cut into stages of a few inputs each (the first guess, 1/L,
// the gustiness, the roughness lengths, the psi functions, the bulk
// formula, the cool skin, the warm layer, q_sat of the new T_s, ...).  A
// stage is a functor, a template on the scalar type, written once: on S it
// gives the primal; on Dual<S, N> (dual.cuh), N its input count, it gives
// its Jacobian, which vjp() contracts with the stage's output adjoints.  So
// the rules of dual.cuh at the points that are not differentiable (ties of
// maxp/minp split 0.5/0.5, |x| at 0, copysign, the double-select guards)
// hold here unchanged, and the adjoint agrees with jax.vjp there.  An output
// that no later stage reads is not an output of its stage, so that, as in
// JAX's transpose, no zero cotangent meets its partials.  Two adjoints are
// written out instead, where duals cost the most (PERF.md): the bulk
// formula's products (qns_vjp; smooth, 11 inputs, two or three times per
// iteration) and the ECMWF warm layer's 10-pass solve (wl_ecmwf_solve_vjp,
// pass by pass from the stored passes, with dual.cuh's rules).
//
// The sweep: the forward pass runs the stages in S and keeps the state the
// outer loop carries at the start of each of the niter iterations (~13
// scalars, in local memory); the reverse pass walks the epilogue, then the
// iterations from the last to the first, each recomputed from its
// checkpoint, then the first guess and the prologue.  Nothing else is kept:
// no tape.  niter is at most kMaxIter.
//
// Each function follows its forward counterpart in flux_point.cuh and
// algos_point.cuh (turb_coare, turb_ecmwf, flux_point) expression by
// expression; the forward kernels do not include this file.

#pragma once

#include <cmath>
#include <type_traits>

#include "algos_point.cuh"
#include "dual.cuh"

namespace abt {
namespace adj {

// the most outer iterations the checkpoints hold (kernels/fused.py checks it)
constexpr int kMaxIter = 20;

// the per-point constants every stage reads: the arguments and the doubles
// the forward bodies compute from them
struct Ctx {
  const Params& p;
  double zt, zu, log_10, log_zt, log_zu, log_ztu, m_ztzu, rhr_sol;
  bool zt_eq_zu;
};

template <typename S, int M> struct Vec {
  S v[M];
  ABT_DI const S& operator[](int i) const { return v[i]; }
};

// the primal of a stage
template <int M, typename F, typename S, int N>
ABT_DI Vec<S, M> run(const F& f, const S (&x)[N]) {
  Vec<S, M> y;
  f(x, y.v);
  return y;
}

// *xb[j] += sum_i yb[i] * dy_i / dx_j at x: the stage on N tangents
template <typename F, typename S, int N, int M>
ABT_DI void vjp(const F& f, const S (&x)[N], const S (&yb)[M], S* const (&xb)[N]) {
  Dual<S, N> xd[N], yd[M];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    xd[j].v = x[j];
#pragma unroll
    for (int k = 0; k < N; ++k) xd[j].d[k] = j == k ? S(1) : S(0);
  }
  f(xd, yd);
#pragma unroll
  for (int j = 0; j < N; ++j) {
    S s = S(0);
#pragma unroll
    for (int i = 0; i < M; ++i) s += yb[i] * yd[i].d[j];
    *xb[j] += s;
  }
}

// a stage functor: name, input count, output count; the body reads x, k
// and writes y
#define ABT_STAGE(name, N, M)                                      \
  struct name {                                                    \
    const Ctx& k;                                                  \
    template <typename T>                                          \
    ABT_DI void operator()(const T (&x)[N], T (&y)[M]) const
#define ABT_STAGE_END };

// ---------------------------------------------------------------------------
// stages both solves share
// ---------------------------------------------------------------------------
// (hum, t_zt, slp) -> q_zt
ABT_STAGE(HumStage, 3, 1) { y[0] = q_air_of(k.p.humidity, x[0], x[1], x[2]); }
ABT_STAGE_END
// (U, V) -> wnd
ABT_STAGE(WindStage, 2, 1) { y[0] = m_sqrt(x[0] * x[0] + x[1] * x[1]); }
ABT_STAGE_END
// (slp, t_zt, q_zt) -> theta_zt
ABT_STAGE(ThetaStage, 3, 1) { y[0] = theta_from_z_p0_t_q(k.zt, x[0], x[1], x[2]); }
ABT_STAGE_END
// (sst, slp) -> the first T_s and q_s
ABT_STAGE(Surface0Stage, 2, 2) {
  const T T_s = x[0] - T(0.25);
  y[0] = T_s;
  y[1] = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), x[1]);
}
ABT_STAGE_END
// sst -> alpha
ABT_STAGE(AlphaStage, 1, 1) { y[0] = alpha_sw(x[0]); }
ABT_STAGE_END
// (xSST, a, b, slp) -> T_s = (xSST + a) + b and q_s: after the cool skin
// (a = dT_cs, b = dT_wl) and after the warm layer (a = dT_wl, b = dT_cs)
ABT_STAGE(SurfaceStage, 4, 2) {
  T T_s = x[0] + x[1];
  T_s = T_s + x[2];
  y[0] = T_s;
  y[1] = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), x[3]);
}
ABT_STAGE_END
// (t_zu, T_s, q_zu, q_s) -> (dt, dq)
ABT_STAGE(DeltaStage, 4, 2) {
  y[0] = nonzero_delta(x[0] - x[1], T(1.0e-9));
  y[1] = nonzero_delta(x[2] - x[3], T(1.0e-12));
}
ABT_STAGE_END

// update_qnsol_tau at x = (T_s, q_s, t_zu, q_zu, us, ts, qs, wnd, Ub, slp,
// rad_lw), cut in three: the transfer coefficients and the air density are
// stages (their clamps follow dual.cuh's rules), the products of the bulk
// formula are smooth and their adjoint is written out (qns_vjp)
// (T_s, q_s, t_zu, q_zu, us, ts, qs, Ub) -> (Cd, Ch, Ce)
ABT_STAGE(QnsCoefStage, 8, 3) {
  const T zdt = nonzero_delta(x[2] - x[0], T(1.0e-9));
  const T zdq = nonzero_delta(x[3] - x[1], T(1.0e-12));
  const T z0 = x[4] / x[7];
  y[0] = z0 * z0;
  y[1] = z0 * x[5] / zdt;
  y[2] = z0 * x[6] / zdq;
}
ABT_STAGE_END
// (t_zu, q_zu, slp) -> MAX(rho, 1) of the bulk formula
ABT_STAGE(RhoStage, 3, 1) {
  const T ta = x[0] - T(rgamma_dry * k.zu);
  const T den = T(R_dry) * ta * (T(1) + T(rctv0) * x[1]);
  T rho = maxp(x[2] / den, T(0.8));
  rho = maxp((x[2] - rho * T(grav) * T(k.zu)) / den, T(0.8));
  y[0] = maxp(rho, T(1));
}
ABT_STAGE_END

template <typename S> struct QnsFlux {
  Vec<S, 3> c;           // Cd, Ch, Ce
  S rhoc, Qns, Tau, Qlat;
};

template <typename S> ABT_DI QnsFlux<S> qns_fwd(const Ctx& k, const S (&x)[11]) {
  QnsFlux<S> q;
  q.c = run<3>(QnsCoefStage{k}, {x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[8]});
  q.rhoc = run<1>(RhoStage{k}, {x[2], x[3], x[9]})[0];
  const S Urho = x[8] * q.rhoc;
  q.Tau = Urho * q.c[0] * x[7];
  const S evap = Urho * q.c[2] * (x[3] - x[1]);
  const S Qsen = Urho * q.c[1] * (x[2] - x[0]) * cp_air(x[3]);
  q.Qlat = l_vap(x[0]) * evap;
  q.Qns = q.Qlat + Qsen + qlw_net(x[10], x[0]);
  return q;
}

// *xb[j] += the adjoint of x[j] from those of Qns, Tau and Qlat
template <typename S>
ABT_DI void qns_vjp(const Ctx& k, const S (&x)[11], const QnsFlux<S>& q, S bQns, S bTau,
                    S bQlat, S* const (&xb)[11]) {
  const S T_s = x[0], q_s = x[1], Thta = x[2], qa = x[3], wnd = x[7], Ub = x[8];
  const S Cd = q.c[0], Ch = q.c[1], Ce = q.c[2];
  const S Urho = Ub * q.rhoc;
  const S dq = qa - q_s, dth = Thta - T_s, cpa = cp_air(qa);
  const S evap = Urho * Ce * dq;
  const S bLat = bQns + bQlat;
  // Qlw = emiss (rad_lw - stefan T_s^4); Qlat = l_vap(T_s) evap
  S b_Ts = -bQns * S(4.0 * emiss_w * stefan) * (T_s * T_s * T_s) + bLat * evap * S(-0.00237e6);
  *xb[10] += bQns * S(emiss_w);
  const S b_evap = bLat * l_vap(T_s);
  // Qsen = Urho Ch dth cpa, evap = Urho Ce dq, Tau = Urho Cd wnd
  const S b_Urho = bQns * Ch * dth * cpa + b_evap * Ce * dq + bTau * Cd * wnd;
  const S b_dth = bQns * Urho * Ch * cpa;
  const S b_dq = b_evap * Urho * Ce;
  const S cb[3] = {bTau * Urho * wnd, bQns * Urho * dth * cpa, b_evap * Urho * dq};
  *xb[7] += bTau * Urho * Cd;
  *xb[8] += b_Urho * q.rhoc;
  b_Ts -= b_dth;
  *xb[0] += b_Ts;
  *xb[1] -= b_dq;
  *xb[2] += b_dth;
  *xb[3] += b_dq + bQns * Urho * Ch * dth * S(rCp_vap);
  vjp(RhoStage{k}, {Thta, qa, x[9]}, {b_Urho * Ub}, {xb[2], xb[3], xb[9]});
  vjp(QnsCoefStage{k}, {x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[8]}, cb,
      {xb[0], xb[1], xb[2], xb[3], xb[4], xb[5], xb[6], xb[8]});
}

// (Cd, Ch, Ce, t_zu, q_zu, Ub, T_s, q_s, wnd, U, V, slp) -> (QL, QH, Tau_x,
// Tau_y, Evap): the bulk formula and the stress split
ABT_STAGE(FluxStage, 12, 5) {
  const Turb<T> r{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7]};
  T out[6];
  flux_outputs(k.zu, r, x[8], x[9], x[10], x[11], out);
#pragma unroll
  for (int i = 0; i < 5; ++i) y[i] = out[i];
}
ABT_STAGE_END

// what the skin solve takes from the step (and, as adjoints, gives back)
template <typename S> struct SolveIn { S sst, T_s, q_s, theta_zt, q_zt, wnd, slp, Qsw, rad_lw; };
// the values an outer iteration reads and does not change
template <typename S> struct Inv { S wnd, theta_zt, q_zt, slp, Qsw, rad_lw, nu_a, alpha, xSST; };

template <typename S> ABT_DI void add_inv(SolveIn<S>& ib, const Inv<S>& vb) {
  ib.sst += vb.xSST;
  ib.theta_zt += vb.theta_zt;
  ib.q_zt += vb.q_zt;
  ib.wnd += vb.wnd;
  ib.slp += vb.slp;
  ib.Qsw += vb.Qsw;
  ib.rad_lw += vb.rad_lw;
}

// ---------------------------------------------------------------------------
// COARE 3.0 / 3.6 (flux_point.cuh::turb_coare with kSkin)
// ---------------------------------------------------------------------------
// (T_s, theta_zt, q_s, q_zt, wnd) -> first guess (us, ts, qs, t_zu, q_zu, Ub, z0)
template <bool kEcmwf> struct FirstGuessStage {
  const Ctx& k;
  template <typename T> ABT_DI void operator()(const T (&x)[5], T (&y)[7]) const {
    const T charn = kEcmwf ? T(CHARN0_ECMWF) : charn_of(k.p.charn_law, x[4]);
    const FirstGuess<T> g = first_guess_coare(k.zt, k.zu, k.zt_eq_zu, k.log_10, k.log_zt,
                                              k.log_zu, x[0], x[1], x[2], x[3], x[4], charn);
    y[0] = g.us; y[1] = g.ts; y[2] = g.qs; y[3] = g.t_zu; y[4] = g.q_zu; y[5] = g.Ub;
    y[6] = g.z0;
  }
};
// (z0, t_zu or theta_zt) -> (log_z0, nu_a)
ABT_STAGE(CoarePreStage, 2, 2) {
  y[0] = m_log(x[0]);
  y[1] = visc_air(x[1]);
}
ABT_STAGE_END
// (t_zu, q_zu, us, ts, qs) -> 1/L
ABT_STAGE(CoareOolStage, 5, 1) { y[0] = clip_mag(one_on_l(x[0], x[1], x[2], x[3], x[4]), T(200)); }
ABT_STAGE_END
// (us, 1/L, wnd) -> Ub
ABT_STAGE(CoareUbStage, 3, 1) {
  const T gust2 = T(k.p.beta0 * k.p.beta0) * (x[0] * x[0]) * pow23_pos(x[1] * T(M_ZI0_OV_K));
  y[0] = maxp(m_sqrt(x[2] * x[2] + gust2), T(0.2));
}
ABT_STAGE_END
// 1/L -> (psi_h(zeta_u), psi_m(zeta_u), psi_h(zeta_t))
ABT_STAGE(CoarePsiStage, 1, 3) {
  const T zeta_u = clip_mag(T(k.zu) * x[0], T(50));
  y[0] = psi_h_coare(zeta_u);
  y[1] = psi_m_coare(zeta_u);
  y[2] = k.zt_eq_zu ? T(0) : psi_h_coare(clip_mag(T(k.zt) * x[0], T(50)));
}
ABT_STAGE_END
// (us, log_z0, nu_a) -> (new log_z0, log_z0t)
ABT_STAGE(CoareZ0Stage, 3, 2) {
  const T us = x[0], nu_a = x[2];
  const T Un10 = us * T(INV_K) * (T(k.log_10) - x[1]);
  T z0 = charn_of(k.p.charn_law, Un10) * (us * us) * T(INV_G) + T(0.11) * nu_a / us;
  z0 = minp(maxp(m_abs(z0), T(1.0e-9)), T(1));
  y[0] = m_log(z0);
  T z0t = minp(T(k.p.z0t_coef) * pow_pos(nu_a / (z0 * us), T(k.p.z0t_pow)), T(k.p.z0t_max));
  z0t = minp(maxp(m_abs(z0t), T(1.0e-9)), T(1));
  y[1] = m_log(z0t);
}
ABT_STAGE_END
// (log_z0t, psi_h_u, dt, dq) -> (ts, qs)
ABT_STAGE(CoareScalesStage, 4, 2) {
  const T fac = T(vkarmn) / (T(k.log_zu) - x[0] - x[1]);
  y[0] = x[2] * fac;
  y[1] = x[3] * fac;
}
ABT_STAGE_END
// (Ub, log_z0, psi_m_u) -> us
ABT_STAGE(CoareUsStage, 3, 1) {
  y[0] = maxp(x[0] * T(vkarmn) / (T(k.log_zu) - x[1] - x[2]), T(1.0e-9));
}
ABT_STAGE_END
// (ts, qs, psi_h_u, psi_h_t, theta_zt, q_zt) -> (t_zu, q_zu)
ABT_STAGE(CoareHeightStage, 6, 2) {
  const T prf = T(k.log_zt - k.log_zu) + x[2] - x[3];
  y[0] = x[4] - x[0] * T(INV_K) * prf;
  y[1] = x[5] - x[1] * T(INV_K) * prf;
}
ABT_STAGE_END
// (Qsw, Qns, us, alpha, Qlat) -> dT_cs
ABT_STAGE(CoareCsStage, 5, 1) { y[0] = cs_coare(x[0], x[1], x[2], x[3], x[4]); }
ABT_STAGE_END
// (Qsw, Qns, Tau, alpha, state) -> new state
ABT_STAGE(CoareWlStage, 8, 4) {
  State<T> s{x[4], x[5], x[6], x[7]};
  wl_coare(x[0], x[1], x[2], x[3], T(k.rhr_sol), k.p.rdt, k.p.gdept, s);
  y[0] = s.dT_wl; y[1] = s.Hz_wl; y[2] = s.Qnt_ac; y[3] = s.Tau_ac;
}
ABT_STAGE_END
// (us, Ub, ts, qs, t_zu, T_s, q_zu, q_s) -> (Cd, Ch, Ce)
ABT_STAGE(CoareCoefStage, 8, 3) {
  const T dt = nonzero_delta(x[4] - x[5], T(1.0e-9));
  const T dq = nonzero_delta(x[6] - x[7], T(1.0e-12));
  const T r = x[0] / x[1];
  y[0] = maxp(r * r, T(Cx_min));
  y[1] = maxp(r * x[2] / dt, T(Cx_min));
  y[2] = maxp(r * x[3] / dq, T(Cx_min));
}
ABT_STAGE_END

template <typename S> struct CoareCarry { S us, ts, qs, t_zu, q_zu, Ub, log_z0, T_s, q_s; State<S> st; };

// Iteration jit of the COARE loop from the carry c.  !kRev: c becomes the
// carry at its end.  kRev: *cb holds the adjoint of the carry at its end and
// becomes that at its start; the invariants' adjoints add into *vb.
template <bool kRev, typename S>
ABT_DI void coare_iter(const Ctx& k, int jit, const Inv<S>& v, CoareCarry<S>& c,
                       CoareCarry<S>* cb, Inv<S>* vb) {
  const bool wl = k.p.niter % jit == 0;
  const Vec<S, 2> d = run<2>(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s});
  const S ool = run<1>(CoareOolStage{k}, {c.t_zu, c.q_zu, c.us, c.ts, c.qs})[0];
  const S Ub = run<1>(CoareUbStage{k}, {c.us, ool, v.wnd})[0];
  const Vec<S, 3> psi = run<3>(CoarePsiStage{k}, {ool});
  const Vec<S, 2> z = run<2>(CoareZ0Stage{k}, {c.us, c.log_z0, v.nu_a});
  const Vec<S, 2> sc = run<2>(CoareScalesStage{k}, {z[1], psi[0], d[0], d[1]});
  const S us = run<1>(CoareUsStage{k}, {Ub, z[0], psi[1]})[0];
  const S hx[6] = {sc[0], sc[1], psi[0], psi[2], v.theta_zt, v.q_zt};
  Vec<S, 2> h{{c.t_zu, c.q_zu}};
  if (!k.zt_eq_zu) h = run<2>(CoareHeightStage{k}, hx);

  // cool skin
  const S qx1[11] = {c.T_s, c.q_s, h[0], h[1], us, sc[0], sc[1], v.wnd, Ub, v.slp, v.rad_lw};
  const QnsFlux<S> q1 = qns_fwd(k, qx1);
  const S dT_cs = run<1>(CoareCsStage{k}, {v.Qsw, q1.Qns, us, v.alpha, q1.Qlat})[0];
  const Vec<S, 2> s1 = run<2>(SurfaceStage{k}, {v.xSST, dT_cs, c.st.dT_wl, v.slp});

  // warm layer: commits on every iteration that divides niter
  S qx2[11] = {s1[0], s1[1], h[0], h[1], us, sc[0], sc[1], v.wnd, Ub, v.slp, v.rad_lw};
  QnsFlux<S> q2{};
  Vec<S, 2> s2 = s1;
  State<S> st = c.st;
  if (wl) {
    q2 = qns_fwd(k, qx2);
    const Vec<S, 4> w = run<4>(CoareWlStage{k}, {v.Qsw, q2.Qns, q2.Tau, v.alpha, c.st.dT_wl,
                                                 c.st.Hz_wl, c.st.Qnt_ac, c.st.Tau_ac});
    st = State<S>{w[0], w[1], w[2], w[3]};
    s2 = run<2>(SurfaceStage{k}, {v.xSST, st.dT_wl, dT_cs, v.slp});
  }
  if constexpr (!kRev) {
    c = CoareCarry<S>{us, sc[0], sc[1], h[0], h[1], Ub, z[0], s2[0], s2[1], st};
  } else {
    const CoareCarry<S> b = *cb;
    const S O = S(0);
    S b_us = b.us, b_ts = b.ts, b_qs = b.qs, b_tzu = b.t_zu, b_qzu = b.q_zu, b_Ub = b.Ub;
    S b_lz0 = b.log_z0, b_dTcs = O, b_Ts1 = b.T_s, b_qs1 = b.q_s;
    State<S> b_st = b.st;                 // of the state at the start
    if (wl) {
      S b_dTwl = b.st.dT_wl, b_Qns2 = O, b_Tau2 = O;
      vjp(SurfaceStage{k}, {v.xSST, st.dT_wl, dT_cs, v.slp}, {b.T_s, b.q_s},
          {&vb->xSST, &b_dTwl, &b_dTcs, &vb->slp});
      b_st = State<S>{O, O, O, O};
      vjp(CoareWlStage{k}, {v.Qsw, q2.Qns, q2.Tau, v.alpha, c.st.dT_wl, c.st.Hz_wl, c.st.Qnt_ac,
                            c.st.Tau_ac},
          {b_dTwl, b.st.Hz_wl, b.st.Qnt_ac, b.st.Tau_ac},
          {&vb->Qsw, &b_Qns2, &b_Tau2, &vb->alpha, &b_st.dT_wl, &b_st.Hz_wl, &b_st.Qnt_ac,
           &b_st.Tau_ac});
      b_Ts1 = O;
      b_qs1 = O;
      qns_vjp(k, qx2, q2, b_Qns2, b_Tau2, O,
          {&b_Ts1, &b_qs1, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
           &vb->rad_lw});
    }
    S b_Qns1 = O, b_Qlat1 = O, b_Ts0 = O, b_qs0 = O;
    vjp(SurfaceStage{k}, {v.xSST, dT_cs, c.st.dT_wl, v.slp}, {b_Ts1, b_qs1},
        {&vb->xSST, &b_dTcs, &b_st.dT_wl, &vb->slp});
    vjp(CoareCsStage{k}, {v.Qsw, q1.Qns, us, v.alpha, q1.Qlat}, {b_dTcs},
        {&vb->Qsw, &b_Qns1, &b_us, &vb->alpha, &b_Qlat1});
    qns_vjp(k, qx1, q1, b_Qns1, O, b_Qlat1,
        {&b_Ts0, &b_qs0, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
         &vb->rad_lw});

    S b_tzu0 = O, b_qzu0 = O, b_psih = O, b_psim = O, b_psit = O;
    if (!k.zt_eq_zu) {
      vjp(CoareHeightStage{k}, hx, {b_tzu, b_qzu},
          {&b_ts, &b_qs, &b_psih, &b_psit, &vb->theta_zt, &vb->q_zt});
    } else {
      b_tzu0 = b_tzu;
      b_qzu0 = b_qzu;
    }
    S b_lz0t = O, b_dt = O, b_dq = O, b_us0 = O, b_lz00 = O, b_ool = O, b_ts0 = O, b_qstar0 = O;
    vjp(CoareUsStage{k}, {Ub, z[0], psi[1]}, {b_us}, {&b_Ub, &b_lz0, &b_psim});
    vjp(CoareScalesStage{k}, {z[1], psi[0], d[0], d[1]}, {b_ts, b_qs},
        {&b_lz0t, &b_psih, &b_dt, &b_dq});
    vjp(CoareZ0Stage{k}, {c.us, c.log_z0, v.nu_a}, {b_lz0, b_lz0t},
        {&b_us0, &b_lz00, &vb->nu_a});
    vjp(CoarePsiStage{k}, {ool}, {b_psih, b_psim, b_psit}, {&b_ool});
    vjp(CoareUbStage{k}, {c.us, ool, v.wnd}, {b_Ub}, {&b_us0, &b_ool, &vb->wnd});
    vjp(CoareOolStage{k}, {c.t_zu, c.q_zu, c.us, c.ts, c.qs}, {b_ool},
        {&b_tzu0, &b_qzu0, &b_us0, &b_ts0, &b_qstar0});
    vjp(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s}, {b_dt, b_dq},
        {&b_tzu0, &b_Ts0, &b_qzu0, &b_qs0});
    *cb = CoareCarry<S>{b_us0, b_ts0, b_qstar0, b_tzu0, b_qzu0, O, b_lz00, b_Ts0, b_qs0, b_st};
  }
}

// The COARE skin solve's adjoint: ib (the adjoints of in) gets what flows
// back through the solve, stb goes in as the adjoint of the new state and
// comes out as that of the state in.  outer(r) is called between the sweeps
// with the solve's result and returns its adjoint.
struct CoareSkinVjp {
  template <typename S, typename Outer>
  ABT_DI void operator()(const Ctx& k, const SolveIn<S>& in, const State<S>& st0,
                         SolveIn<S>& ib, State<S>& stb, const Outer& outer) const {
    const S alpha = run<1>(AlphaStage{k}, {in.sst})[0];
    const S fx[5] = {in.T_s, in.theta_zt, in.q_s, in.q_zt, in.wnd};
    const Vec<S, 7> fg = run<7>(FirstGuessStage<false>{k}, fx);
    const S visc_t = k.p.visc_at_tzu ? fg[3] : in.theta_zt;
    const Vec<S, 2> pre = run<2>(CoarePreStage{k}, {fg[6], visc_t});
    const Inv<S> v{in.wnd, in.theta_zt, in.q_zt, in.slp, in.Qsw, in.rad_lw, pre[1], alpha,
                   in.sst};
    CoareCarry<S> c{fg[0], fg[1], fg[2], fg[3], fg[4], fg[5], pre[0], in.T_s, in.q_s, st0};
    CoareCarry<S> ck[kMaxIter];
#pragma unroll 1
    for (int jit = 1; jit <= k.p.niter; ++jit) {
      ck[jit - 1] = c;
      coare_iter<false>(k, jit, v, c, static_cast<CoareCarry<S>*>(nullptr),
                        static_cast<Inv<S>*>(nullptr));
    }
    const S cx[8] = {c.us, c.Ub, c.ts, c.qs, c.t_zu, c.T_s, c.q_zu, c.q_s};
    const Vec<S, 3> cf = run<3>(CoareCoefStage{k}, cx);
    const Turb<S> rb = outer(Turb<S>{cf[0], cf[1], cf[2], c.t_zu, c.q_zu, c.Ub, c.T_s, c.q_s});

    const S O = S(0);
    CoareCarry<S> cb{O, O, O, rb.t_zu, rb.q_zu, rb.Ub, O, rb.T_s, rb.q_s, stb};
    vjp(CoareCoefStage{k}, cx, {rb.Cd, rb.Ch, rb.Ce},
        {&cb.us, &cb.Ub, &cb.ts, &cb.qs, &cb.t_zu, &cb.T_s, &cb.q_zu, &cb.q_s});
    Inv<S> vb{O, O, O, O, O, O, O, O, O};
#pragma unroll 1
    for (int jit = k.p.niter; jit >= 1; --jit) {
      CoareCarry<S> cj = ck[jit - 1];
      coare_iter<true>(k, jit, v, cj, &cb, &vb);
    }
    stb = cb.st;
    S b_z0 = O, b_visc = O;
    vjp(CoarePreStage{k}, {fg[6], visc_t}, {cb.log_z0, vb.nu_a}, {&b_z0, &b_visc});
    S fb[7] = {cb.us, cb.ts, cb.qs, cb.t_zu, cb.q_zu, cb.Ub, b_z0};
    if (k.p.visc_at_tzu) fb[3] += b_visc;
    else ib.theta_zt += b_visc;
    ib.T_s += cb.T_s;
    ib.q_s += cb.q_s;
    vjp(FirstGuessStage<false>{k}, fx, fb, {&ib.T_s, &ib.theta_zt, &ib.q_s, &ib.q_zt, &ib.wnd});
    vjp(AlphaStage{k}, {in.sst}, {vb.alpha}, {&ib.sst});
    add_inv(ib, vb);
  }
};

// ---------------------------------------------------------------------------
// ECMWF (algos_point.cuh::turb_ecmwf with kSkin)
// ---------------------------------------------------------------------------
// theta_zt -> nu_a
ABT_STAGE(ViscStage, 1, 1) { y[0] = visc_air(x[0]); }
ABT_STAGE_END
// (t_zu, q_zu, us, ts, qs, z0) of the first guess -> (log_z0, Fm, Fh, psi_h_u)
ABT_STAGE(EcmwfPreStage, 6, 4) {
  const T log_z0 = m_log(x[5]);
  const T one_on_L = one_on_l(x[0], x[1], x[2], x[3], x[4]);
  const T zeta_u = T(k.zu) * one_on_L;
  T z0t = T(1) / (T(0.1) * m_exp(T(vkarmn) / (T(0.00115) / (T(vkarmn) / (T(k.log_10) - log_z0)))));
  z0t = minp(maxp(m_abs(z0t), T(1.0e-9)), T(1));
  const T log_z0t = m_log(z0t);
  const T psi_h_u = psi_h_ecmwf(zeta_u);
  y[0] = log_z0;
  y[1] = T(k.log_zu) - log_z0 - psi_m_ecmwf(zeta_u) + psi_m_ecmwf(x[5] * one_on_L);
  y[2] = T(k.log_zu) - log_z0t - psi_h_u + psi_h_ecmwf(z0t * one_on_L);
  y[3] = psi_h_u;
}
ABT_STAGE_END
// (T_s, t_zu, q_s, q_zu, Ub, Fm, Fh) -> 1/L (IFS Eq. 3.23)
ABT_STAGE(EcmwfOolStage, 7, 1) {
  const T Rib = ri_bulk(k.zu, x[0], x[1], x[2], x[3], x[4]);
  y[0] = clip_mag(Rib * x[5] * x[5] / x[6] * T(1.0 / k.zu), T(200));
}
ABT_STAGE_END
// 1/L -> (psi_m(zeta_u), psi_h(zeta_u), psi_h(zeta_t))
ABT_STAGE(EcmwfPsiStage, 1, 3) {
  const T zeta_u = T(k.zu) * x[0];
  y[0] = psi_m_ecmwf(zeta_u);
  y[1] = psi_h_ecmwf(zeta_u);
  y[2] = psi_h_ecmwf(T(k.zt) * x[0]);
}
ABT_STAGE_END
// (log_z0, psi_m_u, z0, 1/L) -> Fm
ABT_STAGE(EcmwfFmStage, 4, 1) { y[0] = T(k.log_zu) - x[0] - x[1] + psi_m_ecmwf(x[2] * x[3]); }
ABT_STAGE_END
// (Ub, Fm, nu_a) -> (us, z0, z0t, z0q, log_z0, log_z0t, log_z0q)
ABT_STAGE(EcmwfRoughStage, 3, 7) {
  const T us = x[0] * T(vkarmn) / x[1];
  const T us2 = us * us;
  const T nu_on_us = x[2] / us;
  const T z0 = minp(m_abs(T(0.11) * nu_on_us + us2 * T(CHARN0_OV_G)), T(0.001));
  const T z0t = minp(m_abs(T(0.40) * nu_on_us), T(0.001));
  const T z0q = minp(m_abs(T(0.62) * nu_on_us), T(0.001));
  y[0] = us; y[1] = z0; y[2] = z0t; y[3] = z0q;
  y[4] = m_log(z0); y[5] = m_log(z0t); y[6] = m_log(z0q);
}
ABT_STAGE_END
// (z, 1/L) -> psi_m(z / L) or psi_h(z / L)
ABT_STAGE(EcmwfPsiMzStage, 2, 1) { y[0] = psi_m_ecmwf(x[0] * x[1]); }
ABT_STAGE_END
ABT_STAGE(EcmwfPsiHzStage, 2, 1) { y[0] = psi_h_ecmwf(x[0] * x[1]); }
ABT_STAGE_END
// (us, 1/L, wnd) -> Ub (gustiness, beta0 = 1)
ABT_STAGE(EcmwfUbStage, 3, 1) {
  const T gust2 = T(1.0 * 1.0) * (x[0] * x[0]) * pow23_pos(x[1] * T(M_ZI0_OV_K_ECMWF));
  y[0] = maxp(m_sqrt(x[2] * x[2] + gust2), T(0.2));
}
ABT_STAGE_END
// (dt or dq, log_z0t or log_z0q, psi_h_u, psi_h_z0t or psi_h_z0q, psi_h_t,
// t_zt or q_zt) -> (ts, t_zu) or (qs, q_zu); humidity is floored at 0
template <bool kHum> struct EcmwfScalarStage {
  const Ctx& k;
  template <typename T> ABT_DI void operator()(const T (&x)[6], T (&y)[2]) const {
    const T dpsi = x[2] - x[3];
    const T s = x[0] * T(vkarmn) / (T(k.log_zu) - x[1] - dpsi);
    const T a = x[5] - T(k.m_ztzu) * s * T(INV_K) * (T(k.log_ztu) + dpsi - x[4] + x[3]);
    y[0] = s;
    y[1] = kHum ? maxp(a, T(0)) : a;
  }
};
// (log_z0, psi_m_u, psi_m_z0, log_z0t, psi_h_u, psi_h_z0t) -> (Fm, Fh)
ABT_STAGE(EcmwfFStage, 6, 2) {
  y[0] = T(k.log_zu) - x[0] - x[1] + x[2];
  y[1] = T(k.log_zu) - x[3] - x[4] + x[5];
}
ABT_STAGE_END
// (Qsw, Qns, us, alpha) -> dT_cs
ABT_STAGE(EcmwfCsStage, 4, 1) { y[0] = cs_ecmwf(x[0], x[1], x[2], x[3]); }
ABT_STAGE_END
// wl_ecmwf in two parts.  (Qsw, Qns, us, alpha, dT_wl, Hz_wl) -> what its
// 10-pass solve reads: (dTwl_b, zA, cst2, cst3, L2, tcorr, wf)
ABT_STAGE(EcmwfWlPreStage, 6, 7) {
  constexpr double rhocp_w = rho0_w * rCp0_w;
  const T Hwl = x[5];
  const T flg = step(T(k.p.gdept) - Hwl);
  const T tcorr = flg + (T(1) - flg) * T(k.p.gdept) / Hwl;
  const T fr = T(1) - T(0.28) * m_exp(T(-71.5) * Hwl) - T(0.27) * m_exp(T(-2.8) * Hwl)
               - T(0.45) * m_exp(T(-0.07) * Hwl);
  const T Qabs = fr * x[0] + x[1];
  const T usw = maxp(x[2], T(1.0e-4)) * T(sq_radrw);
  const T usw2 = usw * usw;
  const T cst1 = T(vkarmn * grav) * x[3];
  const T cst0 = T(k.p.rdt * (RNUWL0 + 1.0)) / Hwl;
  y[0] = maxp(x[4] / tcorr, T(0));
  y[1] = cst0 * Qabs / T(RNUWL0 * rhocp_w);
  y[2] = cst1 / (T(5) * Hwl * usw2);
  y[3] = -cst0 * T(vkarmn) * usw * T(FLA_ECMWF);
  y[4] = cst1 * Qabs / (T(rhocp_w) * usw2 * usw);
  y[5] = tcorr;
  y[6] = step(Qabs);
}
ABT_STAGE_END

// The 10-pass solve on S from w = the pre-stage's values, keeping d[i], the
// value at the start of pass i (d[10] the last); returns the new dT_wl.
template <typename S> ABT_DI S wl_ecmwf_solve(const S (&w)[7], S Hwl, S (&d)[11]) {
  d[0] = w[0];
#pragma unroll 1
  for (int it = 0; it < 10; ++it) {
    const S dn = S(0.5) * (d[it] + w[0]);
    const S y = dn * w[2];
    const bool pos = y > S(0);
    const S L1 = pos ? m_sqrt(pos ? y : S(1)) : S(0);
    const S zeta = (S(1) - w[6]) * Hwl * L1 + w[6] * Hwl * w[4];
    const S zB = w[3] / phi_takaya(zeta);
    d[it + 1] = maxp(w[0] + w[1] + zB * dn, S(0));
  }
  return d[10] * w[5];
}

// Its adjoint, written out pass by pass from the adjoint bout of the new
// dT_wl: adds into wb (w's adjoints) and bHwl.  The rules are dual.cuh's:
// half the adjoint through MAX(., 0) at a tie, none through the guarded
// branch of the root, phi_takaya's derivative from its duals.
template <typename S>
ABT_DI void wl_ecmwf_solve_vjp(const S (&w)[7], S Hwl, const S (&d)[11], S bout, S (&wb)[7],
                               S& bHwl) {
  wb[5] += bout * d[10];
  S bd = bout * w[5];
#pragma unroll 1
  for (int it = 9; it >= 0; --it) {
    const S dn = S(0.5) * (d[it] + w[0]);
    const S y = dn * w[2];
    const bool pos = y > S(0);
    const S L1 = pos ? m_sqrt(pos ? y : S(1)) : S(0);
    Dual<S, 1> zeta;
    zeta.v = (S(1) - w[6]) * Hwl * L1 + w[6] * Hwl * w[4];
    zeta.d[0] = S(1);
    const Dual<S, 1> ph = phi_takaya(zeta);
    const S zB = w[3] / ph.v;
    const S a = w[0] + w[1] + zB * dn;
    const S ba = (a != a || a > S(0)) ? bd : (a == S(0) ? S(0.5) * bd : S(0));
    wb[0] += ba;
    wb[1] += ba;
    const S bzB = ba * dn;
    S bdn = ba * zB;
    wb[3] += bzB / ph.v;
    const S bzeta = -bzB * zB / ph.v * ph.d[0];
    bHwl += bzeta * ((S(1) - w[6]) * L1 + w[6] * w[4]);
    wb[4] += bzeta * w[6] * Hwl;
    const S by = pos ? bzeta * (S(1) - w[6]) * Hwl * (S(0.5) / L1) : S(0);
    bdn += by * w[2];
    wb[2] += by * dn;
    bd = S(0.5) * bdn;
    wb[0] += S(0.5) * bdn;
  }
  wb[0] += bd;
}
// (Fm, Fh, log_z0q, psi_h_u, psi_h_z0q) -> (Cd, Ch, Ce)
ABT_STAGE(EcmwfCoefStage, 5, 3) {
  const T Fq = T(k.log_zu) - x[2] - x[3] + x[4];
  y[0] = maxp(T(vkarmn2) / (x[0] * x[0]), T(Cx_min));
  y[1] = maxp(T(vkarmn2) / (x[0] * x[1]), T(Cx_min));
  y[2] = maxp(T(vkarmn2) / (x[0] * Fq), T(Cx_min));
}
ABT_STAGE_END

template <typename S> struct EcmwfCarry {
  S t_zu, q_zu, Ub, z0, log_z0, T_s, q_s, Fm, Fh, log_z0q, psi_h_u, psi_h_z0q;
  State<S> st;
};

// Iteration of the ECMWF loop: as coare_iter.  Hz_wl, Qnt_ac and Tau_ac pass
// through unchanged.
template <bool kRev, typename S>
ABT_DI void ecmwf_iter(const Ctx& k, const Inv<S>& v, EcmwfCarry<S>& c, EcmwfCarry<S>* cb,
                       Inv<S>* vb) {
  const Vec<S, 2> d = run<2>(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s});
  const S ox[7] = {c.T_s, c.t_zu, c.q_s, c.q_zu, c.Ub, c.Fm, c.Fh};
  const S ool = run<1>(EcmwfOolStage{k}, ox)[0];
  const Vec<S, 3> psi = run<3>(EcmwfPsiStage{k}, {ool});    // psi_m_u, psi_h_u, psi_h_t
  const S Fm1 = run<1>(EcmwfFmStage{k}, {c.log_z0, psi[0], c.z0, ool})[0];
  const Vec<S, 7> rg = run<7>(EcmwfRoughStage{k}, {c.Ub, Fm1, v.nu_a});
  const S pm_z0 = run<1>(EcmwfPsiMzStage{k}, {rg[1], ool})[0];
  const S ph_z0t = run<1>(EcmwfPsiHzStage{k}, {rg[2], ool})[0];
  const S ph_z0q = run<1>(EcmwfPsiHzStage{k}, {rg[3], ool})[0];
  const S Ub = run<1>(EcmwfUbStage{k}, {rg[0], ool, v.wnd})[0];
  const S tx[6] = {d[0], rg[5], psi[1], ph_z0t, psi[2], v.theta_zt};
  const S qx[6] = {d[1], rg[6], psi[1], ph_z0q, psi[2], v.q_zt};
  const Vec<S, 2> tt = run<2>(EcmwfScalarStage<false>{k}, tx);     // ts, t_zu
  const Vec<S, 2> qq = run<2>(EcmwfScalarStage<true>{k}, qx);      // qs, q_zu
  const S Fx[6] = {rg[4], psi[0], pm_z0, rg[5], psi[1], ph_z0t};
  const Vec<S, 2> F = run<2>(EcmwfFStage{k}, Fx);

  // cool skin, then the warm layer (commits on every iteration)
  const S qx1[11] = {c.T_s, c.q_s, tt[1], qq[1], rg[0], tt[0], qq[0], v.wnd, Ub, v.slp,
                     v.rad_lw};
  const QnsFlux<S> q1 = qns_fwd(k, qx1);
  const S Qns1 = q1.Qns;
  const S dT_cs = run<1>(EcmwfCsStage{k}, {v.Qsw, Qns1, rg[0], v.alpha})[0];
  const Vec<S, 2> s1 = run<2>(SurfaceStage{k}, {v.xSST, dT_cs, c.st.dT_wl, v.slp});
  const S qx2[11] = {s1[0], s1[1], tt[1], qq[1], rg[0], tt[0], qq[0], v.wnd, Ub, v.slp,
                     v.rad_lw};
  const QnsFlux<S> q2 = qns_fwd(k, qx2);
  const S Qns2 = q2.Qns;
  const S wx[6] = {v.Qsw, Qns2, rg[0], v.alpha, c.st.dT_wl, c.st.Hz_wl};
  const Vec<S, 7> wp = run<7>(EcmwfWlPreStage{k}, wx);
  S wd[11];
  const S dT_wl = wl_ecmwf_solve(wp.v, c.st.Hz_wl, wd);
  const Vec<S, 2> s2 = run<2>(SurfaceStage{k}, {v.xSST, dT_wl, dT_cs, v.slp});

  if constexpr (!kRev) {
    c = EcmwfCarry<S>{tt[1], qq[1], Ub, rg[1], rg[4], s2[0], s2[1], F[0], F[1], rg[6], psi[1],
                      ph_z0q, State<S>{dT_wl, c.st.Hz_wl, c.st.Qnt_ac, c.st.Tau_ac}};
  } else {
    const EcmwfCarry<S> b = *cb;
    const S O = S(0);
    S b_dTwl = b.st.dT_wl, b_dTcs = O, b_Qns2 = O, b_us = O, b_Ts1 = O, b_qs1 = O;
    State<S> b_st{O, b.st.Hz_wl, b.st.Qnt_ac, b.st.Tau_ac};
    S b_tzu = b.t_zu, b_qzu = b.q_zu, b_ts = O, b_qs = O, b_Ub = b.Ub;
    vjp(SurfaceStage{k}, {v.xSST, dT_wl, dT_cs, v.slp}, {b.T_s, b.q_s},
        {&vb->xSST, &b_dTwl, &b_dTcs, &vb->slp});
    S wb[7] = {O, O, O, O, O, O, O};
    wl_ecmwf_solve_vjp(wp.v, c.st.Hz_wl, wd, b_dTwl, wb, b_st.Hz_wl);
    vjp(EcmwfWlPreStage{k}, wx, wb,
        {&vb->Qsw, &b_Qns2, &b_us, &vb->alpha, &b_st.dT_wl, &b_st.Hz_wl});
    qns_vjp(k, qx2, q2, b_Qns2, O, O,
        {&b_Ts1, &b_qs1, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
         &vb->rad_lw});
    S b_Qns1 = O, b_Ts0 = O, b_qs0 = O;
    vjp(SurfaceStage{k}, {v.xSST, dT_cs, c.st.dT_wl, v.slp}, {b_Ts1, b_qs1},
        {&vb->xSST, &b_dTcs, &b_st.dT_wl, &vb->slp});
    vjp(EcmwfCsStage{k}, {v.Qsw, Qns1, rg[0], v.alpha}, {b_dTcs},
        {&vb->Qsw, &b_Qns1, &b_us, &vb->alpha});
    qns_vjp(k, qx1, q1, b_Qns1, O, O,
        {&b_Ts0, &b_qs0, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
         &vb->rad_lw});

    S b_lz0 = b.log_z0, b_psim = O, b_pmz0 = O, b_lz0t = O, b_psih = b.psi_h_u, b_phz0t = O;
    S b_dt = O, b_dq = O, b_lz0q = b.log_z0q, b_phz0q = b.psi_h_z0q, b_psit = O, b_ool = O;
    vjp(EcmwfFStage{k}, Fx, {b.Fm, b.Fh},
        {&b_lz0, &b_psim, &b_pmz0, &b_lz0t, &b_psih, &b_phz0t});
    vjp(EcmwfScalarStage<true>{k}, qx, {b_qs, b_qzu},
        {&b_dq, &b_lz0q, &b_psih, &b_phz0q, &b_psit, &vb->q_zt});
    vjp(EcmwfScalarStage<false>{k}, tx, {b_ts, b_tzu},
        {&b_dt, &b_lz0t, &b_psih, &b_phz0t, &b_psit, &vb->theta_zt});
    vjp(EcmwfUbStage{k}, {rg[0], ool, v.wnd}, {b_Ub}, {&b_us, &b_ool, &vb->wnd});
    S b_z0 = b.z0, b_z0t = O, b_z0q = O;
    vjp(EcmwfPsiHzStage{k}, {rg[3], ool}, {b_phz0q}, {&b_z0q, &b_ool});
    vjp(EcmwfPsiHzStage{k}, {rg[2], ool}, {b_phz0t}, {&b_z0t, &b_ool});
    vjp(EcmwfPsiMzStage{k}, {rg[1], ool}, {b_pmz0}, {&b_z0, &b_ool});
    S b_Ub0 = O, b_Fm1 = O;
    vjp(EcmwfRoughStage{k}, {c.Ub, Fm1, v.nu_a}, {b_us, b_z0, b_z0t, b_z0q, b_lz0, b_lz0t, b_lz0q},
        {&b_Ub0, &b_Fm1, &vb->nu_a});
    S b_lz00 = O, b_z00 = O, b_tzu0 = O, b_qzu0 = O, b_Fm0 = O, b_Fh0 = O;
    vjp(EcmwfFmStage{k}, {c.log_z0, psi[0], c.z0, ool}, {b_Fm1},
        {&b_lz00, &b_psim, &b_z00, &b_ool});
    vjp(EcmwfPsiStage{k}, {ool}, {b_psim, b_psih, b_psit}, {&b_ool});
    vjp(EcmwfOolStage{k}, ox, {b_ool},
        {&b_Ts0, &b_tzu0, &b_qs0, &b_qzu0, &b_Ub0, &b_Fm0, &b_Fh0});
    vjp(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s}, {b_dt, b_dq},
        {&b_tzu0, &b_Ts0, &b_qzu0, &b_qs0});
    *cb = EcmwfCarry<S>{b_tzu0, b_qzu0, b_Ub0, b_z00, b_lz00, b_Ts0, b_qs0, b_Fm0, b_Fh0,
                        O, O, O, b_st};
  }
}

struct EcmwfSkinVjp {
  template <typename S, typename Outer>
  ABT_DI void operator()(const Ctx& k, const SolveIn<S>& in, const State<S>& st0,
                         SolveIn<S>& ib, State<S>& stb, const Outer& outer) const {
    const S alpha = run<1>(AlphaStage{k}, {in.sst})[0];
    const S fx[5] = {in.T_s, in.theta_zt, in.q_s, in.q_zt, in.wnd};
    const Vec<S, 7> fg = run<7>(FirstGuessStage<true>{k}, fx);
    const S nu_a = run<1>(ViscStage{k}, {in.theta_zt})[0];
    const S px[6] = {fg[3], fg[4], fg[0], fg[1], fg[2], fg[6]};
    const Vec<S, 4> pre = run<4>(EcmwfPreStage{k}, px);
    const Inv<S> v{in.wnd, in.theta_zt, in.q_zt, in.slp, in.Qsw, in.rad_lw, nu_a, alpha, in.sst};
    const S O = S(0);
    EcmwfCarry<S> c{fg[3], fg[4], fg[5], fg[6], pre[0], in.T_s, in.q_s, pre[1], pre[2], O,
                    pre[3], O, st0};
    EcmwfCarry<S> ck[kMaxIter];
#pragma unroll 1
    for (int it = 0; it < k.p.niter; ++it) {
      ck[it] = c;
      ecmwf_iter<false>(k, v, c, static_cast<EcmwfCarry<S>*>(nullptr),
                        static_cast<Inv<S>*>(nullptr));
    }
    const S cx[5] = {c.Fm, c.Fh, c.log_z0q, c.psi_h_u, c.psi_h_z0q};
    const Vec<S, 3> cf = run<3>(EcmwfCoefStage{k}, cx);
    const Turb<S> rb = outer(Turb<S>{cf[0], cf[1], cf[2], c.t_zu, c.q_zu, c.Ub, c.T_s, c.q_s});

    EcmwfCarry<S> cb{rb.t_zu, rb.q_zu, rb.Ub, O, O, rb.T_s, rb.q_s, O, O, O, O, O, stb};
    vjp(EcmwfCoefStage{k}, cx, {rb.Cd, rb.Ch, rb.Ce},
        {&cb.Fm, &cb.Fh, &cb.log_z0q, &cb.psi_h_u, &cb.psi_h_z0q});
    Inv<S> vb{O, O, O, O, O, O, O, O, O};
#pragma unroll 1
    for (int it = k.p.niter - 1; it >= 0; --it) {
      EcmwfCarry<S> cj = ck[it];
      ecmwf_iter<true>(k, v, cj, &cb, &vb);
    }
    stb = cb.st;
    S fb[7] = {O, O, O, cb.t_zu, cb.q_zu, cb.Ub, cb.z0};
    vjp(EcmwfPreStage{k}, px, {cb.log_z0, cb.Fm, cb.Fh, cb.psi_h_u},
        {&fb[3], &fb[4], &fb[0], &fb[1], &fb[2], &fb[6]});
    ib.T_s += cb.T_s;
    ib.q_s += cb.q_s;
    vjp(FirstGuessStage<true>{k}, fx, fb, {&ib.T_s, &ib.theta_zt, &ib.q_s, &ib.q_zt, &ib.wnd});
    vjp(ViscStage{k}, {in.theta_zt}, {vb.nu_a}, {&ib.theta_zt});
    vjp(AlphaStage{k}, {in.sst}, {vb.alpha}, {&ib.sst});
    add_inv(ib, vb);
  }
};

template <typename Solve> struct SkinVjp;
template <> struct SkinVjp<CoareSkin> { using type = CoareSkinVjp; };
template <> struct SkinVjp<EcmwfSkin> { using type = EcmwfSkinVjp; };

#undef ABT_STAGE
#undef ABT_STAGE_END

// ---------------------------------------------------------------------------
// the step: flux_point's VJP
// ---------------------------------------------------------------------------
// x = (sst t_zt hum_zt U_zu V_zu slp rad_sw rad_lw lon, dT_wl Hz_wl Qnt_ac
// Tau_ac), ct = the cotangents of (QL QH Tau_x Tau_y Evap T_s, new dT_wl
// Hz_wl Qnt_ac Tau_ac), g = the 13 gradients.  lon reaches the step only
// through trunc and comparisons (the solar clock of the COARE warm layer),
// so its gradient is 0.
template <typename Solve, typename S>
ABT_DI void flux_point_vjp(const S (&x)[13], const S (&ct)[10], S (&g)[13], const Params& p) {
  const S sst = x[0], t_zt = x[1], hum = x[2], U = x[3], V = x[4], slp = x[5];
  const S rad_sw = x[6], rad_lw = x[7], lon = x[8];
  const double zt = p.zt, zu = p.zu;
  const Ctx k{p, zt, zu, log(10.0), log(zt), log(zu), log(zt / zu),
              fabs(zu - zt) < 0.01 ? 0.0 : 1.0,
              static_cast<double>(local_solar_seconds(lon, p.isecday_utc) / S(3600)),
              fabs(zu - zt) < 0.01};

  const S q_zt = run<1>(HumStage{k}, {hum, t_zt, slp})[0];
  const S wnd = run<1>(WindStage{k}, {U, V})[0];
  const S theta_zt = run<1>(ThetaStage{k}, {slp, t_zt, q_zt})[0];
  const S Qsw = S(1.0 - roce_alb0) * rad_sw;
  const Vec<S, 2> s0 = run<2>(Surface0Stage{k}, {sst, slp});
  const SolveIn<S> in{sst, s0[0], s0[1], theta_zt, q_zt, wnd, slp, Qsw, rad_lw};

  const S O = S(0);
  SolveIn<S> ib{O, O, O, O, O, O, O, O, O};
  S b_U = O, b_V = O;
  State<S> stb{ct[6], ct[7], ct[8], ct[9]};
  const auto outer = [&](const Turb<S>& r) {
    Turb<S> rb{O, O, O, O, O, O, O, O};
    const S fx[12] = {r.Cd, r.Ch, r.Ce, r.t_zu, r.q_zu, r.Ub, r.T_s, r.q_s, wnd, U, V, slp};
    vjp(FluxStage{k}, fx, {ct[0], ct[1], ct[2], ct[3], ct[4]},
        {&rb.Cd, &rb.Ch, &rb.Ce, &rb.t_zu, &rb.q_zu, &rb.Ub, &rb.T_s, &rb.q_s, &ib.wnd, &b_U,
         &b_V, &ib.slp});
    rb.T_s += ct[5];
    return rb;
  };
  typename SkinVjp<Solve>::type()(k, in, State<S>{x[9], x[10], x[11], x[12]}, ib, stb, outer);

  S b_sst = ib.sst, b_t = O, b_hum = O, b_slp = ib.slp, b_q = ib.q_zt;
  vjp(Surface0Stage{k}, {sst, slp}, {ib.T_s, ib.q_s}, {&b_sst, &b_slp});
  vjp(ThetaStage{k}, {slp, t_zt, q_zt}, {ib.theta_zt}, {&b_slp, &b_t, &b_q});
  vjp(WindStage{k}, {U, V}, {ib.wnd}, {&b_U, &b_V});
  vjp(HumStage{k}, {hum, t_zt, slp}, {b_q}, {&b_hum, &b_t, &b_slp});
  g[0] = b_sst;
  g[1] = b_t;
  g[2] = b_hum;
  g[3] = b_U;
  g[4] = b_V;
  g[5] = b_slp;
  g[6] = S(1.0 - roce_alb0) * ib.Qsw;
  g[7] = ib.rad_lw;
  g[8] = O;
  g[9] = stb.dT_wl;
  g[10] = stb.Hz_wl;
  g[11] = stb.Qnt_ac;
  g[12] = stb.Tau_ac;
}

}  // namespace adj
}  // namespace abt
