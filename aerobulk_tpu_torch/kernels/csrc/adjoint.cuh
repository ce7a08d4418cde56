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
// gives the primal.  vjp() adds the stage's output adjoints, contracted
// with its Jacobian, into its inputs' adjoints, by one of two routes:
//  * a written-out reverse adjoint, the stage's adj(): it reads the inputs,
//    recomputes the few intermediates it needs as the primal does, and
//    walks them back.  Every stage with two or more inputs has one, in
//    both solves: vjp() refuses to compile one that falls back to duals;
//  * the stage on Dual<S, 1> (dual.cuh): the one-input stages
//    (CoarePsiStage, EcmwfPsiStage, AlphaStage, ViscStage), where a dual
//    costs what a reverse adjoint would.
// The rules at the points that are not differentiable (ties of maxp/minp
// split 0.5/0.5, |x| at 0, copysign, clip_mag, nonzero_delta's floor, the
// double-select guards) live in dual.cuh alone: as the Dual overloads, and
// as the share helpers (maxp_w, clip_mag_d, ...) that each adj() calls.  So
// the two routes agree, and the adjoint agrees with jax.vjp there.  Each
// stage's Dual instantiation stays its adj()'s oracle in the CPU test.  An
// output that no later stage reads is not an output of its stage, so that,
// as in JAX's transpose, no zero cotangent meets its partials.  Two more
// adjoints are written out across stages: the bulk formula's products
// (bulk_adj, under qns_vjp and FluxStage) and the ECMWF warm layer's
// 10-pass solve (wl_ecmwf_solve_vjp, pass by pass from the stored passes).
//
// The sweep: the forward pass runs the stages in S and keeps the state the
// outer loop carries at the start of each of the niter iterations (~13
// scalars, in local memory); the reverse pass walks the epilogue, then the
// iterations from the last to the first, each recomputed from its
// checkpoint, then the first guess and the prologue.  niter is at most
// kMaxIter.  Within one iteration, the stages whose primal costs the most
// keep what their walk back reads (vjp_kept: a stage's fwd fills a Tape of
// a few values, its bwd reads it; both cool skins' passes, COARE's warm
// layer cascade, q_s's partials, the ECMWF warm layer's absorption and its
// slope, the slopes of ECMWF's psi at z0/L) or run on Dual<S, 1> (both
// solves' psi stages, vjp_d1), so that no primal runs twice in the
// recomputed iteration.  Both sweeps run these forwards, so they take the
// same branches; the forward sweep drops the tapes.  The cool skins' and
// the warm layer's tapes are filled by flux_point.cuh's cs_coare, cs_ecmwf
// and wl_coare themselves (their Tape argument), so the primal has one
// source; the CPU test holds each kept forward to its functor bit for bit.
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

// the Ctx of p at the local solar hour rhr_sol (the COARE warm layer's clock)
ABT_DI Ctx ctx_of(const Params& p, double rhr_sol) {
  const double zt = p.zt, zu = p.zu;
  return Ctx{p, zt, zu, log(10.0), log(zt), log(zu), log(zt / zu),
             fabs(zu - zt) < 0.01 ? 0.0 : 1.0, rhr_sol, fabs(zu - zt) < 0.01};
}

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
ABT_DI void dual_vjp(const F& f, const S (&x)[N], const S (&yb)[M], S* const (&xb)[N]) {
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

// whether a stage has a written-out adjoint (ABT_ADJ)
template <typename F, typename = void> struct HasAdj : std::false_type {};
template <typename F> struct HasAdj<F, std::void_t<decltype(F::kAdj)>> : std::true_type {};

// *xb[j] += sum_i yb[i] * dy_i / dx_j at x: the stage's adj() where it has
// one, else (one input) its dual
template <typename F, typename S, int N, int M>
ABT_DI void vjp(const F& f, const S (&x)[N], const S (&yb)[M], S* const (&xb)[N]) {
  static_assert(N < 2 || HasAdj<F>::value,
                "a stage of two or more inputs walks back through a written-out adj()");
  if constexpr (HasAdj<F>::value) f.adj(x, yb, xb);
  else dual_vjp(f, x, yb, xb);
}

// the same from what the stage's fwd kept of its forward pass in t
template <typename F, typename S, typename Tape, int N, int M>
ABT_DI void vjp_kept(const F& f, const S (&x)[N], const Tape& t, const S (&yb)[M],
                     S* const (&xb)[N]) {
  f.bwd(x, t, yb, xb);
}

// *xb[0] += sum_i yb[i] * dy_i / dx from a one-input stage's outputs on
// Dual<S, 1> (run_d1)
template <typename F, typename S, int M>
ABT_DI void vjp_d1(const F&, const Dual<S, 1> (&yd)[M], const S (&yb)[M], S* const (&xb)[1]) {
  S s = S(0);
#pragma unroll
  for (int i = 0; i < M; ++i) s += yb[i] * yd[i].d[0];
  *xb[0] += s;
}

// a one-input stage on Dual<S, 1>: its outputs and their derivatives
template <typename F, typename S, int M>
ABT_DI void run_d1(const F& f, S x, Dual<S, 1> (&yd)[M]) {
  const Dual<S, 1> xd[1] = {seed(x)};
  f(xd, yd);
}

// a stage functor: name, input count, output count; the body reads x, k
// and writes y.  ABT_ADJ, after the body, opens its written-out adjoint:
// *xb[j] += sum_i yb[i] * dy_i / dx_j at x.
#define ABT_STAGE(name, N, M)                                      \
  struct name {                                                    \
    static constexpr int kN = N, kM = M;                           \
    const Ctx& k;                                                  \
    template <typename T>                                          \
    ABT_DI void operator()(const T (&x)[N], T (&y)[M]) const
#define ABT_ADJ                                                    \
    static constexpr bool kAdj = true;                             \
    template <typename S>                                          \
    ABT_DI void adj(const S (&x)[kN], const S (&yb)[kM], S* const (&xb)[kN]) const
#define ABT_STAGE_END };

// ---------------------------------------------------------------------------
// adjoints of the shared thermodynamics (common.cuh), written out
// ---------------------------------------------------------------------------
// the surface's q_s = rdct_qsat_salt q_sat(MAX(T_s, 200), slp), with e_sat
// on Dual<S, 1>; d = its partials in T_s and slp
template <typename S> ABT_DI S q_s_fwd(S T_s, S slp, Vec<S, 2>& d) {
  const Dual<S, 1> es = e_sat(seed(maxp(T_s, S(200))));
  const S q = q_sat_es(es.v, slp);
  // q = reps0 es / D, D = slp - (1 - reps0) es
  const S c = S(rdct_qsat_salt) / (slp - S(1.0 - reps0) * es.v);
  d = Vec<S, 2>{{c * (S(reps0) + q * S(1.0 - reps0)) * es.d[0] * maxp_w(T_s, S(200)), -c * q}};
  return S(rdct_qsat_salt) * q;
}

// ri_bulk(z, sst, Thta, ssq, qa, ub)
template <typename S>
ABT_DI void ri_bulk_adj(double z, S sst, S Thta, S ssq, S qa, S ub, S yb, S& bsst, S& bThta,
                        S& bssq, S& bqa, S& bub) {
  const S zs = S(1) + S(rctv0) * ssq, za = S(1) + S(rctv0) * qa;
  const S sstv = sst * zs;
  const S dthv = Thta * za - sstv;
  const S tg = Thta - S(rgamma_dry * z);
  const S tv = S(0.5) * (sstv + tg * za);
  const S iden = S(1) / (tv * ub * ub);
  const S b_dthv = yb * S(grav) * S(z) * iden;
  const S b_den = -b_dthv * dthv * iden;
  const S b_tv = b_den * ub * ub;
  bub += b_den * S(2) * tv * ub;
  const S b_sstv = S(0.5) * b_tv - b_dthv;
  const S b_vt = S(0.5) * b_tv;
  bThta += b_vt * za + b_dthv * za;
  bqa += (b_vt * tg + b_dthv * Thta) * S(rctv0);
  bsst += b_sstv * zs;
  bssq += b_sstv * sst * S(rctv0);
}

// (rd, slp) of q = rd reps0 / MAX(slp - (1 - reps0) rd, 1): q_air_rh and
// q_air_dp after their vapour pressure rd
template <typename S> ABT_DI void q_air_adj(S rd, S slp, S qb, S& brd, S& bslp) {
  const S dn = slp - S(1.0 - reps0) * rd;
  const S idm = S(1) / maxp(dn, S(1));
  const S b_q = qb * S(reps0) * idm;
  const S b_dn = -b_q * rd * idm * maxp_w(dn, S(1));
  brd += b_q - b_dn * S(1.0 - reps0);
  bslp += b_dn;
}

// one_on_l at x = (Thta, qa, us, ts, qs): clip_mag(num / MAX(us^2 Thta zqa,
// 1e-9), 200), clipped at 200 once more where kTwice (COARE's 1/L stage):
// *xb[j] += yb d/dx_j
template <bool kTwice, typename S>
ABT_DI void one_on_l_adj(const S (&x)[5], S yb, S* const (&xb)[5]) {
  const S Thta = x[0], us = x[2], ts = x[3], qs = x[4];
  const S zqa = S(1) + S(rctv0) * x[1];
  const S num = S(grav * vkarmn) * (ts * zqa + S(rctv0) * Thta * qs);
  const S pd = us * us * Thta * zqa;
  const S den = maxp(pd, S(1.0e-9));
  const S r = num / den;
  S b_r = yb;
  if constexpr (kTwice) b_r = b_r * clip_mag_d(clip_mag(r, S(200)), S(200));
  b_r = b_r * clip_mag_d(r, S(200)) / den;
  const S b_s = b_r * S(grav * vkarmn);
  const S b_pd = -b_r * r * maxp_w(pd, S(1.0e-9));
  const S b_zqa = b_s * ts + b_pd * us * us * Thta;
  *xb[0] += b_s * S(rctv0) * qs + b_pd * us * us * zqa;
  *xb[1] += b_zqa * S(rctv0);
  *xb[2] += b_pd * S(2) * us * Thta * zqa;
  *xb[3] += b_s * zqa;
  *xb[4] += b_s * S(rctv0) * Thta;
}

// the gustiness of both solves at x = (us, 1/L, wnd): Ub = MAX(sqrt(wnd^2 +
// b2 us^2 pow23_pos(c / L)), 0.2), b2 = beta0^2: *xb[j] += yb dUb/dx_j
template <typename S>
ABT_DI void gust_ub_adj(const S (&x)[3], S b2, S c, S yb, S* const (&xb)[3]) {
  const S us = x[0], a = x[1] * c;
  const S pw = pow23_pos(a);
  const S r = m_sqrt(x[2] * x[2] + b2 * (us * us) * pw);
  // none where the 0.2 floor holds: sqrt's slope at a calm point (r = 0)
  // stays out, as the duals' select keeps it out
  const S w = maxp_w(r, S(0.2));
  const S b_s = w == S(0) ? S(0) : yb * w * S(0.5) / r;
  *xb[0] += b_s * b2 * S(2) * us * pw;
  *xb[1] += b_s * b2 * (us * us) * pow23_pos_d(a, pw) * c;
  *xb[2] += b_s * S(2) * x[2];
}

// ---------------------------------------------------------------------------
// stages both solves share
// ---------------------------------------------------------------------------
// (hum, t_zt, slp) -> q_zt
ABT_STAGE(HumStage, 3, 1) { y[0] = q_air_of(k.p.humidity, x[0], x[1], x[2]); }
  ABT_ADJ {
    if (k.p.humidity != 1 && k.p.humidity != 2) {
      *xb[0] += yb[0];
      return;
    }
    const S slpc = maxp(x[2], S(50000));
    S b_rd = S(0), b_slpc = S(0);
    if (k.p.humidity == 1) {   // rd = 0.01 rha e_sat(Ta)
      const Dual<S, 1> es = e_sat(seed(x[1]));
      q_air_adj(S(0.01) * x[0] * es.v, slpc, yb[0], b_rd, b_slpc);
      *xb[0] += b_rd * S(0.01) * es.v;
      *xb[1] += b_rd * S(0.01) * x[0] * es.d[0];
    } else {                   // rd = MAX(e_sat(da), 0)
      const Dual<S, 1> es = e_sat(seed(x[0]));
      q_air_adj(maxp(es.v, S(0)), slpc, yb[0], b_rd, b_slpc);
      *xb[0] += b_rd * maxp_w(es.v, S(0)) * es.d[0];
    }
    *xb[2] += b_slpc * maxp_w(x[2], S(50000));
  }
ABT_STAGE_END
// (U, V) -> wnd
ABT_STAGE(WindStage, 2, 1) { y[0] = m_sqrt(x[0] * x[0] + x[1] * x[1]); }
  ABT_ADJ {
    const S b_s = yb[0] / m_sqrt(x[0] * x[0] + x[1] * x[1]);
    *xb[0] += b_s * x[0];
    *xb[1] += b_s * x[1];
  }
ABT_STAGE_END
// (slp, t_zt, q_zt) -> theta_zt
ABT_STAGE(ThetaStage, 3, 1) { y[0] = theta_from_z_p0_t_q(k.zt, x[0], x[1], x[2]); }
  ABT_ADJ {
    // theta_from_z_p0_t_q's three passes, keeping the pressure each starts
    // from and the exponent it ends with
    const S slp = x[0], Ta = x[1], qa = x[2];
    const Dual<S, 1> es = e_sat(seed(Ta));
    const S iRT = S(1) / (S(R_gas) * Ta);
    S pa[3], e[3];
    S p = slp;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      pa[j] = p;
      const S qsat = S(reps0) * es.v / (p - S(1.0 - reps0) * es.v);
      const S f = qa / qsat;
      const S xm = (S(1) - f) * S(rmm_dryair) + f * S(rmm_water);
      e[j] = S(grav) * xm * S(k.zt) * iRT;
      p = slp * m_exp(-e[j]);
    }
    const S X = m_exp(S(rpoiss_dry) * e[2]);
    S b_Ta = yb[0] * X, b_e = yb[0] * Ta * X * S(rpoiss_dry), b_slp = S(0), b_qa = S(0);
    S b_es = S(0);
#pragma unroll
    for (int j = 2; j >= 0; --j) {
      // qsat = reps0 es / D, D = pa - (1 - reps0) es; f = qa / qsat
      const S iD = S(1) / (pa[j] - S(1.0 - reps0) * es.v);
      const S qsat = S(reps0) * es.v * iD;
      const S iq = S(1) / qsat;
      b_Ta -= b_e * e[j] * iRT * S(R_gas);
      const S b_f = b_e * S(grav) * S(k.zt) * iRT * (S(rmm_water) - S(rmm_dryair));
      b_qa += b_f * iq;
      const S b_qsat = -b_f * qa * iq * iq;
      b_es += b_qsat * (S(reps0) + qsat * S(1.0 - reps0)) * iD;
      const S b_pa = -b_qsat * qsat * iD;
      if (j == 0) {
        b_slp += b_pa;
      } else {                 // pa[j] = slp exp(-e[j - 1])
        b_slp += b_pa * m_exp(-e[j - 1]);
        b_e = -b_pa * pa[j];
      }
    }
    *xb[0] += b_slp;
    *xb[1] += b_Ta + b_es * es.d[0];
    *xb[2] += b_qa;
  }
ABT_STAGE_END
// (sst, slp) -> the first T_s and q_s
ABT_STAGE(Surface0Stage, 2, 2) {
  const T T_s = x[0] - T(0.25);
  y[0] = T_s;
  y[1] = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), x[1]);
}
  ABT_ADJ {
    Vec<S, 2> d;
    q_s_fwd(x[0] - S(0.25), x[1], d);
    *xb[0] += yb[0] + yb[1] * d[0];
    *xb[1] += yb[1] * d[1];
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
  // fwd keeps q_s's partials in T_s and slp for bwd
  template <typename S> using Tape = Vec<S, 2>;
  template <typename S> ABT_DI Vec<S, 2> fwd(const S (&x)[4], Vec<S, 2>& t) const {
    S T_s = x[0] + x[1];
    T_s = T_s + x[2];
    return Vec<S, 2>{{T_s, q_s_fwd(T_s, x[3], t)}};
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[4], const Vec<S, 2>& t, const S (&yb)[2], S* const (&xb)[4]) const {
    const S b_Ts = yb[0] + yb[1] * t[0];
    *xb[0] += b_Ts;
    *xb[1] += b_Ts;
    *xb[2] += b_Ts;
    *xb[3] += yb[1] * t[1];
  }
  ABT_ADJ {
    Vec<S, 2> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
  }
ABT_STAGE_END
// (t_zu, T_s, q_zu, q_s) -> (dt, dq)
ABT_STAGE(DeltaStage, 4, 2) {
  y[0] = nonzero_delta(x[0] - x[1], T(1.0e-9));
  y[1] = nonzero_delta(x[2] - x[3], T(1.0e-12));
}
  ABT_ADJ {
    const S bt = yb[0] * nonzero_delta_d(x[0] - x[1], S(1.0e-9));
    const S bq = yb[1] * nonzero_delta_d(x[2] - x[3], S(1.0e-12));
    *xb[0] += bt;
    *xb[1] -= bt;
    *xb[2] += bq;
    *xb[3] -= bq;
  }
ABT_STAGE_END

// update_qnsol_tau at x = (T_s, q_s, t_zu, q_zu, us, ts, qs, wnd, Ub, slp,
// rad_lw), cut in three: the transfer coefficients and the air density are
// stages, the products of the bulk formula (bulk_adj) are smooth
// (T_s, q_s, t_zu, q_zu, us, ts, qs, Ub) -> (Cd, Ch, Ce)
ABT_STAGE(QnsCoefStage, 8, 3) {
  const T zdt = nonzero_delta(x[2] - x[0], T(1.0e-9));
  const T zdq = nonzero_delta(x[3] - x[1], T(1.0e-12));
  const T z0 = x[4] / x[7];
  y[0] = z0 * z0;
  y[1] = z0 * x[5] / zdt;
  y[2] = z0 * x[6] / zdq;
}
  ABT_ADJ {
    // Cd = z0^2, Ch = z0 ts / zdt, Ce = z0 qs / zdq, z0 = us / Ub
    const S ddt = x[2] - x[0], ddq = x[3] - x[1];
    const S it = S(1) / nonzero_delta(ddt, S(1.0e-9)), iq = S(1) / nonzero_delta(ddq, S(1.0e-12));
    const S iU = S(1) / x[7];
    const S z0 = x[4] * iU;
    const S b1 = yb[1] * it, b2 = yb[2] * iq;
    const S b_z0 = yb[0] * S(2) * z0 + b1 * x[5] + b2 * x[6];
    const S bt = -b1 * z0 * x[5] * it * nonzero_delta_d(ddt, S(1.0e-9));
    const S bq = -b2 * z0 * x[6] * iq * nonzero_delta_d(ddq, S(1.0e-12));
    *xb[0] -= bt;
    *xb[1] -= bq;
    *xb[2] += bt;
    *xb[3] += bq;
    *xb[4] += b_z0 * iU;
    *xb[5] += b1 * z0;
    *xb[6] += b2 * z0;
    *xb[7] -= b_z0 * z0 * iU;
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
  ABT_ADJ {
    const S ta = x[0] - S(rgamma_dry * k.zu);
    const S zq = S(1) + S(rctv0) * x[1];
    const S den = S(R_dry) * ta * zq;
    const S id = S(1) / den;
    const S r1 = x[2] / den;
    const S rho1 = maxp(r1, S(0.8));
    const S r2 = (x[2] - rho1 * S(grav) * S(k.zu)) / den;
    const S b_r2 = yb[0] * maxp_w(maxp(r2, S(0.8)), S(1)) * maxp_w(r2, S(0.8)) * id;
    const S b_r1 = -b_r2 * S(grav) * S(k.zu) * maxp_w(r1, S(0.8)) * id;
    const S b_den = -(b_r2 * r2 + b_r1 * r1);
    *xb[0] += b_den * S(R_dry) * zq;
    *xb[1] += b_den * S(R_dry) * ta * S(rctv0);
    *xb[2] += b_r2 + b_r1;
  }
ABT_STAGE_END

// bulk_formula's (Tau, Qsen, Qlat, Evap) at x = (T_s, q_s, Thta, qa, Cd, Ch,
// Ce, wnd, Ub, slp), rhoc its MAX(rho, 1): *xb[j] += their adjoints' share
template <typename S>
ABT_DI void bulk_adj(const Ctx& k, const S (&x)[10], S rhoc, S bTau, S bQsen, S bQlat, S bEvap,
                     S* const (&xb)[10]) {
  const S T_s = x[0], Thta = x[2], qa = x[3], Cd = x[4], Ch = x[5], Ce = x[6], wnd = x[7];
  const S Ub = x[8];
  const S Urho = Ub * rhoc;
  const S dq = qa - x[1], dth = Thta - T_s, cpa = cp_air(qa);
  // Qlat = l_vap(T_s) evap, evap = Urho Ce dq, Qsen = Urho Ch dth cpa,
  // Tau = Urho Cd wnd
  const S b_evap = bEvap + bQlat * l_vap(T_s);
  const S b_Urho = bQsen * Ch * dth * cpa + b_evap * Ce * dq + bTau * Cd * wnd;
  const S b_dth = bQsen * Urho * Ch * cpa;
  const S b_dq = b_evap * Urho * Ce;
  *xb[0] += bQlat * (Urho * Ce * dq) * S(-0.00237e6) - b_dth;
  *xb[1] -= b_dq;
  *xb[2] += b_dth;
  *xb[3] += b_dq + bQsen * Urho * Ch * dth * S(rCp_vap);
  *xb[4] += bTau * Urho * wnd;
  *xb[5] += bQsen * Urho * dth * cpa;
  *xb[6] += b_evap * Urho * dq;
  *xb[7] += bTau * Urho * Cd;
  *xb[8] += b_Urho * rhoc;
  vjp(RhoStage{k}, {Thta, qa, x[9]}, {b_Urho * Ub}, {xb[2], xb[3], xb[9]});
}

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
  const S T_s = x[0];
  // Qlw = emiss (rad_lw - stefan T_s^4)
  *xb[0] -= bQns * S(4.0 * emiss_w * stefan) * (T_s * T_s * T_s);
  *xb[10] += bQns * S(emiss_w);
  S cb[3] = {S(0), S(0), S(0)};
  bulk_adj(k, {T_s, x[1], x[2], x[3], q.c[0], q.c[1], q.c[2], x[7], x[8], x[9]}, q.rhoc, bTau,
           bQns, bQns + bQlat, S(0),
           {xb[0], xb[1], xb[2], xb[3], &cb[0], &cb[1], &cb[2], xb[7], xb[8], xb[9]});
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
  ABT_ADJ {
    const S wnd = x[8], U = x[9], V = x[10];
    const S rhoc = run<1>(RhoStage{k}, {x[3], x[4], x[11]})[0];
    const S Tau = x[5] * rhoc * x[0] * wnd;
    // Tau_x = Tau inv_w U, Tau_y = Tau inv_w V; inv_w = 1 / MAX(wnd, 1e-3)
    // where wnd > 1e-3, else 0 (the guarded branch)
    const bool windy = wnd > S(1.0e-3);
    const S wm = maxp(wnd, S(1.0e-3));
    const S inv_w = windy ? S(1) / wm : S(0);
    const S b_inv = (yb[2] * U + yb[3] * V) * Tau;
    *xb[9] += yb[2] * Tau * inv_w;
    *xb[10] += yb[3] * Tau * inv_w;
    if (windy) *xb[8] -= b_inv * inv_w / wm * maxp_w(wnd, S(1.0e-3));
    bulk_adj(k, {x[6], x[7], x[3], x[4], x[0], x[1], x[2], wnd, x[5], x[11]}, rhoc,
             (yb[2] * U + yb[3] * V) * inv_w, yb[1], yb[0], yb[4],
             {xb[6], xb[7], xb[3], xb[4], xb[0], xb[1], xb[2], xb[8], xb[5], xb[11]});
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
  static constexpr int kN = 5, kM = 7;
  const Ctx& k;
  template <typename T> ABT_DI void operator()(const T (&x)[5], T (&y)[7]) const {
    const T charn = kEcmwf ? T(CHARN0_ECMWF) : charn_of(k.p.charn_law, x[4]);
    const FirstGuess<T> g = first_guess_coare(k.zt, k.zu, k.zt_eq_zu, k.log_10, k.log_zt,
                                              k.log_zu, x[0], x[1], x[2], x[3], x[4], charn);
    y[0] = g.us; y[1] = g.ts; y[2] = g.qs; y[3] = g.t_zu; y[4] = g.q_zu; y[5] = g.Ub;
    y[6] = g.z0;
  }
  ABT_ADJ {
    // first_guess_coare's values, as it computes them
    const S T_s = x[0], theta = x[1], q_s = x[2], q_zt = x[3], wnd = x[4];
    const S vk = S(vkarmn);
    const double c_a = 0.035 * log(10.0 / 0.0001) / log(k.zu / 0.0001);
    const Dual<S, 1> ch = kEcmwf ? Dual<S, 1>(CHARN0_ECMWF) : charn_of(k.p.charn_law, seed(wnd));
    const S t_zu0 = maxp(theta, S(180)), q_zu0 = maxp(q_zt, S(1.0e-6));
    const S dta = t_zu0 - T_s, dqa = q_zu0 - q_s;
    const S dt0 = nonzero_delta(dta, S(1.0e-9)), dq0 = nonzero_delta(dqa, S(1.0e-12));
    const Dual<S, 1> nu = visc_air(seed(t_zu0));
    const S Ub = m_sqrt(wnd * wnd + S(0.25));
    const S us0 = S(c_a) * Ub;
    const S z0a = ch.v * us0 * us0 / S(grav) + S(0.11) * nu.v / us0;
    const S z0 = minp(maxp(m_abs(z0a), S(1.0e-8)), S(1));
    const S log_z0 = m_log(z0);
    const S dcd = S(k.log_zu) - log_z0;
    const S cdr = vk / dcd;
    const S Cd = cdr * cdr;
    const S osc = (S(k.log_10) - log_z0) / vk;
    const S dex = S(0.00115) * osc;
    const S arg = vk / dex;
    const S ex = m_exp(arg);
    const S z0ta = S(10) / ex;
    const S z0t = minp(maxp(m_abs(z0ta), S(1.0e-8)), S(1));
    const S log_z0t = m_log(z0t);
    const S Rib = ri_bulk(k.zu, T_s, t_zu0, q_s, q_zu0, Ub);
    const S lzt = S(k.log_zt) - log_z0t;
    const S cc = S(vkarmn2) / (Cd * lzt);
    const S cc_ri = cc * Rib;
    const S stab = step(Rib);
    const S dnm = S(1) + Rib * S(-c_b / k.zu);
    const S zr = (S(1) - stab) * cc_ri / dnm;
    const S zeta_u = zr + stab * (cc_ri + S(27.0 / 9.0) * Rib * Rib);
    const Dual<S, 1> pm = psi_m_coare(seed(zeta_u)), ph = psi_h_coare(seed(zeta_u));
    const S dm = S(k.log_zu) - log_z0 - pm.v;
    const S usr = Ub * vk / dm;
    const S us = maxp(usr, S(1.0e-9));
    const S dh = S(k.log_zu) - log_z0t - ph.v;
    const S ztmp = vk / dh;
    S dt = dt0, dq = dq0;
    Dual<S, 1> pht(0.0);
    S ts1 = S(0), qs1 = S(0), prf = S(0), t_zu = t_zu0, qza = q_zu0, q_zu = q_zu0;
    if (!k.zt_eq_zu) {
      pht = psi_h_coare(seed(S(k.zt) * zeta_u / S(k.zu)));
      prf = S(log(k.zt / k.zu)) + ph.v - pht.v;
      ts1 = dt0 * ztmp;
      qs1 = dq0 * ztmp;
      t_zu = theta - ts1 / vk * prf;
      qza = q_zt - qs1 / vk * prf;
      q_zu = step(qza) * qza;
      dt = nonzero_delta(t_zu - T_s, S(1.0e-9));
      dq = nonzero_delta(q_zu - q_s, S(1.0e-12));
    }
    const S z0ba = ch.v * us * us / S(grav) + S(0.11) * nu.v / us;

    // and back: (us, ts, qs, t_zu, q_zu, Ub, z0)
    S b_Ts = S(0), b_th = S(0), b_qs = S(0), b_qzt = S(0), b_wnd = S(0);
    S b_ch = S(0), b_nu = S(0), b_Ub = yb[5], b_zeta = S(0), b_ph = S(0);
    const S b_z0ba = yb[6] * clamp_abs_d(z0ba, S(1.0e-8), S(1));
    b_ch += b_z0ba * us * us / S(grav);
    b_nu += b_z0ba * S(0.11) / us;
    S b_us = yb[0] + b_z0ba * (ch.v * S(2) * us / S(grav) - S(0.11) * nu.v / us / us);
    const S b_dt = yb[1] * ztmp, b_dq = yb[2] * ztmp;
    S b_ztmp = yb[1] * dt + yb[2] * dq;
    S b_dt0 = b_dt, b_dq0 = b_dq, b_tzu0 = yb[3], b_qzu0 = yb[4];
    if (!k.zt_eq_zu) {
      const S bt = b_dt * nonzero_delta_d(t_zu - T_s, S(1.0e-9));
      const S bq = b_dq * nonzero_delta_d(q_zu - q_s, S(1.0e-12));
      const S b_tzu = yb[3] + bt;
      const S b_qza = (yb[4] + bq) * step(qza);
      b_Ts -= bt;
      b_qs -= bq;
      b_th += b_tzu;
      b_qzt += b_qza;
      const S b_ts1 = -b_tzu * prf / vk, b_qs1 = -b_qza * prf / vk;
      const S b_prf = -(b_tzu * ts1 / vk + b_qza * qs1 / vk);
      b_ph += b_prf;
      b_zeta -= b_prf * pht.d[0] * S(k.zt) / S(k.zu);
      b_dt0 = b_ts1 * ztmp;
      b_dq0 = b_qs1 * ztmp;
      b_ztmp += b_ts1 * dt0 + b_qs1 * dq0;
      b_tzu0 = S(0);
      b_qzu0 = S(0);
    }
    // ztmp = vk / dh, us = MAX(Ub vk / dm, 1e-9)
    const S b_dh = -b_ztmp * ztmp / dh;
    const S b_usr = b_us * maxp_w(usr, S(1.0e-9));
    b_Ub += b_usr * vk / dm;
    const S b_dm = -b_usr * usr / dm;
    b_ph -= b_dh;
    b_zeta += b_ph * ph.d[0] - b_dm * pm.d[0];
    S b_lz0t = -b_dh;
    S b_lz0 = -b_dm;
    // zeta_u = (1 - stab) cc_ri / dnm + stab (cc_ri + 3 Rib^2)
    const S b_ccri = b_zeta * ((S(1) - stab) / dnm + stab);
    S b_Rib = b_zeta * (-zr / dnm * S(-c_b / k.zu) + stab * S(27.0 / 9.0) * S(2) * Rib);
    b_Rib += b_ccri * cc;
    // cc = vk^2 / (Cd lzt)
    const S b_cl = -b_ccri * Rib * cc / (Cd * lzt);
    const S b_Cd = b_cl * lzt;
    b_lz0t -= b_cl * Cd;
    S b_tzu = b_tzu0, b_qzu = b_qzu0;
    ri_bulk_adj(k.zu, T_s, t_zu0, q_s, q_zu0, Ub, b_Rib, b_Ts, b_tzu, b_qs, b_qzu, b_Ub);
    // log_z0t of z0t = 10 / exp(vk / (0.00115 osc)), osc = (log_10 - log_z0) / vk
    const S b_z0ta = b_lz0t / z0t * clamp_abs_d(z0ta, S(1.0e-8), S(1));
    const S b_arg = -b_z0ta * z0ta;
    b_lz0 -= -b_arg * arg / dex * S(0.00115) / vk;
    // Cd = (vk / dcd)^2
    b_lz0 += b_Cd * S(2) * cdr * cdr / dcd;
    const S b_z0a = b_lz0 / z0 * clamp_abs_d(z0a, S(1.0e-8), S(1));
    b_ch += b_z0a * us0 * us0 / S(grav);
    b_nu += b_z0a * S(0.11) / us0;
    b_Ub += b_z0a * (ch.v * S(2) * us0 / S(grav) - S(0.11) * nu.v / us0 / us0) * S(c_a);
    b_wnd += b_Ub * (S(0.5) / Ub) * S(2) * wnd + b_ch * ch.d[0];
    b_tzu += b_nu * nu.d[0];
    // dt0, dq0 and the first t_zu, q_zu
    const S bt0 = b_dt0 * nonzero_delta_d(dta, S(1.0e-9));
    const S bq0 = b_dq0 * nonzero_delta_d(dqa, S(1.0e-12));
    b_Ts -= bt0;
    b_qs -= bq0;
    b_th += (b_tzu + bt0) * maxp_w(theta, S(180));
    b_qzt += (b_qzu + bq0) * maxp_w(q_zt, S(1.0e-6));
    *xb[0] += b_Ts;
    *xb[1] += b_th;
    *xb[2] += b_qs;
    *xb[3] += b_qzt;
    *xb[4] += b_wnd;
  }
};
// (z0, t_zu or theta_zt) -> (log_z0, nu_a)
ABT_STAGE(CoarePreStage, 2, 2) {
  y[0] = m_log(x[0]);
  y[1] = visc_air(x[1]);
}
  ABT_ADJ {
    *xb[0] += yb[0] / x[0];
    *xb[1] += yb[1] * visc_air(seed(x[1])).d[0];
  }
ABT_STAGE_END
// (t_zu, q_zu, us, ts, qs) -> 1/L
ABT_STAGE(CoareOolStage, 5, 1) { y[0] = clip_mag(one_on_l(x[0], x[1], x[2], x[3], x[4]), T(200)); }
  ABT_ADJ { one_on_l_adj<true>(x, yb[0], xb); }
ABT_STAGE_END
// (us, 1/L, wnd) -> Ub
ABT_STAGE(CoareUbStage, 3, 1) {
  const T gust2 = T(k.p.beta0 * k.p.beta0) * (x[0] * x[0]) * pow23_pos(x[1] * T(M_ZI0_OV_K));
  y[0] = maxp(m_sqrt(x[2] * x[2] + gust2), T(0.2));
}
  ABT_ADJ { gust_ub_adj(x, S(k.p.beta0 * k.p.beta0), S(M_ZI0_OV_K), yb[0], xb); }
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
  ABT_ADJ {
    const S us = x[0], nu_a = x[2];
    const S ius = S(1) / us;
    const S Un10 = us * S(INV_K) * (S(k.log_10) - x[1]);
    const Dual<S, 1> ch = charn_of(k.p.charn_law, seed(Un10));
    const S z0a = ch.v * (us * us) * S(INV_G) + S(0.11) * nu_a / us;
    const S z0 = minp(maxp(m_abs(z0a), S(1.0e-9)), S(1));
    const S izus = S(1) / (z0 * us);
    const S rr = nu_a * izus;
    const S pw = pow_pos(rr, S(k.p.z0t_pow));
    const S z0ta = minp(S(k.p.z0t_coef) * pw, S(k.p.z0t_max));
    const S z0t = minp(maxp(m_abs(z0ta), S(1.0e-9)), S(1));
    // log_z0t = log(clamp(MIN(coef (nu_a / (z0 us))^pow, max))): times rr
    // d log_z0t / d rr = rr z0t^-1 coef pow rr^pow / rr
    const S b_rr_rr = yb[1] / z0t * clamp_abs_d(z0ta, S(1.0e-9), S(1))
                      * minp_w(S(k.p.z0t_coef) * pw, S(k.p.z0t_max)) * S(k.p.z0t_coef)
                      * S(k.p.z0t_pow) * pw;
    const S b_zus = -b_rr_rr * izus;
    // log_z0 = log(clamp(charn(Un10) us^2 / g + 0.11 nu_a / us))
    const S b_z0a = (yb[0] / z0 + b_zus * us) * clamp_abs_d(z0a, S(1.0e-9), S(1));
    const S b_Un = b_z0a * (us * us) * S(INV_G) * ch.d[0];
    *xb[0] += b_zus * z0 + b_z0a * (ch.v * S(2) * us * S(INV_G) - S(0.11) * nu_a * ius * ius)
              + b_Un * S(INV_K) * (S(k.log_10) - x[1]);
    *xb[1] -= b_Un * us * S(INV_K);
    *xb[2] += b_rr_rr / nu_a + b_z0a * S(0.11) * ius;
  }
ABT_STAGE_END
// (log_z0t, psi_h_u, dt, dq) -> (ts, qs)
ABT_STAGE(CoareScalesStage, 4, 2) {
  const T fac = T(vkarmn) / (T(k.log_zu) - x[0] - x[1]);
  y[0] = x[2] * fac;
  y[1] = x[3] * fac;
}
  ABT_ADJ {
    const S iden = S(1) / (S(k.log_zu) - x[0] - x[1]);
    const S fac = S(vkarmn) * iden;
    const S b_den = -(yb[0] * x[2] + yb[1] * x[3]) * fac * iden;
    *xb[0] -= b_den;
    *xb[1] -= b_den;
    *xb[2] += yb[0] * fac;
    *xb[3] += yb[1] * fac;
  }
ABT_STAGE_END
// (Ub, log_z0, psi_m_u) -> us
ABT_STAGE(CoareUsStage, 3, 1) {
  y[0] = maxp(x[0] * T(vkarmn) / (T(k.log_zu) - x[1] - x[2]), T(1.0e-9));
}
  ABT_ADJ {
    const S den = S(k.log_zu) - x[1] - x[2];
    const S r = x[0] * S(vkarmn) / den;
    const S b_r = yb[0] * maxp_w(r, S(1.0e-9)) * S(vkarmn) / den;
    const S b_den = -b_r * x[0] / den;
    *xb[0] += b_r;
    *xb[1] -= b_den;
    *xb[2] -= b_den;
  }
ABT_STAGE_END
// (ts, qs, psi_h_u, psi_h_t, theta_zt, q_zt) -> (t_zu, q_zu)
ABT_STAGE(CoareHeightStage, 6, 2) {
  const T prf = T(k.log_zt - k.log_zu) + x[2] - x[3];
  y[0] = x[4] - x[0] * T(INV_K) * prf;
  y[1] = x[5] - x[1] * T(INV_K) * prf;
}
  ABT_ADJ {
    const S prf = S(k.log_zt - k.log_zu) + x[2] - x[3];
    const S b_prf = -(yb[0] * x[0] + yb[1] * x[1]) * S(INV_K);
    *xb[0] -= yb[0] * S(INV_K) * prf;
    *xb[1] -= yb[1] * S(INV_K) * prf;
    *xb[2] += b_prf;
    *xb[3] -= b_prf;
    *xb[4] += yb[0];
    *xb[5] += yb[1];
  }
ABT_STAGE_END

// The cool skin of both solves (cs_generic: COARE's with the Saunders
// term, fr0 = 0.137; ECMWF's without, fr0 = 0.065), written out for its
// adjoint.
// delta_skin_layer<kSaunders>(c, Qd) (flux_point.cuh) from its adjoint bd:
// into bQd and the coefficients' adjoints cb
template <bool kSaunders, typename S>
ABT_DI void delta_skin_layer_adj(const SkinCoefs<S>& c, S Qd, S bd, S& bQd, SkinCoefs<S>& cb) {
  S zQd = Qd;
  if constexpr (kSaunders) zQd = Qd + c.corr;
  const S ztf = step(zQd);
  const S zy = c.coef_y * zQd;
  const bool pos = zy > S(0);
  const S sq = m_sqrt(m_sqrt(pos ? zy : S(1)));
  const S rc = S(1) / m_cbrt(S(1) + (pos ? sq * sq * sq : S(0)));
  // (1 - ztf) 6 rc ztmp + ztf MIN(6 ztmp, 0.007), rc = (1 + zy^0.75)^(-1/3)
  cb.ztmp += bd * ((S(1) - ztf) * (S(6) * rc) + ztf * minp_w(S(6) * c.ztmp, S(0.007)) * S(6));
  if (pos) {
    // d rc / d zy = -(1/3) rc^4 0.75 zy^-0.25
    const S rc2 = rc * rc;
    const S b_zy = -bd * (S(1) - ztf) * c.ztmp * S(6) * rc2 * rc2 * S(0.25) / sq;
    cb.coef_y += b_zy * zQd;
    bQd += b_zy * c.coef_y;
    if constexpr (kSaunders) cb.corr += b_zy * c.coef_y;
  }
}

// what its adjoint reads of cs_generic's passes (flux_point.cuh), which
// fill it: the coefficients, each pass's absorbed flux and skin depth
template <typename S> struct CsTape {
  SkinCoefs<S> c;
  S Qabs[5], delta[5];
  ABT_DI void cs_pass(int it, const SkinCoefs<S>& k, S Q, S d) {
    c = k;
    Qabs[it] = Q;
    delta[it] = d;
  }
};

// its adjoint from the passes kept, from the adjoint yb of dT_cs (bQlat
// gets none without the Saunders term)
template <bool kSaunders, typename S>
ABT_DI void cs_bwd(double fr0, const CsTape<S>& t, S Qsw, S ustar, S alpha, S Qlat, S yb,
                   S& bQsw, S& bQnsol, S& bustar, S& balpha, S& bQlat) {
  SkinCoefs<S> cb{S(0), S(0), S(0)};
  S bQ = yb * S(1.0 / rk0_w) * t.delta[4];
  S bdel = yb * t.Qabs[4] * S(1.0 / rk0_w);
#pragma unroll
  for (int it = 3; it >= 0; --it) {
    delta_skin_layer_adj<kSaunders>(t.c, t.Qabs[it + 1], bdel, bQ, cb);
    // Qabs = Qnsol + fr Qsw, fr = MAX(fr0 + 11 d - 6.6e-5 / d (1 - exp(-d / 8e-4)), 0.01)
    const S d = t.delta[it];
    const S id = S(1) / d;
    const S E = m_exp(d * S(-1.0 / 8.0e-4));
    const S h = S(6.6e-5) * id;
    const S g = S(fr0) + S(11) * d - h * (S(1) - E);
    bQnsol += bQ;
    bQsw += bQ * maxp(g, S(0.01));
    bdel = bQ * Qsw * maxp_w(g, S(0.01)) * (S(11) + h * id * (S(1) - E) + h * E * S(-1.0 / 8.0e-4));
    bQ = S(0);
  }
  delta_skin_layer_adj<kSaunders>(t.c, t.Qabs[0], bdel, bQnsol, cb);
  // skin_layer_coefs: usw = MAX(ustar, 1e-4) sq_radrw, coef_y = alpha rcst_cs
  // usw^-4, ztmp = rnu0_w / usw, corr = 0.026 MIN(Qlat, 0) rCp0_w / rLevap / alpha
  const S inv = S(1) / (maxp(ustar, S(1.0e-4)) * S(sq_radrw));
  const S inv2 = inv * inv;
  balpha += cb.coef_y * S(rcst_cs) * (inv2 * inv2);
  const S b_inv = cb.coef_y * alpha * S(rcst_cs) * S(4) * inv2 * inv + cb.ztmp * S(rnu0_w);
  bustar -= b_inv * inv2 * S(sq_radrw) * maxp_w(ustar, S(1.0e-4));
  if constexpr (kSaunders) {
    const S ia = S(1) / alpha;
    balpha -= cb.corr * t.c.corr * ia;
    bQlat += cb.corr * S(0.026 * rCp0_w / rLevap) * ia * minp_w(Qlat, S(0));
  }
}

// (Qsw, Qns, us, alpha, Qlat) -> dT_cs; fwd keeps the passes for bwd
ABT_STAGE(CoareCsStage, 5, 1) { y[0] = cs_coare(x[0], x[1], x[2], x[3], x[4]); }
  template <typename S> using Tape = CsTape<S>;
  template <typename S> ABT_DI Vec<S, 1> fwd(const S (&x)[5], CsTape<S>& t) const {
    return Vec<S, 1>{{cs_coare(x[0], x[1], x[2], x[3], x[4], t)}};
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[5], const CsTape<S>& t, const S (&yb)[1], S* const (&xb)[5]) const {
    cs_bwd<true>(0.137, t, x[0], x[2], x[3], x[4], yb[0], *xb[0], *xb[1], *xb[2], *xb[3],
                 *xb[4]);
  }
  ABT_ADJ {
    CsTape<S> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
  }
ABT_STAGE_END
// what wl_coare's adjoint reads of its passes (flux_point.cuh), which
// fill it: how the cascade ended, and, for a layer built, each of its
// five passes: the heat content, the depth, the absorption at the depth
// before and its slope
template <typename S> struct WlTape {
  int kind;                    // 0: destroyed, 1: kept, 2: built
  S tac, cd1, cd2, qac[5], Hwl[5], ab[5], ab_d[5];
  ABT_DI S absorption(int j, S H) {
    const Dual<S, 1> a = wl_absorption(seed(H));
    ab[j] = a.v;
    ab_d[j] = a.d[0];
    return a.v;
  }
  ABT_DI void wl_coefs(S c1, S c2, S t) {
    cd1 = c1;
    cd2 = c2;
    tac = t;
  }
  ABT_DI void wl_pass(int j, S q, S H) {
    qac[j] = q;
    Hwl[j] = H;
  }
  ABT_DI void wl_end(bool destroy, bool built) { kind = destroy ? 0 : (built ? 2 : 1); }
};

// its adjoint from the passes kept: a destroyed layer is constant, one
// not built keeps its state, a built one walks its five passes back
template <typename S>
ABT_DI void wl_bwd(const Ctx& k, const S (&x)[8], const WlTape<S>& t, const S (&yb)[4],
                   S* const (&xb)[8]) {
  if (t.kind == 0) return;
  // d Hwl0 / d Hz_wl, Hwl0 = MAX(MIN(Hz_wl, HWL_MAX), 0.1)
  const S Hz_d = minp_w(x[5], S(HWL_MAX)) * maxp_w(minp(x[5], S(HWL_MAX)), S(0.1));
  if (t.kind == 1) {
    *xb[4] += yb[0];
    *xb[5] += yb[1] * Hz_d;
    *xb[6] += yb[2];
    *xb[7] += yb[3];
    return;
  }
  // dT_wl = cd2 qp^1.5 / tac fcor(Hwl), qp = MAX(qac, 1e-30),
  // fcor = flg + (1 - flg) gdept / Hwl
  const S qp = maxp(t.qac[4], S(1.0e-30));
  const S sqp = m_sqrt(qp);
  const S itac = S(1) / t.tac, iH = S(1) / t.Hwl[4];
  const S B = t.cd2 * (qp * sqp) * itac;
  const S flg = step(S(k.p.gdept) - t.Hwl[4]);
  const S fh = (S(1) - flg) * S(k.p.gdept) * iH;
  const S b_A = yb[0] * (flg + fh) * itac;
  S b_tac = yb[3] - b_A * B;
  const S b_cd2 = b_A * (qp * sqp);
  S b_cd1 = S(0), b_Qsw = S(0), b_Qns = S(0), b_qac0 = S(0);
  S b_q = yb[2] + b_A * t.cd2 * S(1.5) * sqp * maxp_w(t.qac[4], S(1.0e-30));
  S b_H = yb[1] - yb[0] * B * fh * iH;
  const S Qsw = x[0], rdt = S(k.p.rdt);
#pragma unroll
  for (int j = 4; j >= 0; --j) {
    // Hwl[j] = clamp(cd1 tac / sqrt(m)), m = MAX(qac[j], 1e-30)
    const S m = maxp(t.qac[j], S(1.0e-30));
    const S is = S(1) / m_sqrt(m);
    const S h = t.cd1 * t.tac * is;
    const S b_h = b_H * maxp_w(minp(h, S(HWL_MAX)), S(0.1)) * minp_w(h, S(HWL_MAX));
    b_cd1 += b_h * t.tac * is;
    b_tac += b_h * t.cd1 * is;
    b_q -= b_h * h * S(0.5) * is * is * maxp_w(t.qac[j], S(1.0e-30));
    // qac[j] = qac0 + (ab Qsw + Qns) rdt, ab the absorption at the depth before
    const S b_Q = b_q * rdt;
    b_qac0 += b_q;
    b_Qsw += b_Q * t.ab[j];
    b_Qns += b_Q;
    b_H = b_Q * Qsw * t.ab_d[j];
    b_q = S(0);
  }
  // cd1 = sqrt(C / (alpha g rho0_w)), cd2 = sqrt(2 alpha g / C') / rCp0_w^1.5
  *xb[0] += b_Qsw;
  *xb[1] += b_Qns;
  *xb[2] += b_tac * rdt * maxp_w(x[2], S(0.002));
  *xb[3] += (b_cd2 * t.cd2 - b_cd1 * t.cd1) * S(0.5) / x[3];
  *xb[5] += b_H * Hz_d;
  *xb[6] += b_qac0;
  *xb[7] += b_tac;
}

// (Qsw, Qns, Tau, alpha, state) -> new state; fwd keeps the passes for bwd
ABT_STAGE(CoareWlStage, 8, 4) { wl(x, y, NoTape{}); }
  template <typename T, typename Tp> ABT_DI void wl(const T (&x)[8], T (&y)[4], Tp&& tp) const {
    State<T> s{x[4], x[5], x[6], x[7]};
    wl_coare(x[0], x[1], x[2], x[3], T(k.rhr_sol), k.p.rdt, k.p.gdept, s, tp);
    y[0] = s.dT_wl; y[1] = s.Hz_wl; y[2] = s.Qnt_ac; y[3] = s.Tau_ac;
  }
  template <typename S> using Tape = WlTape<S>;
  template <typename S> ABT_DI Vec<S, 4> fwd(const S (&x)[8], WlTape<S>& t) const {
    Vec<S, 4> y;
    wl(x, y.v, t);
    return y;
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[8], const WlTape<S>& t, const S (&yb)[4], S* const (&xb)[8]) const {
    wl_bwd(k, x, t, yb, xb);
  }
  ABT_ADJ {
    WlTape<S> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
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
  ABT_ADJ {
    const S ddt = x[4] - x[5], ddq = x[6] - x[7];
    const S dt = nonzero_delta(ddt, S(1.0e-9)), dq = nonzero_delta(ddq, S(1.0e-12));
    const S r = x[0] / x[1];
    const S c1 = r * x[2] / dt, c2 = r * x[3] / dq;
    const S iU = S(1) / x[1];
    const S b0 = yb[0] * maxp_w(r * r, S(Cx_min));
    const S b1 = yb[1] * maxp_w(c1, S(Cx_min)) / dt;
    const S b2 = yb[2] * maxp_w(c2, S(Cx_min)) / dq;
    const S b_r = b0 * S(2) * r + b1 * x[2] + b2 * x[3];
    const S bt = -b1 * c1 * nonzero_delta_d(ddt, S(1.0e-9));
    const S bq = -b2 * c2 * nonzero_delta_d(ddq, S(1.0e-12));
    *xb[0] += b_r * iU;
    *xb[1] -= b_r * r * iU;
    *xb[2] += b1 * r;
    *xb[3] += b2 * r;
    *xb[4] += bt;
    *xb[5] -= bt;
    *xb[6] += bq;
    *xb[7] -= bq;
  }
ABT_STAGE_END

template <typename S> struct CoareCarry { S us, ts, qs, t_zu, q_zu, Ub, log_z0, T_s, q_s; State<S> st; };

// Iteration jit of the COARE loop from the carry c.  !kRev: c becomes the
// carry at its end.  kRev: *cb holds the adjoint of the carry at its end and
// becomes that at its start; the invariants' adjoints add into *vb.  Both
// sweeps run the same forward: psi on Dual<S, 1>, the cool skin's and the
// warm layer's passes and q_s's partials kept, which the reverse reads and
// the forward sweep drops.
template <bool kRev, typename S>
ABT_DI void coare_iter(const Ctx& k, int jit, const Inv<S>& v, CoareCarry<S>& c,
                       CoareCarry<S>* cb, Inv<S>* vb) {
  const bool wl = k.p.niter % jit == 0;
  const Vec<S, 2> d = run<2>(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s});
  const S ool = run<1>(CoareOolStage{k}, {c.t_zu, c.q_zu, c.us, c.ts, c.qs})[0];
  const S Ub = run<1>(CoareUbStage{k}, {c.us, ool, v.wnd})[0];
  Dual<S, 1> psd[3];
  run_d1(CoarePsiStage{k}, ool, psd);
  const Vec<S, 3> psi{{psd[0].v, psd[1].v, psd[2].v}};
  const Vec<S, 2> z = run<2>(CoareZ0Stage{k}, {c.us, c.log_z0, v.nu_a});
  const Vec<S, 2> sc = run<2>(CoareScalesStage{k}, {z[1], psi[0], d[0], d[1]});
  const S us = run<1>(CoareUsStage{k}, {Ub, z[0], psi[1]})[0];
  const S hx[6] = {sc[0], sc[1], psi[0], psi[2], v.theta_zt, v.q_zt};
  Vec<S, 2> h{{c.t_zu, c.q_zu}};
  if (!k.zt_eq_zu) h = run<2>(CoareHeightStage{k}, hx);

  // cool skin
  const S qx1[11] = {c.T_s, c.q_s, h[0], h[1], us, sc[0], sc[1], v.wnd, Ub, v.slp, v.rad_lw};
  const QnsFlux<S> q1 = qns_fwd(k, qx1);
  const S csx[5] = {v.Qsw, q1.Qns, us, v.alpha, q1.Qlat};
  CsTape<S> cst;
  const S dT_cs = CoareCsStage{k}.fwd(csx, cst)[0];
  const S sx1[4] = {v.xSST, dT_cs, c.st.dT_wl, v.slp};
  Vec<S, 2> qt1, qt2;
  const Vec<S, 2> s1 = SurfaceStage{k}.fwd(sx1, qt1);

  // warm layer: commits on every iteration that divides niter
  S qx2[11] = {s1[0], s1[1], h[0], h[1], us, sc[0], sc[1], v.wnd, Ub, v.slp, v.rad_lw};
  QnsFlux<S> q2{};
  if (wl) q2 = qns_fwd(k, qx2);
  const S wx[8] = {v.Qsw, q2.Qns, q2.Tau, v.alpha, c.st.dT_wl, c.st.Hz_wl, c.st.Qnt_ac,
                   c.st.Tau_ac};
  WlTape<S> wlt;
  Vec<S, 2> s2 = s1;
  State<S> st = c.st;
  if (wl) {
    const Vec<S, 4> w = CoareWlStage{k}.fwd(wx, wlt);
    st = State<S>{w[0], w[1], w[2], w[3]};
    const S sx2[4] = {v.xSST, st.dT_wl, dT_cs, v.slp};
    s2 = SurfaceStage{k}.fwd(sx2, qt2);
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
      vjp_kept(SurfaceStage{k}, {v.xSST, st.dT_wl, dT_cs, v.slp}, qt2, {b.T_s, b.q_s},
               {&vb->xSST, &b_dTwl, &b_dTcs, &vb->slp});
      b_st = State<S>{O, O, O, O};
      vjp_kept(CoareWlStage{k}, wx, wlt, {b_dTwl, b.st.Hz_wl, b.st.Qnt_ac, b.st.Tau_ac},
               {&vb->Qsw, &b_Qns2, &b_Tau2, &vb->alpha, &b_st.dT_wl, &b_st.Hz_wl, &b_st.Qnt_ac,
                &b_st.Tau_ac});
      b_Ts1 = O;
      b_qs1 = O;
      qns_vjp(k, qx2, q2, b_Qns2, b_Tau2, O,
          {&b_Ts1, &b_qs1, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
           &vb->rad_lw});
    }
    S b_Qns1 = O, b_Qlat1 = O, b_Ts0 = O, b_qs0 = O;
    vjp_kept(SurfaceStage{k}, sx1, qt1, {b_Ts1, b_qs1},
             {&vb->xSST, &b_dTcs, &b_st.dT_wl, &vb->slp});
    vjp_kept(CoareCsStage{k}, csx, cst, {b_dTcs}, {&vb->Qsw, &b_Qns1, &b_us, &vb->alpha, &b_Qlat1});
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
    vjp_d1(CoarePsiStage{k}, psd, {b_psih, b_psim, b_psit}, {&b_ool});
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
  ABT_ADJ {
    const S z0 = x[5];
    const S log_z0 = m_log(z0);
    const S ool = one_on_l(x[0], x[1], x[2], x[3], x[4]);
    const S zeta_u = S(k.zu) * ool;
    const S dl = S(k.log_10) - log_z0;
    const S A = S(vkarmn) / (S(0.00115) / (S(vkarmn) / dl));
    const S z0ta = S(1) / (S(0.1) * m_exp(A));
    const S z0t = minp(maxp(m_abs(z0ta), S(1.0e-9)), S(1));
    const Dual<S, 1> pmu = psi_m_ecmwf(seed(zeta_u)), phu = psi_h_ecmwf(seed(zeta_u));
    const Dual<S, 1> pmz = psi_m_ecmwf(seed(z0 * ool)), phz = psi_h_ecmwf(seed(z0t * ool));
    // Fm = log_zu - log_z0 - psi_m(zeta_u) + psi_m(z0 / L), Fh = log_zu -
    // log(z0t) - psi_h(zeta_u) + psi_h(z0t / L)
    const S b_pmz = yb[1] * pmz.d[0], b_phz = yb[2] * phz.d[0];
    const S b_zeta = (yb[3] - yb[2]) * phu.d[0] - yb[1] * pmu.d[0];
    // z0t = 10 exp(-A) clamped, A = vk^2 / (0.00115 (log_10 - log_z0))
    const S b_z0ta = (b_phz * ool - yb[2] / z0t) * clamp_abs_d(z0ta, S(1.0e-9), S(1));
    const S b_lz0 = yb[0] - yb[1] - b_z0ta * z0ta * A / dl;
    *xb[5] += b_lz0 / z0 + b_pmz * ool;
    one_on_l_adj<false>({x[0], x[1], x[2], x[3], x[4]}, b_zeta * S(k.zu) + b_pmz * z0 + b_phz * z0t,
                        {xb[0], xb[1], xb[2], xb[3], xb[4]});
  }
ABT_STAGE_END
// (T_s, t_zu, q_s, q_zu, Ub, Fm, Fh) -> 1/L (IFS Eq. 3.23)
ABT_STAGE(EcmwfOolStage, 7, 1) {
  const T Rib = ri_bulk(k.zu, x[0], x[1], x[2], x[3], x[4]);
  y[0] = clip_mag(Rib * x[5] * x[5] / x[6] * T(1.0 / k.zu), T(200));
}
  ABT_ADJ {
    const S Rib = ri_bulk(k.zu, x[0], x[1], x[2], x[3], x[4]);
    const S r = Rib * x[5] * x[5] / x[6] * S(1.0 / k.zu);
    const S b_r = yb[0] * clip_mag_d(r, S(200));
    const S g = b_r * S(1.0 / k.zu) / x[6];
    ri_bulk_adj(k.zu, x[0], x[1], x[2], x[3], x[4], g * x[5] * x[5], *xb[0], *xb[1], *xb[2],
                *xb[3], *xb[4]);
    *xb[5] += g * S(2) * Rib * x[5];
    *xb[6] -= b_r * r / x[6];
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
// (log_z0, psi_m_u, z0, 1/L) -> Fm; fwd keeps psi_m's slope at z0 / L for bwd
ABT_STAGE(EcmwfFmStage, 4, 1) { y[0] = T(k.log_zu) - x[0] - x[1] + psi_m_ecmwf(x[2] * x[3]); }
  template <typename S> using Tape = Vec<S, 1>;
  template <typename S> ABT_DI Vec<S, 1> fwd(const S (&x)[4], Vec<S, 1>& t) const {
    const Dual<S, 1> pm = psi_m_ecmwf(seed(x[2] * x[3]));
    t = Vec<S, 1>{{pm.d[0]}};
    return Vec<S, 1>{{S(k.log_zu) - x[0] - x[1] + pm.v}};
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[4], const Vec<S, 1>& t, const S (&yb)[1], S* const (&xb)[4]) const {
    const S b = yb[0] * t[0];
    *xb[0] -= yb[0];
    *xb[1] -= yb[0];
    *xb[2] += b * x[3];
    *xb[3] += b * x[2];
  }
  ABT_ADJ {
    Vec<S, 1> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
  }
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
  ABT_ADJ {
    const S us = x[0] * S(vkarmn) / x[1];
    const S nu_on_us = x[2] / us;
    const S za[3] = {S(0.11) * nu_on_us + (us * us) * S(CHARN0_OV_G), S(0.40) * nu_on_us,
                     S(0.62) * nu_on_us};
    // each roughness length z = MIN(|za|, 0.001) and its log: the adjoint of za
    S b_za[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const S z = minp(m_abs(za[j]), S(0.001));
      b_za[j] = (yb[1 + j] + yb[4 + j] / z) * minp_w(m_abs(za[j]), S(0.001)) * abs_d(za[j]);
    }
    const S ius = S(1) / us;
    const S b_nou = S(0.11) * b_za[0] + S(0.40) * b_za[1] + S(0.62) * b_za[2];
    // us = Ub vk / Fm, nu_on_us = nu_a / us
    const S b_us = yb[0] + b_za[0] * S(2 * CHARN0_OV_G) * us - b_nou * nu_on_us * ius;
    const S b_r = b_us / x[1];
    *xb[0] += b_r * S(vkarmn);
    *xb[1] -= b_r * us;
    *xb[2] += b_nou * ius;
  }
ABT_STAGE_END
// (z, 1/L) -> psi_m(z / L), or psi_h(z / L) where kHeat; fwd keeps its slope
// for bwd
template <bool kHeat> struct EcmwfPsiZStage {
  static constexpr int kN = 2, kM = 1;
  const Ctx& k;
  template <typename T> static ABT_DI T psi(T zeta) {
    if constexpr (kHeat) return psi_h_ecmwf(zeta);
    else return psi_m_ecmwf(zeta);
  }
  template <typename T> ABT_DI void operator()(const T (&x)[2], T (&y)[1]) const {
    y[0] = psi(x[0] * x[1]);
  }
  template <typename S> using Tape = Vec<S, 1>;
  template <typename S> ABT_DI Vec<S, 1> fwd(const S (&x)[2], Vec<S, 1>& t) const {
    const Dual<S, 1> p = psi(seed(x[0] * x[1]));
    t = Vec<S, 1>{{p.d[0]}};
    return Vec<S, 1>{{p.v}};
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[2], const Vec<S, 1>& t, const S (&yb)[1], S* const (&xb)[2]) const {
    const S b = yb[0] * t[0];
    *xb[0] += b * x[1];
    *xb[1] += b * x[0];
  }
  ABT_ADJ {
    Vec<S, 1> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
  }
};
using EcmwfPsiMzStage = EcmwfPsiZStage<false>;
using EcmwfPsiHzStage = EcmwfPsiZStage<true>;
// (us, 1/L, wnd) -> Ub (gustiness, beta0 = 1)
ABT_STAGE(EcmwfUbStage, 3, 1) {
  const T gust2 = T(1.0 * 1.0) * (x[0] * x[0]) * pow23_pos(x[1] * T(M_ZI0_OV_K_ECMWF));
  y[0] = maxp(m_sqrt(x[2] * x[2] + gust2), T(0.2));
}
  ABT_ADJ { gust_ub_adj(x, S(1.0 * 1.0), S(M_ZI0_OV_K_ECMWF), yb[0], xb); }
ABT_STAGE_END
// (dt or dq, log_z0t or log_z0q, psi_h_u, psi_h_z0t or psi_h_z0q, psi_h_t,
// t_zt or q_zt) -> (ts, t_zu) or (qs, q_zu); humidity is floored at 0
template <bool kHum> struct EcmwfScalarStage {
  static constexpr int kN = 6, kM = 2;
  const Ctx& k;
  template <typename T> ABT_DI void operator()(const T (&x)[6], T (&y)[2]) const {
    const T dpsi = x[2] - x[3];
    const T s = x[0] * T(vkarmn) / (T(k.log_zu) - x[1] - dpsi);
    const T a = x[5] - T(k.m_ztzu) * s * T(INV_K) * (T(k.log_ztu) + dpsi - x[4] + x[3]);
    y[0] = s;
    y[1] = kHum ? maxp(a, T(0)) : a;
  }
  ABT_ADJ {
    // s = x0 vk / den, den = log_zu - x1 - dpsi; a = x5 - m_ztzu s P / vk,
    // P = log_ztu + dpsi - x4 + x3; dpsi = x2 - x3
    const S dpsi = x[2] - x[3];
    const S den = S(k.log_zu) - x[1] - dpsi;
    const S s = x[0] * S(vkarmn) / den;
    const S P = S(k.log_ztu) + dpsi - x[4] + x[3];
    S b_a = yb[1];
    if constexpr (kHum) b_a = b_a * maxp_w(x[5] - S(k.m_ztzu) * s * S(INV_K) * P, S(0));
    const S b_s = yb[0] - b_a * S(k.m_ztzu) * S(INV_K) * P;
    const S b_P = -b_a * S(k.m_ztzu) * s * S(INV_K);
    const S b_den = -b_s * s / den;
    const S b_dpsi = b_P - b_den;
    *xb[0] += b_s * S(vkarmn) / den;
    *xb[1] -= b_den;
    *xb[2] += b_dpsi;
    *xb[3] += b_P - b_dpsi;
    *xb[4] -= b_P;
    *xb[5] += b_a;
  }
};
// (log_z0, psi_m_u, psi_m_z0, log_z0t, psi_h_u, psi_h_z0t) -> (Fm, Fh)
ABT_STAGE(EcmwfFStage, 6, 2) {
  y[0] = T(k.log_zu) - x[0] - x[1] + x[2];
  y[1] = T(k.log_zu) - x[3] - x[4] + x[5];
}
  ABT_ADJ {
    *xb[0] -= yb[0];
    *xb[1] -= yb[0];
    *xb[2] += yb[0];
    *xb[3] -= yb[1];
    *xb[4] -= yb[1];
    *xb[5] += yb[1];
  }
ABT_STAGE_END
// (Qsw, Qns, us, alpha) -> dT_cs; fwd keeps the passes for bwd
ABT_STAGE(EcmwfCsStage, 4, 1) { y[0] = cs_ecmwf(x[0], x[1], x[2], x[3]); }
  template <typename S> using Tape = CsTape<S>;
  template <typename S> ABT_DI Vec<S, 1> fwd(const S (&x)[4], CsTape<S>& t) const {
    return Vec<S, 1>{{cs_ecmwf(x[0], x[1], x[2], x[3], t)}};
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[4], const CsTape<S>& t, const S (&yb)[1], S* const (&xb)[4]) const {
    S b_none = S(0);
    cs_bwd<false>(0.065, t, x[0], x[2], x[3], S(0), yb[0], *xb[0], *xb[1], *xb[2], *xb[3], b_none);
  }
  ABT_ADJ {
    CsTape<S> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
  }
ABT_STAGE_END
// wl_ecmwf in two parts.  (Qsw, Qns, us, alpha, dT_wl, Hz_wl) -> what its
// 10-pass solve reads: (dTwl_b, zA, cst2, cst3, L2, tcorr, wf); fwd keeps
// the absorbed share fr of Qsw at the depth and its slope in Hz_wl for bwd
ABT_STAGE(EcmwfWlPreStage, 6, 7) {
  Vec<T, 2> fr;
  pre(x, y, fr);
}
  template <typename T> ABT_DI void pre(const T (&x)[6], T (&y)[7], Vec<T, 2>& fr) const {
    constexpr double rhocp_w = rho0_w * rCp0_w;
    const T Hwl = x[5];
    const T flg = step(T(k.p.gdept) - Hwl);
    const T tcorr = flg + (T(1) - flg) * T(k.p.gdept) / Hwl;
    const T e1 = m_exp(T(-71.5) * Hwl), e2 = m_exp(T(-2.8) * Hwl), e3 = m_exp(T(-0.07) * Hwl);
    fr = Vec<T, 2>{{T(1) - T(0.28) * e1 - T(0.27) * e2 - T(0.45) * e3,
                    T(0.28 * 71.5) * e1 + T(0.27 * 2.8) * e2 + T(0.45 * 0.07) * e3}};
    const T Qabs = fr[0] * x[0] + x[1];
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
  template <typename S> using Tape = Vec<S, 2>;
  template <typename S> ABT_DI Vec<S, 7> fwd(const S (&x)[6], Vec<S, 2>& t) const {
    Vec<S, 7> y;
    pre(x, y.v, t);
    return y;
  }
  template <typename S>
  ABT_DI void bwd(const S (&x)[6], const Vec<S, 2>& t, const S (&yb)[7], S* const (&xb)[6]) const {
    constexpr double rhocp_w = rho0_w * rCp0_w;
    const S Hwl = x[5], iH = S(1) / Hwl;
    const S flg = step(S(k.p.gdept) - Hwl);
    const S tcorr = flg + (S(1) - flg) * S(k.p.gdept) / Hwl;
    const S Qabs = t[0] * x[0] + x[1];
    const S usw = maxp(x[2], S(1.0e-4)) * S(sq_radrw);
    const S cst1 = S(vkarmn * grav) * x[3];
    const S cst0 = S(k.p.rdt * (RNUWL0 + 1.0)) / Hwl;
    // y0 = MAX(dT_wl / tcorr, 0), y1 = cst0 Qabs / (0.5 rhocp), y2 = cst1 /
    // (5 Hwl usw^2), y3 = -cst0 vk usw fla, y4 = cst1 Qabs / (rhocp usw^3),
    // y5 = tcorr; y6 = step(Qabs) has none
    const S itc = S(1) / tcorr;
    const S r0 = x[4] * itc;
    const S b_r0 = yb[0] * maxp_w(r0, S(0)) * itc;
    const S i2 = S(1) / (S(5) * Hwl * (usw * usw));
    const S i4 = S(1) / (S(rhocp_w) * (usw * usw) * usw);
    const S b_Qabs = yb[1] * cst0 * S(1.0 / (RNUWL0 * rhocp_w)) + yb[4] * cst1 * i4;
    const S b_cst0 = yb[1] * Qabs * S(1.0 / (RNUWL0 * rhocp_w))
                     - yb[3] * S(vkarmn * FLA_ECMWF) * usw;
    const S b_cst1 = yb[2] * i2 + yb[4] * Qabs * i4;
    const S b_usw = -yb[3] * cst0 * S(vkarmn * FLA_ECMWF)
                    - cst1 * (S(2) * yb[2] * i2 + S(3) * yb[4] * Qabs * i4) / usw;
    const S b_tcorr = yb[5] - b_r0 * r0;
    *xb[0] += b_Qabs * t[0];
    *xb[1] += b_Qabs;
    *xb[2] += b_usw * S(sq_radrw) * maxp_w(x[2], S(1.0e-4));
    *xb[3] += b_cst1 * S(vkarmn * grav);
    *xb[4] += b_r0;
    *xb[5] += b_Qabs * x[0] * t[1]
              - (b_tcorr * (S(1) - flg) * S(k.p.gdept) * iH + b_cst0 * cst0
                 + yb[2] * cst1 * i2) * iH;
  }
  ABT_ADJ {
    Vec<S, 2> t;
    fwd(x, t);
    bwd(x, t, yb, xb);
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
  ABT_ADJ {
    // Cd = vk^2 / Fm^2, Ch = vk^2 / (Fm Fh), Ce = vk^2 / (Fm Fq), each
    // floored at Cx_min
    const S Fq = S(k.log_zu) - x[2] - x[3] + x[4];
    const S c0 = S(vkarmn2) / (x[0] * x[0]);
    const S c1 = S(vkarmn2) / (x[0] * x[1]);
    const S c2 = S(vkarmn2) / (x[0] * Fq);
    const S b0 = yb[0] * maxp_w(c0, S(Cx_min)) * c0;
    const S b1 = yb[1] * maxp_w(c1, S(Cx_min)) * c1;
    const S b2 = yb[2] * maxp_w(c2, S(Cx_min)) * c2;
    const S b_Fq = -b2 / Fq;
    *xb[0] -= (S(2) * b0 + b1 + b2) / x[0];
    *xb[1] -= b1 / x[1];
    *xb[2] -= b_Fq;
    *xb[3] -= b_Fq;
    *xb[4] += b_Fq;
  }
ABT_STAGE_END

template <typename S> struct EcmwfCarry {
  S t_zu, q_zu, Ub, z0, log_z0, T_s, q_s, Fm, Fh, log_z0q, psi_h_u, psi_h_z0q;
  State<S> st;
};

// Iteration of the ECMWF loop: as coare_iter.  Hz_wl, Qnt_ac and Tau_ac pass
// through unchanged.  Both sweeps run the same forward: psi on Dual<S, 1>,
// the slopes of psi at z0/L, the cool skin's passes, the warm layer's
// absorption and q_s's partials kept, which the reverse reads and the
// forward sweep drops.
template <bool kRev, typename S>
ABT_DI void ecmwf_iter(const Ctx& k, const Inv<S>& v, EcmwfCarry<S>& c, EcmwfCarry<S>* cb,
                       Inv<S>* vb) {
  const Vec<S, 2> d = run<2>(DeltaStage{k}, {c.t_zu, c.T_s, c.q_zu, c.q_s});
  const S ox[7] = {c.T_s, c.t_zu, c.q_s, c.q_zu, c.Ub, c.Fm, c.Fh};
  const S ool = run<1>(EcmwfOolStage{k}, ox)[0];
  Dual<S, 1> psd[3];                                       // psi_m_u, psi_h_u, psi_h_t
  run_d1(EcmwfPsiStage{k}, ool, psd);
  const Vec<S, 3> psi{{psd[0].v, psd[1].v, psd[2].v}};
  Vec<S, 1> tfm, tm0, th0t, th0q;
  const S fmx[4] = {c.log_z0, psi[0], c.z0, ool};
  const S Fm1 = EcmwfFmStage{k}.fwd(fmx, tfm)[0];
  const Vec<S, 7> rg = run<7>(EcmwfRoughStage{k}, {c.Ub, Fm1, v.nu_a});
  const S pm_z0 = EcmwfPsiMzStage{k}.fwd({rg[1], ool}, tm0)[0];
  const S ph_z0t = EcmwfPsiHzStage{k}.fwd({rg[2], ool}, th0t)[0];
  const S ph_z0q = EcmwfPsiHzStage{k}.fwd({rg[3], ool}, th0q)[0];
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
  const S csx[4] = {v.Qsw, q1.Qns, rg[0], v.alpha};
  CsTape<S> cst;
  const S dT_cs = EcmwfCsStage{k}.fwd(csx, cst)[0];
  const S sx1[4] = {v.xSST, dT_cs, c.st.dT_wl, v.slp};
  Vec<S, 2> qt1, qt2, frt;
  const Vec<S, 2> s1 = SurfaceStage{k}.fwd(sx1, qt1);
  const S qx2[11] = {s1[0], s1[1], tt[1], qq[1], rg[0], tt[0], qq[0], v.wnd, Ub, v.slp,
                     v.rad_lw};
  const QnsFlux<S> q2 = qns_fwd(k, qx2);
  const S wx[6] = {v.Qsw, q2.Qns, rg[0], v.alpha, c.st.dT_wl, c.st.Hz_wl};
  const Vec<S, 7> wp = EcmwfWlPreStage{k}.fwd(wx, frt);
  S wd[11];
  const S dT_wl = wl_ecmwf_solve(wp.v, c.st.Hz_wl, wd);
  const S sx2[4] = {v.xSST, dT_wl, dT_cs, v.slp};
  const Vec<S, 2> s2 = SurfaceStage{k}.fwd(sx2, qt2);

  if constexpr (!kRev) {
    c = EcmwfCarry<S>{tt[1], qq[1], Ub, rg[1], rg[4], s2[0], s2[1], F[0], F[1], rg[6], psi[1],
                      ph_z0q, State<S>{dT_wl, c.st.Hz_wl, c.st.Qnt_ac, c.st.Tau_ac}};
  } else {
    const EcmwfCarry<S> b = *cb;
    const S O = S(0);
    S b_dTwl = b.st.dT_wl, b_dTcs = O, b_Qns2 = O, b_us = O, b_Ts1 = O, b_qs1 = O;
    State<S> b_st{O, b.st.Hz_wl, b.st.Qnt_ac, b.st.Tau_ac};
    S b_tzu = b.t_zu, b_qzu = b.q_zu, b_ts = O, b_qs = O, b_Ub = b.Ub;
    vjp_kept(SurfaceStage{k}, sx2, qt2, {b.T_s, b.q_s}, {&vb->xSST, &b_dTwl, &b_dTcs, &vb->slp});
    S wb[7] = {O, O, O, O, O, O, O};
    wl_ecmwf_solve_vjp(wp.v, c.st.Hz_wl, wd, b_dTwl, wb, b_st.Hz_wl);
    vjp_kept(EcmwfWlPreStage{k}, wx, frt, wb,
             {&vb->Qsw, &b_Qns2, &b_us, &vb->alpha, &b_st.dT_wl, &b_st.Hz_wl});
    qns_vjp(k, qx2, q2, b_Qns2, O, O,
        {&b_Ts1, &b_qs1, &b_tzu, &b_qzu, &b_us, &b_ts, &b_qs, &vb->wnd, &b_Ub, &vb->slp,
         &vb->rad_lw});
    S b_Qns1 = O, b_Ts0 = O, b_qs0 = O;
    vjp_kept(SurfaceStage{k}, sx1, qt1, {b_Ts1, b_qs1},
             {&vb->xSST, &b_dTcs, &b_st.dT_wl, &vb->slp});
    vjp_kept(EcmwfCsStage{k}, csx, cst, {b_dTcs}, {&vb->Qsw, &b_Qns1, &b_us, &vb->alpha});
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
    vjp_kept(EcmwfPsiHzStage{k}, {rg[3], ool}, th0q, {b_phz0q}, {&b_z0q, &b_ool});
    vjp_kept(EcmwfPsiHzStage{k}, {rg[2], ool}, th0t, {b_phz0t}, {&b_z0t, &b_ool});
    vjp_kept(EcmwfPsiMzStage{k}, {rg[1], ool}, tm0, {b_pmz0}, {&b_z0, &b_ool});
    S b_Ub0 = O, b_Fm1 = O;
    vjp(EcmwfRoughStage{k}, {c.Ub, Fm1, v.nu_a}, {b_us, b_z0, b_z0t, b_z0q, b_lz0, b_lz0t, b_lz0q},
        {&b_Ub0, &b_Fm1, &vb->nu_a});
    S b_lz00 = O, b_z00 = O, b_tzu0 = O, b_qzu0 = O, b_Fm0 = O, b_Fh0 = O;
    vjp_kept(EcmwfFmStage{k}, fmx, tfm, {b_Fm1}, {&b_lz00, &b_psim, &b_z00, &b_ool});
    vjp_d1(EcmwfPsiStage{k}, psd, {b_psim, b_psih, b_psit}, {&b_ool});
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
#undef ABT_ADJ
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
  const Ctx k = ctx_of(p, static_cast<double>(local_solar_seconds(lon, p.isecday_utc) / S(3600)));

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
