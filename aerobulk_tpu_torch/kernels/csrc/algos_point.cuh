// The bulk solves of the ECMWF, NCAR and Andreas algorithms for one point,
// and the per-point body of the stateless flux step (bulk_step.cu) for all
// five ocean algorithms: api.flux_step with use_skin=False.  The ECMWF solve
// also runs with cool skin and warm layer (kSkin) as the skin solve of the
// stateful step (EcmwfSkin: fused_step_ecmwf.cu, fused_grad_ecmwf.cu).
// Templates on the scalar type T under the rules of common.cuh; COARE comes
// from flux_point.cuh's turb_coare with the skin compiled out.
//
// Each function follows its aerobulk_tpu_torch counterpart (stability.py,
// closures.py, thermo.py, algos/{ecmwf,ncar,andreas}.py) expression by
// expression: constants that Python folds in double are folded in double
// here, and Python's association order is kept.

#pragma once

#include "flux_point.cuh"

namespace abt {

// ---------------------------------------------------------------------------
// constants (algos/ecmwf.py, algos/andreas.py, stability.py; the tests
// compare every literal with Python's value)
// ---------------------------------------------------------------------------
constexpr double z0_sea_max = 0.0025;
constexpr double CHARN0_ECMWF = 0.018;
constexpr double CHARN0_OV_G = CHARN0_ECMWF / grav;
constexpr double M_ZI0_OV_K_ECMWF = -1000.0 / vkarmn;
constexpr double ZC_ECMWF = 5.0 / 0.35;
constexpr double RRI_MAX = 0.15;
constexpr double RCS_MIN = 0.00035;
constexpr double SQRT_CX_MIN = 0.01;                      // math.sqrt(Cx_min)
constexpr double SQRT3 = 1.7320508075688772;              // math.sqrt(3)
constexpr double SQRT5 = 2.23606797749979;                // math.sqrt(5)
constexpr double BM_ANDREAS = 5.0 / 6.5;
constexpr double BBM = 0.6694329500821695;                 // |(1-bm)/bm|**(1/3)
constexpr double ATAN_BBM = 0.8539936329836121;           // atan((2-bbm)/(sr3*bbm))
constexpr double LOG_BBH = -1.9248473002384139;            // log|(3-bbh)/(3+bbh)|

// ---------------------------------------------------------------------------
// stability (stability.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T ge_one(T a) { return a >= T(1) ? a : T(1); }

template <typename T> ABT_DI T psi_m_ncar(T zeta) {
  const T x2 = maxp(m_sqrt(ge_one(m_abs(T(1) - T(16) * zeta))), T(1));
  const T x = m_sqrt(x2);
  const T psi_unst = T(2) * m_log((T(1) + x) * T(0.5)) + m_log((T(1) + x2) * T(0.5))
                     - T(2) * m_atan(x) + T(rpi * 0.5);
  const T psi_stab = T(-5) * zeta;
  const T stb = step(zeta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

template <typename T> ABT_DI T psi_h_ncar(T zeta) {
  const T x2 = maxp(m_sqrt(ge_one(m_abs(T(1) - T(16) * zeta))), T(1));
  const T psi_unst = T(2) * m_log(T(0.5) * (T(1) + x2));
  const T psi_stab = T(-5) * zeta;
  const T stb = step(zeta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

template <typename T> ABT_DI T cap_zeta_ecmwf(T zeta) {
  return minp(maxp(zeta, T(-50)), T(5));
}

template <typename T> ABT_DI T psi_m_ecmwf(T zeta) {
  const T zta = cap_zeta_ecmwf(zeta);
  const T x2 = m_sqrt(pos_or_one(m_abs(T(1) - T(16) * zta)));
  const T x = m_sqrt(x2);
  const T t = T(1) + x;
  const T psi_unst = m_log(T(0.125) * t * t * (T(1) + x2)) - T(2) * m_atan(x)
                     + T(0.5 * rpi);
  const T psi_stab = T(-2.0 / 3.0) * (zta - T(ZC_ECMWF)) * m_exp(T(-0.35) * zta)
                     - zta - T(2.0 / 3.0 * ZC_ECMWF);
  const T stb = step(zta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

template <typename T> ABT_DI T psi_h_ecmwf(T zeta) {
  const T zta = cap_zeta_ecmwf(zeta);
  const T x2 = m_sqrt(pos_or_one(m_abs(T(1) - T(16) * zta)));
  const T psi_unst = T(2) * m_log(T(0.5) * (T(1) + x2));
  T x32 = m_abs(T(1) + T(2.0 / 3.0) * zta);
  x32 = x32 * m_sqrt(pos_or_one(x32));
  const T psi_stab = T(-2.0 / 3.0) * (zta - T(ZC_ECMWF)) * m_exp(T(-0.35) * zta)
                     - x32 - T(2.0 / 3.0 * ZC_ECMWF) + T(1);
  const T stb = step(zta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

template <typename T> ABT_DI T psi_m_andreas(T zeta) {
  const T zta = minp(zeta, T(15));
  const T x2 = maxp(m_sqrt(ge_one(m_abs(T(1) - T(16) * zta))), T(1));
  const T x = m_sqrt(x2);
  const T psi_unst = T(2) * m_log(m_abs((T(1) + x) * T(0.5)))
                     + m_log(m_abs((T(1) + x2) * T(0.5)))
                     - T(2) * m_atan(x) + T(rpi * 0.5);
  const T xs = pow_pos(pos_or_one(m_abs(T(1) + zta)), T(1.0 / 3.0));
  const T psi_stab =
      T(-3.0 * 5.0 / BM_ANDREAS) * (xs - T(1))
      + T(5.0 * BBM / (2.0 * BM_ANDREAS))
            * (T(2) * m_log(m_abs((xs + T(BBM)) / T(1.0 + BBM)))
               - m_log(m_abs((xs * xs - xs * T(BBM) + T(BBM * BBM))
                             / T(1.0 - BBM + BBM * BBM)))
               + T(2.0 * SQRT3) * (m_atan((T(2) * xs - T(BBM)) / T(SQRT3 * BBM))
                                   - T(ATAN_BBM)));
  const T stb = step(zta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

// both sides of the stable-branch log ratio are guarded (stability.py: the
// reference guards only the ratio, and is NaN where zz + sqrt(5) = 0)
template <typename T> ABT_DI T psi_h_andreas(T zeta) {
  const T zta = minp(zeta, T(15));
  const T x2 = maxp(m_sqrt(ge_one(m_abs(T(1) - T(16) * zta))), T(1));
  const T psi_unst = T(2) * m_log(T(0.5) * (T(1) + x2));
  const T zz = T(2) * zta + T(3);
  const T psi_stab =
      T(-0.5 * 5.0) * m_log(pos_or_one(m_abs(T(1) + T(3) * zta + zta * zta)))
      + T(-5.0 / SQRT5 + 0.5 * 5.0 * 3.0 / SQRT5)
            * (m_log(pos_or_one(m_abs((zz - T(SQRT5)) / pos_or_one(m_abs(zz + T(SQRT5))))))
               - T(LOG_BBH));
  const T stb = step(zta);
  return stb * psi_stab + (T(1) - stb) * psi_unst;
}

// ---------------------------------------------------------------------------
// closures and roughness (closures.py, thermo.py)
// ---------------------------------------------------------------------------
template <typename T> ABT_DI T cd_n10_ncar(T w) {
  const T w3 = w * w * w;
  const T w6 = w3 * w3;                         // (w*w*w)**2
  const T gt33 = step(w - T(33));
  const T cdn = T(1.0e-3) * ((T(1) - gt33) * (T(2.7) / w + T(0.142) + w / T(13.09)
                                              - T(3.14807e-10) * w6)
                             + gt33 * T(2.34));
  return maxp(cdn, T(Cx_min));
}

template <typename T> ABT_DI T ch_n10_ncar(T sqrt_cdn10, T stab) {
  return maxp(T(1.0e-3) * sqrt_cdn10 * (T(18) * stab + T(32.7) * (T(1) - stab)),
              T(Cx_min));
}

template <typename T> ABT_DI T ce_n10_ncar(T sqrt_cdn10) {
  return maxp(T(1.0e-3) * (T(34.6) * sqrt_cdn10), T(Cx_min));
}

template <typename T> ABT_DI T u_star_andreas(T un10) {
  const T za = un10 - T(8.271);
  const T zt = za + m_sqrt(T(0.12) * za * za + T(0.181));
  return T(0.239) + T(0.0433) * zt;
}

template <typename T> ABT_DI T z0_from_cd(double zu, T Cd, T psi) {
  return T(zu) * m_exp(-(T(vkarmn) / m_sqrt(Cd) + psi));
}

template <typename T> ABT_DI T un10_from_cd(double zu, T Ub, T Cd, T psi) {
  return m_sqrt(Cd) * Ub / T(vkarmn) * m_log(T(10) / z0_from_cd(zu, Cd, psi));
}

template <typename T> ABT_DI T un10_from_ustar(double zu, T Uzu, T us, T psi) {
  return Uzu - us / T(vkarmn) * (T(log(zu / 10.0)) - psi);
}

// Liu-Katsaros-Businger table (thermo._LKB_*): row kFlag-1 of xa and xb, and
// the inner bin edges; bin j is (e_j, e_{j+1}]
__constant__ double kLkbXa[2][8] = {
    {0.177, 1.376, 1.026, 1.625, 4.661, 34.904, 1667.19, 5.88e5},
    {0.292, 1.808, 1.393, 1.956, 4.994, 30.709, 1448.68, 2.98e5}};
__constant__ double kLkbXb[2][8] = {
    {0.0, 0.929, -0.599, -1.018, -1.475, -2.067, -2.907, -3.935},
    {0.0, 0.826, -0.528, -0.870, -1.297, -1.845, -2.682, -3.616}};
__constant__ double kLkbEdges[8] = {0.0, 0.11, 0.825, 3.0, 10.0, 30.0, 100.0, 300.0};

// z0t (kFlag 1) / z0q (kFlag 2) from the roughness Reynolds number
template <int kFlag, typename T> ABT_DI T z0tq_lkb(T Rer, T z0) {
  T xa = T(kLkbXa[kFlag - 1][0]), xb = T(kLkbXb[kFlag - 1][0]);
#pragma unroll
  for (int k = 1; k < 8; ++k) {
    if (Rer > T(kLkbEdges[k])) {
      xa = T(kLkbXa[kFlag - 1][k]);
      xb = T(kLkbXb[kFlag - 1][k]);
    }
  }
  const T val = (Rer > T(0) && Rer < T(1000)) ? xa * pow_pos(Rer, xb) * z0 / Rer : T(-999);
  return minp(maxp(m_abs(val), T(1.0e-9)), T(0.05));
}

// ---------------------------------------------------------------------------
// algos/ecmwf.turb_ecmwf: with kSkin, cool skin and warm layer on (use_cs =
// use_wl = True), committing the warm layer's dT_wl in st on every
// iteration; without, the bulk-SST solve (T_s and q_s stay the inputs, st
// unused)
// ---------------------------------------------------------------------------
template <typename T, bool kSkin>
ABT_DI Turb<T> turb_ecmwf(const Params& p, T sst, T T_s, T q_s, T t_zt, T q_zt, T U_zu,
                          T slp, T Qsw, T rad_lw, State<T>& st) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double m_ztzu = zt_eq_zu ? 0.0 : 1.0;
  const double log_10 = log(10.0), log_zt = log(zt), log_zu = log(zu);
  const double log_ztu = log(zt / zu);

  const T xSST = sst;
  T alpha, dT_cs;
  if constexpr (kSkin) {
    alpha = alpha_sw(xSST);
    dT_cs = T(0);
  }

  const FirstGuess<T> fg = first_guess_coare(zt, zu, zt_eq_zu, log_10, log_zt, log_zu, T_s,
                                             t_zt, q_s, q_zt, U_zu, T(CHARN0_ECMWF));
  T us = fg.us, ts = fg.ts, qs = fg.qs, t_zu = fg.t_zu, q_zu = fg.q_zu;
  T Ub = fg.Ub, z0 = fg.z0;
  T log_z0 = m_log(z0);
  const T nu_a = visc_air(t_zt);

  T dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
  T dq = nonzero_delta(q_zu - q_s, T(1.0e-12));

  T one_on_L = one_on_l(t_zu, q_zu, us, ts, qs);
  T zeta_u = T(zu) * one_on_L;

  T z0t = T(1) / (T(0.1) * m_exp(T(vkarmn) / (T(0.00115) / (T(vkarmn) / (T(log_10) - log_z0)))));
  z0t = minp(maxp(m_abs(z0t), T(1.0e-9)), T(1));
  T log_z0t = m_log(z0t);

  T Fm = T(log_zu) - log_z0 - psi_m_ecmwf(zeta_u) + psi_m_ecmwf(z0 * one_on_L);
  T psi_h_u = psi_h_ecmwf(zeta_u);
  T Fh = T(log_zu) - log_z0t - psi_h_u + psi_h_ecmwf(z0t * one_on_L);

  T log_z0q = T(0), psi_h_z0q = T(0);
#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    const T Rib = ri_bulk(zu, T_s, t_zu, q_s, q_zu, Ub);

    // IFS Eq. 3.23: invert Ri_bulk for 1/L
    one_on_L = clip_mag(Rib * Fm * Fm / Fh * T(1.0 / zu), T(200));

    zeta_u = T(zu) * one_on_L;
    const T psi_m_u = psi_m_ecmwf(zeta_u);
    psi_h_u = psi_h_ecmwf(zeta_u);
    const T zeta_t = T(zt) * one_on_L;
    const T psi_h_t = psi_h_ecmwf(zeta_t);

    Fm = T(log_zu) - log_z0 - psi_m_u + psi_m_ecmwf(z0 * one_on_L);

    us = Ub * T(vkarmn) / Fm;
    const T us2 = us * us;
    const T nu_on_us = nu_a / us;
    z0 = minp(m_abs(T(0.11) * nu_on_us + us2 * T(CHARN0_OV_G)), T(0.001));
    z0t = minp(m_abs(T(0.40) * nu_on_us), T(0.001));
    const T z0q = minp(m_abs(T(0.62) * nu_on_us), T(0.001));
    log_z0 = m_log(z0);
    log_z0t = m_log(z0t);
    log_z0q = m_log(z0q);

    const T psi_m_z0 = psi_m_ecmwf(z0 * one_on_L);
    const T psi_h_z0t = psi_h_ecmwf(z0t * one_on_L);
    psi_h_z0q = psi_h_ecmwf(z0q * one_on_L);

    // gustiness, beta0 = 1
    const T gust2 = T(1.0 * 1.0) * us2 * pow23_pos(one_on_L * T(M_ZI0_OV_K_ECMWF));
    Ub = maxp(m_sqrt(U_zu * U_zu + gust2), T(0.2));

    // scalar profiles and height adjustment
    const T dpsi_t = psi_h_u - psi_h_z0t;
    ts = dt * T(vkarmn) / (T(log_zu) - log_z0t - dpsi_t);
    t_zu = t_zt - T(m_ztzu) * ts * T(INV_K) * (T(log_ztu) + dpsi_t - psi_h_t + psi_h_z0t);

    const T dpsi_q = psi_h_u - psi_h_z0q;
    qs = dq * T(vkarmn) / (T(log_zu) - log_z0q - dpsi_q);
    q_zu = maxp(q_zt - T(m_ztzu) * qs * T(INV_K) * (T(log_ztu) + dpsi_q - psi_h_t + psi_h_z0q),
                T(0));

    Fm = T(log_zu) - log_z0 - psi_m_u + psi_m_z0;
    Fh = T(log_zu) - log_z0t - psi_h_u + psi_h_z0t;

    if constexpr (kSkin) {
      // cool skin
      {
        const QnsTau<T> r = update_qnsol_tau(zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu,
                                             Ub, slp, rad_lw);
        dT_cs = cs_ecmwf(Qsw, r.Qns, us, alpha);
        T_s = xSST + dT_cs;
        T_s = T_s + st.dT_wl;
        q_s = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), slp);
      }

      // warm layer: commits on every iteration
      {
        const QnsTau<T> r = update_qnsol_tau(zu, T_s, q_s, t_zu, q_zu, us, ts, qs, U_zu,
                                             Ub, slp, rad_lw);
        st.dT_wl = wl_ecmwf(Qsw, r.Qns, us, alpha, p.rdt, p.gdept, st.dT_wl, st.Hz_wl);
        T_s = xSST + st.dT_wl;
        T_s = T_s + dT_cs;
        q_s = T(rdct_qsat_salt) * q_sat(maxp(T_s, T(200)), slp);
      }
    }

    dt = nonzero_delta(t_zu - T_s, T(1.0e-9));
    dq = nonzero_delta(q_zu - q_s, T(1.0e-12));
  }

  const T Fq = T(log_zu) - log_z0q - psi_h_u + psi_h_z0q;
  Turb<T> r;
  r.Cd = maxp(T(vkarmn2) / (Fm * Fm), T(Cx_min));
  r.Ch = maxp(T(vkarmn2) / (Fm * Fh), T(Cx_min));
  r.Ce = maxp(T(vkarmn2) / (Fm * Fq), T(Cx_min));
  r.t_zu = t_zu;
  r.q_zu = q_zu;
  r.Ub = Ub;
  r.T_s = T_s;
  r.q_s = q_s;
  return r;
}

// The skin solve of the stateful step for ECMWF (flux_point's Solve; the
// warm layer needs no solar clock, so lon is not read).
struct EcmwfSkin {
  template <typename T>
  ABT_DI Turb<T> operator()(const Params& p, T sst, T T_s, T q_s, T theta_zt, T q_zt, T wnd,
                            T slp, T Qsw, T rad_lw, T lon, State<T>& st) const {
    return turb_ecmwf<T, true>(p, sst, T_s, q_s, theta_zt, q_zt, wnd, slp, Qsw, rad_lw, st);
  }
};

// ---------------------------------------------------------------------------
// algos/ncar.turb_ncar
// ---------------------------------------------------------------------------
template <typename T>
ABT_DI Turb<T> turb_ncar(const Params& p, T sst, T ssq, T t_zt, T q_zt, T U_zu) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log1 = log(zt / zu), log2 = log(zu / 10.0);

  const T Ub = maxp(U_zu, T(0.5));
  T stab = step(virt_temp(t_zt, q_zt) - virt_temp(sst, ssq));

  T CdN = cd_n10_ncar(Ub);
  T sqrt_CdN = m_sqrt(CdN);
  T Cd = CdN;
  T Ce = ce_n10_ncar(sqrt_CdN);
  T Ch = ch_n10_ncar(sqrt_CdN, stab);
  T sqrt_Cd = sqrt_CdN;

  T t_zu = maxp(t_zt, T(180));
  T q_zu = maxp(q_zt, T(1.0e-6));

#pragma unroll 1
  for (int it = 0; it < p.niter; ++it) {
    const T dt = t_zu - sst;
    const T dq = q_zu - ssq;

    // L&Y 2004 Eq. 7 turbulent scales
    const T us = sqrt_Cd * Ub;
    const T ts = Ch / sqrt_Cd * dt;
    const T qs = Ce / sqrt_Cd * dq;

    const T one_on_L = one_on_l(t_zu, q_zu, us, ts, qs);
    const T zeta_u = clip_mag(T(zu) * one_on_L, T(10));

    if (!zt_eq_zu) {
      const T zeta_t = clip_mag(T(zt) * one_on_L, T(10));
      const T ztmp = T(log1) + psi_h_ncar(zeta_u) - psi_h_ncar(zeta_t);
      t_zu = t_zt - ts / T(vkarmn) * ztmp;
      q_zu = maxp(q_zt - qs / T(vkarmn) * ztmp, T(0));
    }

    // L&Y 2004 Eq. 9a: neutral 10-m wind, floored at 0.25 m/s
    const T psi_m = psi_m_ncar(zeta_u);
    const T UN10 = maxp(un10_from_cd(zu, Ub, Cd, psi_m), T(0.25));
    CdN = cd_n10_ncar(UN10);
    sqrt_CdN = m_sqrt(CdN);

    // L&Y 2004 Eq. 10a-c transfer-coefficient update
    T ztmp = T(1) + sqrt_CdN / T(vkarmn) * (T(log2) - psi_m);
    Cd = maxp(CdN / (ztmp * ztmp), T(Cx_min));
    sqrt_Cd = m_sqrt(Cd);
    ztmp = (T(log2) - psi_h_ncar(zeta_u)) / T(vkarmn) / sqrt_CdN;
    const T ztmp2 = sqrt_Cd / sqrt_CdN;

    stab = step(zeta_u);
    const T ChN = T(1.0e-3) * sqrt_CdN * (T(18) * stab + T(32.7) * (T(1) - stab));
    const T CeN = T(1.0e-3) * (T(34.6) * sqrt_CdN);

    Ch = maxp(ChN * ztmp2 / (T(1) + ChN * ztmp), T(Cx_min));
    Ce = maxp(CeN * ztmp2 / (T(1) + CeN * ztmp), T(Cx_min));
  }

  Turb<T> r;
  r.Cd = Cd;
  r.Ch = Ch;
  r.Ce = Ce;
  r.t_zu = t_zu;
  r.q_zu = q_zu;
  r.Ub = Ub;
  r.T_s = sst;
  r.q_s = ssq;
  return r;
}

// ---------------------------------------------------------------------------
// algos/andreas.turb_andreas
// ---------------------------------------------------------------------------
template <typename T>
ABT_DI Turb<T> turb_andreas(const Params& p, T sst, T ssq, T t_zt, T q_zt, T U_zu) {
  const double zt = p.zt, zu = p.zu;
  const bool zt_eq_zu = fabs(zu - zt) < 0.01;
  const double log_zu = log(zu);

  const T Ub = maxp(U_zu, T(0.25));

  T UN10 = Ub;
  const T c0 = T(1.1e-3);
  T t_zu = t_zt;
  T q_zu = q_zt;

  const T sqrt_cd = m_sqrt(c0);
  T t_star = c0 / sqrt_cd * (t_zu - sst);
  T q_star = c0 / sqrt_cd * (q_zu - ssq);

  T RiB = ri_bulk(zu, sst, t_zu, ssq, q_zu, Ub);

  T u_star = T(0);
#pragma unroll 1
  for (int jit = 1; jit <= p.niter; ++jit) {
    u_star = RiB < T(RRI_MAX) ? u_star_andreas(UN10) : T(SQRT_CX_MIN) * Ub;

    const T zeta_u = T(zu) * one_on_l(t_zu, q_zu, u_star, t_star, q_star);

    const T ru = u_star / Ub;
    const T Cd = maxp(ru * ru, T(Cx_min));

    const T psi_m = psi_m_andreas(zeta_u);
    const T z0 = minp(z0_from_cd(zu, Cd, psi_m), T(z0_sea_max));

    const T Rer = z0 * u_star / visc_air(t_zu);
    const T z0t = z0tq_lkb<1>(Rer, z0);
    const T z0q = z0tq_lkb<2>(Rer, z0);

    const T psi_h = psi_h_andreas(zeta_u);
    t_star = (t_zu - sst) * T(vkarmn) / (T(log_zu) - m_log(z0t) - psi_h);
    q_star = (q_zu - ssq) * T(vkarmn) / (T(log_zu) - m_log(z0q) - psi_h);

    if (!zt_eq_zu && jit > 1) {
      const T zeta_t = zeta_u / T(zu) * T(zt);
      const T prf = T(log(zt / zu)) + psi_h - psi_h_andreas(zeta_t);
      t_zu = t_zt - t_star / T(vkarmn) * prf;
      q_zu = q_zt - q_star / T(vkarmn) * prf;
      RiB = ri_bulk(zu, sst, t_zu, ssq, q_zu, Ub);
    }

    UN10 = maxp(un10_from_ustar(zu, Ub, u_star, psi_m), T(0.1));
  }

  const T r = u_star / Ub;
  const T dt = nonzero_delta(t_zu - sst, T(1.0e-6));
  const T dq = nonzero_delta(q_zu - ssq, T(1.0e-9));
  Turb<T> res;
  res.Cd = maxp(r * r, T(Cx_min));
  res.Ch = maxp(r * t_star / dt, T(RCS_MIN));
  res.Ce = maxp(r * q_star / dq, T(RCS_MIN));
  res.t_zu = t_zu;
  res.q_zu = q_zu;
  res.Ub = Ub;
  res.T_s = sst;
  res.q_s = ssq;
  return res;
}

// ---------------------------------------------------------------------------
// the stateless step (api.flux_step with use_skin=False -> the algorithm ->
// bulk_formula -> stress split)
// ---------------------------------------------------------------------------
enum BulkAlgo { kCoare3p0 = 0, kCoare3p6 = 1, kEcmwf = 2, kNcar = 3, kAndreas = 4 };

// The transfer coefficients of one ocean algorithm without skin, from the
// surface and air states that api.flux_step hands it (also the leads of
// mixed_step.cu).
template <typename T, int kAlgo>
ABT_DI Turb<T> ocean_turb(const Params& p, T sst, T ssq, T theta_zt, T q_zt, T wnd,
                          T slp) {
  if constexpr (kAlgo == kCoare3p0 || kAlgo == kCoare3p6) {
    State<T> unused{T(0), T(0), T(0), T(0)};
    return turb_coare<T, false>(p, sst, sst, ssq, theta_zt, q_zt, wnd, slp, T(0), T(0),
                                T(0), unused);
  } else if constexpr (kAlgo == kEcmwf) {
    State<T> unused{T(0), T(0), T(0), T(0)};
    return turb_ecmwf<T, false>(p, sst, sst, ssq, theta_zt, q_zt, wnd, slp, T(0), T(0),
                                unused);
  } else if constexpr (kAlgo == kNcar) {
    return turb_ncar(p, sst, ssq, theta_zt, q_zt, wnd);
  } else {
    return turb_andreas(p, sst, ssq, theta_zt, q_zt, wnd);
  }
}

// One point: in = (sst t_zt hum_zt U_zu V_zu slp), out = (QL QH Tau_x Tau_y
// Evap T_s).
template <typename T, int kAlgo>
ABT_DI void bulk_point(const T (&in)[6], T (&out)[6], const Params& p) {
  const T sst = in[0], t_zt = in[1], hum = in[2];
  const T U = in[3], V = in[4], slp = in[5];

  const T q_zt = q_air_of(p.humidity, hum, t_zt, slp);
  const T wnd = m_sqrt(U * U + V * V);
  const T ssq = T(rdct_qsat_salt) * q_sat(sst, slp);
  const T theta_zt = theta_from_z_p0_t_q(p.zt, slp, t_zt, q_zt);

  const Turb<T> r = ocean_turb<T, kAlgo>(p, sst, ssq, theta_zt, q_zt, wnd, slp);
  flux_outputs(p.zu, r, wnd, U, V, slp, out);
}

}  // namespace abt
