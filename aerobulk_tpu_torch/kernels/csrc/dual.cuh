// Forward-mode dual numbers for the per-point functions of flux_point.cuh
// and algos_point.cuh: one primal value and K tangents, and, at the end,
// the same rules as shares for the adjoints adjoint.cuh writes out.  The
// reverse sweep of adjoint.cuh runs a stage that has no written-out
// adjoint on K = its input count and contracts the stage's Jacobian with
// its output adjoints; a written-out adjoint runs one-input functions
// (e_sat, psi, visc_air, ...) on K = 1 for their derivatives.  Both are
// this file's rules, so the two agree at every point.
//
// The rules follow JAX's reverse-mode conventions at the points where a
// function is not differentiable, so that the kernel's gradient is the one
// aerobulk_tpu (jax.vjp) and the port's autograd (thermo.maxc/minc/absj/
// fsign) give:
//  * maxp/minp at a tie (a == b, neither NaN): tangent 0.5 * (ta + tb);
//  * m_abs at 0: derivative 1 (x >= 0 ? 1 : -1, also for -0.0);
//  * m_copysign(a, b): derivative sign(b) * (a >= 0 ? 1 : -1) in a, 0 in b;
//  * ?: selects take the whole dual, so the double-where guards keep the
//    untaken branch's tangent out of the result; step() and the
//    comparisons have zero tangent (comparisons look at the primal only);
//  * pow_pos(x, c) (x > 0, c a constant: every site of the step) has the
//    derivative c * x**c / x in x and none in c.
// A constant T(c) has zero tangents.  0 * inf inside one product still
// gives NaN, as it does in JAX's reverse pass.

#pragma once

#include "flux_point.cuh"

namespace abt {

template <typename S, int K> struct Dual {
  S v;      // primal
  S d[K];   // tangents

  Dual() = default;
  // a constant: T(c) in the body, rounded to S as PyTorch casts a Python
  // float to the tensor's dtype
  ABT_DI explicit Dual(double c) : v(static_cast<S>(c)) {
#pragma unroll
    for (int k = 0; k < K; ++k) d[k] = S(0);
  }
};

#define ABT_DUAL template <typename S, int K> ABT_DI

// y = f(x) with f'(x) = df: the tangent of y is df * tx
template <typename S, int K> ABT_DI Dual<S, K> chain(S v, S df, const Dual<S, K>& x) {
  Dual<S, K> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = df * x.d[k];
  return r;
}

ABT_DUAL Dual<S, K> operator+(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

ABT_DUAL Dual<S, K> operator-(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

ABT_DUAL Dual<S, K> operator-(const Dual<S, K>& a) {
  Dual<S, K> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = -a.d[k];
  return r;
}

ABT_DUAL Dual<S, K> operator*(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

ABT_DUAL Dual<S, K> operator/(const Dual<S, K>& a, const Dual<S, K>& b) {
  Dual<S, K> r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

ABT_DUAL bool operator<(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v < b.v; }
ABT_DUAL bool operator>(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v > b.v; }
ABT_DUAL bool operator<=(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v <= b.v; }
ABT_DUAL bool operator>=(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v >= b.v; }
ABT_DUAL bool operator==(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v == b.v; }
ABT_DUAL bool operator!=(const Dual<S, K>& a, const Dual<S, K>& b) { return a.v != b.v; }

// ---------------------------------------------------------------------------
// the m_* math of flux_point.cuh
// ---------------------------------------------------------------------------
ABT_DUAL Dual<S, K> m_exp(const Dual<S, K>& x) {
  const S v = m_exp(x.v);
  return chain(v, v, x);
}

ABT_DUAL Dual<S, K> m_exp2(const Dual<S, K>& x) {
  const S v = m_exp2(x.v);
  return chain(v, v * S(0.6931471805599453), x);          // ln 2
}

ABT_DUAL Dual<S, K> m_log(const Dual<S, K>& x) {
  return chain(m_log(x.v), S(1) / x.v, x);
}

ABT_DUAL Dual<S, K> m_log10(const Dual<S, K>& x) {
  return chain(m_log10(x.v), S(1) / (x.v * S(2.302585092994046)), x);   // ln 10
}

ABT_DUAL Dual<S, K> m_sqrt(const Dual<S, K>& x) {
  const S v = m_sqrt(x.v);
  return chain(v, S(0.5) / v, x);
}

ABT_DUAL Dual<S, K> m_cbrt(const Dual<S, K>& x) {
  const S v = m_cbrt(x.v);
  return chain(v, S(1.0 / 3.0) / (v * v), x);
}

ABT_DUAL Dual<S, K> m_atan(const Dual<S, K>& x) {
  return chain(m_atan(x.v), S(1) / (S(1) + x.v * x.v), x);
}

ABT_DUAL Dual<S, K> m_abs(const Dual<S, K>& x) {
  return chain(m_abs(x.v), x.v >= S(0) ? S(1) : S(-1), x);
}

ABT_DUAL Dual<S, K> pow_pos(const Dual<S, K>& x, const Dual<S, K>& c) {
  const S v = pow_pos(x.v, c.v);
  return chain(v, c.v * v / x.v, x);
}

ABT_DUAL Dual<S, K> m_copysign(const Dual<S, K>& a, const Dual<S, K>& b) {
  const S sb = m_copysign(S(1), b.v);     // -1 where b's sign bit is set
  return chain(m_copysign(a.v, b.v), a.v >= S(0) ? sb : -sb, a);
}

// MAX/MIN: NaN from either side as in flux_point.cuh; at a tie the tangent
// is shared half and half, as jnp.maximum / torch.maximum share the gradient
ABT_DUAL Dual<S, K> maxp(const Dual<S, K>& a, const Dual<S, K>& b) {
  if (a.v != a.v || a.v > b.v) return a;
  if (a.v != b.v) return b;
  Dual<S, K> r;
  r.v = b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = S(0.5) * (a.d[k] + b.d[k]);
  return r;
}

ABT_DUAL Dual<S, K> minp(const Dual<S, K>& a, const Dual<S, K>& b) {
  if (a.v != a.v || a.v < b.v) return a;
  if (a.v != b.v) return b;
  Dual<S, K> r;
  r.v = b.v;
#pragma unroll
  for (int k = 0; k < K; ++k) r.d[k] = S(0.5) * (a.d[k] + b.d[k]);
  return r;
}

#undef ABT_DUAL

// ---------------------------------------------------------------------------
// The same rules in reverse, for the adjoints adjoint.cuh writes out: each
// helper gives the share of an output's adjoint that goes to the input, so
// that no stage restates a rule.  Every clamp bound of the step is a
// constant, so only the first argument's share is needed.
// ---------------------------------------------------------------------------
// maxp(a, b) / minp(a, b): a's share (b's is 1 minus it): all where a is
// taken (a NaN too), none where b is, half at a tie
template <typename S> ABT_DI S maxp_w(S a, S b) {
  return (a != a || a > b) ? S(1) : (a != b ? S(0) : S(0.5));
}
template <typename S> ABT_DI S minp_w(S a, S b) {
  return (a != a || a < b) ? S(1) : (a != b ? S(0) : S(0.5));
}

// d|x|/dx: 1 at 0 (and at -0.0)
template <typename S> ABT_DI S abs_d(S x) { return x >= S(0) ? S(1) : S(-1); }

// d copysign(a, b)/da: none in b
template <typename S> ABT_DI S copysign_d(S a, S b) {
  const S sb = m_copysign(S(1), b);
  return a >= S(0) ? sb : -sb;
}

// d fsign(a, b)/da, fsign(a, b) = copysign(|a|, b)
template <typename S> ABT_DI S fsign_d(S a, S b) { return copysign_d(m_abs(a), b) * abs_d(a); }

// d clip_mag(x, cap)/dx: none beyond the cap, half at it
template <typename S> ABT_DI S clip_mag_d(S x, S cap) {
  const S a = m_abs(x);
  return fsign_d(minp(a, cap), x) * minp_w(a, cap) * abs_d(x);
}

// d nonzero_delta(dx, fl)/d dx: none on the floor, half at it
template <typename S> ABT_DI S nonzero_delta_d(S dx, S fl) {
  const S a = m_abs(dx);
  return fsign_d(maxp(a, fl), dx) * maxp_w(a, fl) * abs_d(dx);
}

// d minp(maxp(|x|, lo), hi)/dx: the roughness lengths' clamps
template <typename S> ABT_DI S clamp_abs_d(S x, S lo, S hi) {
  const S a = m_abs(x);
  return minp_w(maxp(a, lo), hi) * maxp_w(a, lo) * abs_d(x);
}

// d pow_pos(x, c)/dx at its value v = x**c, c a constant
template <typename S> ABT_DI S pow_pos_d(S x, S c, S v) { return c * v / x; }

// d pow23_pos(x)/dx at its value v: none from the guarded branch x <= 0
template <typename S> ABT_DI S pow23_pos_d(S x, S v) {
  return x > S(0) ? pow_pos_d(x, S(2.0 / 3.0), v) : S(0);
}

// x as the input of a one-input function: f(seed(x)) holds f(x) and f'(x)
// by the forward rules above, at about twice f's cost
template <typename S> ABT_DI Dual<S, 1> seed(S x) {
  Dual<S, 1> r;
  r.v = x;
  r.d[0] = S(1);
  return r;
}

}  // namespace abt
