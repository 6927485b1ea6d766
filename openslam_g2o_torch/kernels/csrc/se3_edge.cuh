// SE3 pose arithmetic shared by the kernels that evaluate EDGE_SE3: the fused
// linearizer (edge_se3_blocks.cu) and the trial's retract and chi2
// (retract_chi2_se3.cu). One copy, so that the residual a trial is judged by
// comes from the code the system was linearized with.
//
// Poses are (tx, ty, tz, qx, qy, qz, qw); the functions follow
// openslam_g2o_tpu/ops/lie.py:127-268 operation by operation (quat_mul,
// quat_rotate, quat_normalize, se3_compose, se3_inverse, quat_from_compact,
// se3_retract_mqt, se3_error_mqt). Each is templated on its operands'
// scalars, which are T (float or double) for values and Jet<T, N> for a
// value with N forward-mode derivatives: the linearizer differentiates the
// error through the retraction, the renormalizations, the sign flip to
// qw >= 0 and the clamp of quat_from_compact exactly as jacfwd does, N
// tangent directions per pass.
#pragma once

#include "common.cuh"

namespace g2o_torch {

// value and N directional derivatives: forward mode along N tangent
// directions at once, so that the value and its reciprocals and square
// roots are computed once for all N, as jacfwd's vmap of jvp shares them
template <typename T, int N>
struct Jet {
  T v, d[N];
  __device__ __forceinline__ Jet() {}
  __device__ __forceinline__ Jet(T value) : v(value) {
#pragma unroll
    for (int k = 0; k < N; ++k) d[k] = T(0);
  }
};

// The type of a op b: a Jet where either is one. A constant operand (a
// plain T) carries no derivative, as in jvp, so no work is spent on its
// zeros.
template <typename A, typename B>
struct Mix { typedef A type; };
template <typename T, int N>
struct Mix<T, Jet<T, N>> { typedef Jet<T, N> type; };
template <typename A, typename B>
using mix_t = typename Mix<A, B>::type;

template <typename S>
struct ScalarOf { typedef S type; };
template <typename T, int N>
struct ScalarOf<Jet<T, N>> { typedef T type; };

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(Jet<T, N> a, Jet<T, N> b) {
  Jet<T, N> o;
  o.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] + b.d[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(Jet<T, N> a, T b) {
  a.v = a.v + b;
  return a;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator+(T a, Jet<T, N> b) {
  b.v = a + b.v;
  return b;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(Jet<T, N> a) {
  a.v = -a.v;
#pragma unroll
  for (int k = 0; k < N; ++k) a.d[k] = -a.d[k];
  return a;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(Jet<T, N> a, Jet<T, N> b) {
  Jet<T, N> o;
  o.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] - b.d[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(Jet<T, N> a, T b) {
  a.v = a.v - b;
  return a;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator-(T a, Jet<T, N> b) {
  Jet<T, N> o;
  o.v = a - b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = -b.d[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(Jet<T, N> a, Jet<T, N> b) {
  Jet<T, N> o;
  o.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(Jet<T, N> a, T b) {
  a.v = a.v * b;
#pragma unroll
  for (int k = 0; k < N; ++k) a.d[k] = a.d[k] * b;
  return a;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator*(T a, Jet<T, N> b) {
  b.v = a * b.v;
#pragma unroll
  for (int k = 0; k < N; ++k) b.d[k] = a * b.d[k];
  return b;
}
// a / b through one reciprocal of b's value: d(a/b) = (da - (a/b) db) / b
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(Jet<T, N> a, Jet<T, N> b) {
  const T r = T(1) / b.v;
  Jet<T, N> o;
  o.v = a.v * r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = (a.d[k] - o.v * b.d[k]) * r;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(Jet<T, N> a, T b) {
  return a * (T(1) / b);
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> operator/(T a, Jet<T, N> b) {
  const T r = T(1) / b.v;
  Jet<T, N> o;
  o.v = a * r;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = -(o.v * b.d[k]) * r;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> dsqrt(Jet<T, N> a) {
  Jet<T, N> o;
  o.v = dsqrt(a.v);
  const T h = T(0.5) / o.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * h;
  return o;
}

__device__ __forceinline__ float value_of(float a) { return a; }
__device__ __forceinline__ double value_of(double a) { return a; }
template <typename T, int N>
__device__ __forceinline__ T value_of(const Jet<T, N>& a) { return a.v; }

// max(a, 0) that keeps a NaN, as jnp.maximum and torch.clamp_min do; the
// clamped branch is the constant 0.
template <typename S>
__device__ __forceinline__ S clamp_min0(S a) {
  const auto v = value_of(a);
  return (v > 0 || v != v) ? a : S(0);
}

// Each function below takes its operands' types apart (A, B), so that a
// constant pose times a moving one costs what jvp's would; with A = B = T
// it is the plain value arithmetic.
template <typename A, typename B>
__device__ __forceinline__ void cross3(const A* a, const B* b,
                                       mix_t<A, B>* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// o = q1 * q2 (o must not alias an input)
template <typename A, typename B>
__device__ __forceinline__ void quat_mul(const A* q1, const B* q2,
                                         mix_t<A, B>* o) {
  const A x1 = q1[0], y1 = q1[1], z1 = q1[2], w1 = q1[3];
  const B x2 = q2[0], y2 = q2[1], z2 = q2[2], w2 = q2[3];
  o[0] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[1] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[2] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
  o[3] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
}

// o = v + 2 (w (u x v) + u x (u x v)), q = (u, w)
template <typename A, typename B>
__device__ __forceinline__ void quat_rotate(const A* q, const B* v,
                                            mix_t<A, B>* o) {
  mix_t<A, B> uv[3], uuv[3];
  cross3(q, v, uv);
  cross3(q, uv, uuv);
  const typename ScalarOf<A>::type two(2);
  for (int a = 0; a < 3; ++a) o[a] = v[a] + two * (q[3] * uv[a] + uuv[a]);
}

template <typename S>
__device__ __forceinline__ void quat_normalize(S* q) {
  const S n = dsqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  for (int a = 0; a < 4; ++a) q[a] = q[a] / n;
}

// o = a * b, the quaternion renormalized (o must not alias an input)
template <typename A, typename B>
__device__ __forceinline__ void se3_compose(const A* a, const B* b,
                                            mix_t<A, B>* o) {
  quat_rotate(a + 3, b, o);
  for (int k = 0; k < 3; ++k) o[k] = a[k] + o[k];
  quat_mul(a + 3, b + 3, o + 3);
  quat_normalize(o + 3);
}

template <typename S>
__device__ __forceinline__ void se3_inverse(const S* a, S* o) {
  o[3] = -a[3];
  o[4] = -a[4];
  o[5] = -a[5];
  o[6] = a[6];
  S t[3];
  quat_rotate(o + 3, a, t);
  for (int k = 0; k < 3; ++k) o[k] = -t[k];
}

// VertexSE3 oplus: o = x * fromVectorMQT(delta), delta = (dt, dq_vec) with
// qw = sqrt(max(0, 1 - |dq_vec|^2)).
template <typename X, typename D>
__device__ __forceinline__ void se3_retract_mqt(const X* x, const D* delta,
                                                mix_t<X, D>* o) {
  D inc[7];
  for (int k = 0; k < 6; ++k) inc[k] = delta[k];
  const D n2 = delta[3] * delta[3] + delta[4] * delta[4] + delta[5] * delta[5];
  inc[6] = dsqrt(clamp_min0(typename ScalarOf<D>::type(1) - n2));
  se3_compose(x, inc, o);
}

// EdgeSE3 error: toVectorMQT(Z^-1 * (Xi^-1 * Xj)); the compact quaternion is
// normalized once more and flipped to qw >= 0.
template <typename Z, typename A, typename B>
__device__ __forceinline__ void se3_error_mqt(const Z* zinv, const A* xi,
                                              const B* xj,
                                              mix_t<Z, mix_t<A, B>>* err) {
  typedef mix_t<A, B> R;
  A xinv[7];
  R rel[7];
  mix_t<Z, R> d[7];
  se3_inverse(xi, xinv);
  se3_compose(xinv, xj, rel);
  se3_compose(zinv, rel, d);
  quat_normalize(d + 3);
  const bool flip = value_of(d[6]) < 0;
  for (int k = 0; k < 3; ++k) {
    err[k] = d[k];
    err[3 + k] = flip ? -d[3 + k] : d[3 + k];
  }
}

// e^T Omega e of one edge, Omega row-major at info[0..36).
template <typename T>
__device__ __forceinline__ T se3_mahalanobis(const T err[6],
                                             const T* __restrict__ info) {
  T e2 = T(0);
  for (int a = 0; a < 6; ++a)
    for (int b = 0; b < 6; ++b) e2 += err[a] * info[6 * a + b] * err[b];
  return e2;
}

// The residual of edge e at the poses table `poses` [N, 7].
template <typename T>
__device__ __forceinline__ void se3_edge_residual(
    const T* __restrict__ poses, long long vi, long long vj,
    const T* __restrict__ meas, T* err) {
  T xi[7], xj[7], z[7], zinv[7];
  for (int k = 0; k < 7; ++k) {
    xi[k] = poses[7 * vi + k];
    xj[k] = poses[7 * vj + k];
    z[k] = meas[k];
  }
  se3_inverse(z, zinv);
  se3_error_mqt(zinv, xi, xj, err);
}

}  // namespace g2o_torch
