// Projection and expmap arithmetic of the forward-mode linearizers
// (edge_lin.cu): the SO3 / SE3 exponential and logarithm, the
// left-multiplied expmap retraction of VERTEX_SE3:EXPMAP, the SBACam
// retraction, the anchored inverse depth and the pinhole map.
//
// Each function follows openslam_g2o_torch/ops/lie.py and models/sba.py
// (which follow openslam_g2o_tpu/ops/lie.py:250-352 and models/sba.py)
// operation by operation, templated on its operands' scalars like the SE3
// functions of se3_edge.cuh: T (float or double) for values and Jet<T, N>
// for a value with N forward-mode derivatives. The small-angle branches
// are chosen on the Jet's value, as torch.where chooses them under jvp at
// delta = 0 (theta^2 = 0 exactly, so the Taylor branch and its derivative);
// the clamp of quat_from_compact keeps its value branch likewise, and so do
// so3_log's q_w < 0 flip, its nv2 < 1e-14 branch and se3_log's
// theta^2 < 1e-10 branch.
#pragma once

#include "se3_edge.cuh"

namespace g2o_torch {

template <typename A, typename B, typename C>
using mix3_t = mix_t<A, mix_t<B, C>>;

template <typename S>
using scalar_t = typename ScalarOf<S>::type;

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> dsin(Jet<T, N> a) {
  Jet<T, N> o;
  o.v = dsin(a.v);
  const T c = dcos(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * c;
  return o;
}
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> dcos(Jet<T, N> a) {
  Jet<T, N> o;
  o.v = dcos(a.v);
  const T s = -dsin(a.v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * s;
  return o;
}

__device__ __forceinline__ float dtan(float v) { return tanf(v); }
__device__ __forceinline__ double dtan(double v) { return tan(v); }
__device__ __forceinline__ float datan2(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ double datan2(double y, double x) {
  return atan2(y, x);
}

// d tan a = (1 + tan^2 a) da, as torch's tan derivative
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> dtan(Jet<T, N> a) {
  Jet<T, N> o;
  o.v = dtan(a.v);
  const T s = T(1) + o.v * o.v;
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = a.d[k] * s;
  return o;
}

// d atan2(y, x) = (x dy - y dx) / (x^2 + y^2)
template <typename T, int N>
__device__ __forceinline__ Jet<T, N> datan2(Jet<T, N> y, Jet<T, N> x) {
  Jet<T, N> o;
  o.v = datan2(y.v, x.v);
  const T r = T(1) / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int k = 0; k < N; ++k) o.d[k] = (x.v * y.d[k] - y.v * x.d[k]) * r;
  return o;
}

// o = R(q) p + t of the pose a = (t, q) (lie.py se3_apply)
template <typename A, typename B>
__device__ __forceinline__ void se3_apply(const A* a, const B* p,
                                          mix_t<A, B>* o) {
  quat_rotate(a + 3, p, o);
  for (int k = 0; k < 3; ++k) o[k] = a[k] + o[k];
}

// Rodrigues as a unit quaternion (x, y, z, w) (lie.py so3_exp): below
// theta^2 = 1e-12 the Taylor branch in theta^2.
template <typename S>
__device__ __forceinline__ void so3_exp(const S* w, S* q) {
  typedef scalar_t<S> T;
  const S theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  S k, qw;
  if (value_of(theta2) < T(1e-12)) {
    k = T(0.5) - theta2 / T(48);
    qw = T(1) - theta2 / T(8) + theta2 * theta2 / T(384);
  } else {
    const S t = dsqrt(theta2);
    const S half = T(0.5) * t;
    k = dsin(half) / t;
    qw = dcos(half);
  }
  for (int a = 0; a < 3; ++a) q[a] = k * w[a];
  q[3] = qw;
}

// SE3Quat::exp of xi = (omega, upsilon) (lie.py se3_exp): t = V upsilon with
// V = I + B [omega]x + C [omega]x^2, B and C of _so3_left_jacobian_terms
// (Taylor below theta^2 = 1e-10), q = so3_exp(omega). o = (t, q).
template <typename S>
__device__ __forceinline__ void se3_exp(const S* xi, S* o) {
  typedef scalar_t<S> T;
  const S* om = xi;
  const S* up = xi + 3;
  const S theta2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  S B, C;
  if (value_of(theta2) < T(1e-10)) {
    B = T(0.5) - theta2 / T(24);
    C = T(1) / T(6) - theta2 / T(120);
  } else {
    const S t = dsqrt(theta2);
    B = (T(1) - dcos(t)) / (t * t);
    C = (t - dsin(t)) / (t * t * t);
  }
  const S zero(T(0));
  const S Om[3][3] = {{zero, -om[2], om[1]},
                      {om[2], zero, -om[0]},
                      {-om[1], om[0], zero}};
  for (int i = 0; i < 3; ++i) {
    S acc(T(0));
    for (int j = 0; j < 3; ++j) {
      const S om2 = Om[i][0] * Om[0][j] + Om[i][1] * Om[1][j]
                    + Om[i][2] * Om[2][j];
      const S v = T(i == j ? 1 : 0) + B * Om[i][j] + C * om2;
      acc = j == 0 ? v * up[j] : acc + v * up[j];
    }
    o[i] = acc;
  }
  so3_exp(om, o + 3);
}

// Unit quaternion -> rotation vector, |omega| in [0, pi] (lie.py so3_log):
// q flipped to q_w >= 0; below |v|^2 = 1e-14 the factor 2 / max(q_w,
// 1e-12), else 2 atan2(|v|, q_w) / |v|.
template <typename S>
__device__ __forceinline__ void so3_log(const S* q_in, S* omega) {
  typedef scalar_t<S> T;
  const bool flip = value_of(q_in[3]) < T(0);
  S q[4];
  for (int k = 0; k < 4; ++k) q[k] = flip ? -q_in[k] : q_in[k];
  const S nv2 = q[0] * q[0] + q[1] * q[1] + q[2] * q[2];
  S k;
  if (value_of(nv2) < T(1e-14)) {
    const T w = value_of(q[3]);
    k = T(2) / ((w > T(1e-12) || w != w) ? q[3] : S(T(1e-12)));
  } else {
    const S nv = dsqrt(nv2);
    k = T(2) * datan2(nv, q[3]) / nv;
  }
  for (int a = 0; a < 3; ++a) omega[a] = k * q[a];
}

// SE3Quat::log of p = (t, q) (lie.py se3_log): (omega, V^-1 t), V^-1 =
// I - Om / 2 + coef Om^2 with coef = (1 - t / (2 tan(t / 2))) / t^2, its
// Taylor form below theta^2 = 1e-10.
template <typename S>
__device__ __forceinline__ void se3_log(const S* p, S* o) {
  typedef scalar_t<S> T;
  S om[3];
  so3_log(p + 3, om);
  const S theta2 = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  S coef;
  if (value_of(theta2) < T(1e-10)) {
    coef = T(1) / T(12) + theta2 / T(720);
  } else {
    const S t = dsqrt(theta2);
    coef = (T(1) - t / (T(2) * dtan(t / T(2)))) / theta2;
  }
  const S zero(T(0));
  const S Om[3][3] = {{zero, -om[2], om[1]},
                      {om[2], zero, -om[0]},
                      {-om[1], om[0], zero}};
  for (int i = 0; i < 3; ++i) {
    S acc(T(0));
    for (int j = 0; j < 3; ++j) {
      const S om2 = Om[i][0] * Om[0][j] + Om[i][1] * Om[1][j]
                    + Om[i][2] * Om[2][j];
      const S v = T(i == j ? 1 : 0) - T(0.5) * Om[i][j] + coef * om2;
      acc = j == 0 ? v * p[j] : acc + v * p[j];
    }
    o[3 + i] = acc;
    o[i] = om[i];
  }
}

// toVectorMQT of a pose d = (t, q) (lie.py quat_to_compact): (t, q_vec)
// with q renormalized and flipped to q_w >= 0; d's quaternion is
// normalized in place.
template <typename S>
__device__ __forceinline__ void se3_to_mqt(S* d, S* err) {
  quat_normalize(d + 3);
  const bool flip = value_of(d[6]) < 0;
  for (int k = 0; k < 3; ++k) {
    err[k] = d[k];
    err[3 + k] = flip ? -d[3 + k] : d[3 + k];
  }
}

// VertexSE3Expmap oplus (lie.py se3_retract_expmap_left): o = exp(delta) x
template <typename X, typename D>
__device__ __forceinline__ void se3_retract_expmap_left(const X* x,
                                                        const D* delta,
                                                        mix_t<D, X>* o) {
  D e[7];
  se3_exp(delta, e);
  se3_compose(e, x, o);
}

// SBACam::update (models/sba.py _cam_retract): t + dt, the quaternion
// post-multiplied by quat_from_compact(dq) (w = sqrt(max(0, 1 - |dq|^2)))
// and renormalized. Writes (t, q); the intrinsics the caller keeps.
template <typename X, typename D>
__device__ __forceinline__ void cam_retract(const X* x, const D* delta,
                                            mix_t<X, D>* o) {
  for (int k = 0; k < 3; ++k) o[k] = x[k] + delta[k];
  D dq[4];
  for (int k = 0; k < 3; ++k) dq[k] = delta[3 + k];
  const D n2 = delta[3] * delta[3] + delta[4] * delta[4]
               + delta[5] * delta[5];
  dq[3] = dsqrt(clamp_min0(scalar_t<D>(1) - n2));
  quat_mul(x + 3, dq, o + 3);
  quat_normalize(o + 3);
}

// An additive retraction of the first W parameters (points, intrinsics)
template <int W, typename X, typename D>
__device__ __forceinline__ void rn_retract(const X* x, const D* delta,
                                           mix_t<X, D>* o) {
  for (int k = 0; k < W; ++k) o[k] = x[k] + delta[k];
}

// psi = (u, v, rho) -> (u, v, 1) / rho in the anchor frame (invert_depth)
template <typename S>
__device__ __forceinline__ void invert_depth(const S* psi, S* o) {
  o[0] = psi[0] / psi[2];
  o[1] = psi[1] / psi[2];
  o[2] = scalar_t<S>(1) / psi[2];
}

// CameraParameters::cam_map (models/sba.py cam_map): f p.xy / p.z + c
template <typename S, typename T>
__device__ __forceinline__ void cam_map(const S* p, T focal, T cx, T cy,
                                        S* o) {
  o[0] = p[0] / p[2] * focal + cx;
  o[1] = p[1] / p[2] * focal + cy;
}

}  // namespace g2o_torch
