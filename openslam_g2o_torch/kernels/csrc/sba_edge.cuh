// Projection and expmap arithmetic of the forward-mode linearizers
// (edge_lin.cu): the SO3 / SE3 exponential, the left-multiplied expmap
// retraction of VERTEX_SE3:EXPMAP, the SBACam retraction, the anchored
// inverse depth and the pinhole map.
//
// Each function follows openslam_g2o_torch/ops/lie.py and models/sba.py
// (which follow openslam_g2o_tpu/ops/lie.py:250-352 and models/sba.py)
// operation by operation, templated on its operands' scalars like the SE3
// functions of se3_edge.cuh: T (float or double) for values and Jet<T, N>
// for a value with N forward-mode derivatives. The small-angle branches
// are chosen on the Jet's value, as torch.where chooses them under jvp at
// delta = 0 (theta^2 = 0 exactly, so the Taylor branch and its derivative);
// the clamp of quat_from_compact keeps its value branch likewise.
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
