// SE2 arithmetic of the forward-mode linearizers (edge_lin.cu), templated on
// its operands' scalars like the SE3 functions of se3_edge.cuh: T (float or
// double) for values and Jet<T, N> for a value with N derivatives.
//
// Each function follows openslam_g2o_torch/ops/lie.py (which follows
// openslam_g2o_tpu/ops/lie.py:57-116) operation by operation:
// normalize_angle, se2_compose, se2_inverse, se2_apply, se2_retract. The
// angle wrap is the floor formula on the value; floor's derivative is 0, so
// a wrapped Jet keeps its derivative, as torch.floor does under jvp. It
// lands in [-pi, pi).
#pragma once

#include "sba_edge.cuh"

namespace g2o_torch {

template <typename T, int N>
__device__ __forceinline__ Jet<T, N> wrap_angle(Jet<T, N> a) {
  a.v = wrap_angle(a.v);
  return a;
}

// o = a * b, the angle wrapped (lie.py se2_compose; o must not alias)
template <typename A, typename B>
__device__ __forceinline__ void se2_compose(const A* a, const B* b,
                                            mix_t<A, B>* o) {
  const A c = dcos(a[2]), s = dsin(a[2]);
  o[0] = a[0] + c * b[0] - s * b[1];
  o[1] = a[1] + s * b[0] + c * b[1];
  o[2] = wrap_angle(a[2] + b[2]);
}

// o = a^-1 = R(-theta) (-t) (lie.py se2_inverse)
template <typename S>
__device__ __forceinline__ void se2_inverse(const S* a, S* o) {
  const S c = dcos(a[2]), s = dsin(a[2]);
  o[0] = -(c * a[0] + s * a[1]);
  o[1] = -(-s * a[0] + c * a[1]);
  o[2] = wrap_angle(-a[2]);
}

// o = t + R p of the pose a (lie.py se2_apply)
template <typename A, typename B>
__device__ __forceinline__ void se2_apply(const A* a, const B* p,
                                          mix_t<A, B>* o) {
  const A c = dcos(a[2]), s = dsin(a[2]);
  o[0] = a[0] + c * p[0] - s * p[1];
  o[1] = a[1] + s * p[0] + c * p[1];
}

// VertexSE2 oplus (lie.py se2_retract): x + delta, the angle wrapped
template <typename X, typename D>
__device__ __forceinline__ void se2_retract(const X* x, const D* delta,
                                            mix_t<X, D>* o) {
  o[0] = x[0] + delta[0];
  o[1] = x[1] + delta[1];
  o[2] = wrap_angle(x[2] + delta[2]);
}

// The landmark l seen from the pose x: x^-1 l (lie.py se2_apply of
// se2_inverse), the form of every point edge of models/slam2d.py
template <typename A, typename B>
__device__ __forceinline__ void se2_point_in(const A* x, const B* l,
                                             mix_t<A, B>* o) {
  A inv[3];
  se2_inverse(x, inv);
  se2_apply(inv, l, o);
}

}  // namespace g2o_torch
