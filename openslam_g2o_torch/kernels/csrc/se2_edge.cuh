// SE2 edge arithmetic shared by the kernels that evaluate EDGE_SE2: the
// fused linearizer (edge_se2_blocks.cu), K17's analytic entry (edge_lin.cu)
// and the trial chi2 of retract_chi2.cu.
// One copy, so that the residual a trial is judged by is bit for bit the
// residual the system was linearized with. The robust kernels are in
// common.cuh.
#pragma once

#include "common.cuh"

namespace g2o_torch {

// e = (Z^-1 (Xi^-1 Xj)).toVector() in the operation order of
// lie.se2_error(se2_inverse(Z), Xi, Xj) (openslam_g2o_tpu/ops/lie.py:72-116),
// every angle wrapped by the floor formula. Also hands back cos/sin of the
// measurement's and of Xi's angle, which the analytic Jacobians reuse.
template <typename T>
__device__ __forceinline__ void se2_edge_error(T xi0, T xi1, T xi2, T xj0,
                                               T xj1, T xj2, T z0, T z1, T z2,
                                               T err[3], T& cz, T& sz, T& ci,
                                               T& si) {
  cz = dcos(z2);
  sz = dsin(z2);
  const T m0 = -(cz * z0 + sz * z1);
  const T m1 = -(-sz * z0 + cz * z1);
  const T m2 = wrap_angle(-z2);
  ci = dcos(xi2);
  si = dsin(xi2);
  const T a0 = -(ci * xi0 + si * xi1);
  const T a1 = -(-si * xi0 + ci * xi1);
  const T a2 = wrap_angle(-xi2);
  const T ca = dcos(a2), sa = dsin(a2);
  const T d0 = a0 + ca * xj0 - sa * xj1;
  const T d1 = a1 + sa * xj0 + ca * xj1;
  const T d2 = wrap_angle(a2 + xj2);
  const T cm = dcos(m2), sm = dsin(m2);
  err[0] = m0 + cm * d0 - sm * d1;
  err[1] = m1 + sm * d0 + cm * d1;
  err[2] = wrap_angle(m2 + d2);
}

// The analytic Jacobians of EDGE_SE2 (openslam_g2o_tpu/models/slam2d.py:76,
// _edge_se2_jacobian) from the cos/sin se2_edge_error hands back: with
// r = R(ti)^T (tj - ti), J[0] = de/dxi, J[1] = de/dxj, each [3][3]. The
// callers multiply each slot's entries by its vertex's free flag.
template <typename T>
__device__ __forceinline__ void se2_edge_jacobians(T xi0, T xi1, T xj0,
                                                   T xj1, T cz, T sz, T ci,
                                                   T si, T J[2][3][3]) {
  const T dx = xj0 - xi0, dy = xj1 - xi1;
  const T rx = ci * dx + si * dy;
  const T ry = -si * dx + ci * dy;
  const T rr00 = cz * ci - sz * si;
  const T rr01 = cz * si + sz * ci;
  const T rr10 = -(sz * ci + cz * si);
  const T rr11 = -sz * si + cz * ci;
  const T g0 = cz * ry - sz * rx;
  const T g1 = -(sz * ry + cz * rx);
  const T z = T(0), one = T(1);
  const T ji[3][3] = {{-rr00, -rr01, g0}, {-rr10, -rr11, g1}, {z, z, -one}};
  const T jj[3][3] = {{rr00, rr01, z}, {rr10, rr11, z}, {z, z, one}};
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) {
      J[0][a][b] = ji[a][b];
      J[1][a][b] = jj[a][b];
    }
}

// e^T Omega e of one edge, Omega row-major at info[0..9).
template <typename T>
__device__ __forceinline__ T se2_mahalanobis(const T err[3],
                                             const T* __restrict__ info) {
  T e2 = T(0);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) e2 += err[a] * info[3 * a + b] * err[b];
  return e2;
}

}  // namespace g2o_torch
