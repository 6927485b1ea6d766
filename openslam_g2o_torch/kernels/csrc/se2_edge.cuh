// SE2 edge arithmetic shared by the kernels that evaluate EDGE_SE2: the
// fused linearizer (edge_se2_blocks.cu) and the trial chi2 of retract_chi2.cu.
// One copy, so that the residual a trial is judged by is bit for bit the
// residual the system was linearized with.
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

// e^T Omega e of one edge, Omega row-major at info[0..9).
template <typename T>
__device__ __forceinline__ T se2_mahalanobis(const T err[3],
                                             const T* __restrict__ info) {
  T e2 = T(0);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) e2 += err[a] * info[3 * a + b] * err[b];
  return e2;
}

// rho'(e2) of every kernel in openslam_g2o_tpu/core/robust.py:83-99, by id.
template <typename T>
__device__ __forceinline__ T robust_rho1(int kernel_id, T e2, T delta) {
  const bool scaled = kernel_id >= 6;     // ScaleDelta:<inner>
  const int inner = scaled ? kernel_id - 5 : kernel_id;
  if (scaled) {
    e2 = e2 / (delta * delta);
    delta = T(1);
  }
  const T dsqr = delta * delta;
  switch (inner) {
    case 1: {  // Huber
      const T sqrte = dsqrt(e2 < T(1e-30) ? T(1e-30) : e2);  // NaN stays NaN
      return e2 <= dsqr ? T(1) : delta / sqrte;
    }
    case 2: {  // PseudoHuber
      const T aux1 = (T(1) / dsqr) * e2 + T(1);
      return T(1) / dsqrt(aux1);
    }
    case 3: {  // Cauchy
      const T aux = (T(1) / dsqr) * e2 + T(1);
      return T(1) / aux;
    }
    case 4:    // Saturated
      return e2 <= dsqr ? T(1) : T(0);
    case 5: {  // DCS
      T scale = (T(2) * delta) / (delta + e2);
      scale = scale > T(1) ? T(1) : scale;  // NaN stays NaN
      return scale * scale;
    }
    default:   // None
      return T(1);
  }
}

// rho(e2) of the same kernels (robust.py:21-99). The clamps keep a NaN, as
// torch.clamp_min / clamp_max do, so a non-finite e2 arrives as a
// non-finite rho wherever the kernel's formula passes it on (Saturated
// does not: its outlier branch is the constant delta^2).
template <typename T>
__device__ __forceinline__ T robust_rho0(int kernel_id, T e2, T delta) {
  const bool scaled = kernel_id >= 6;     // ScaleDelta:<inner>
  const int inner = scaled ? kernel_id - 5 : kernel_id;
  const T outer = delta * delta;
  if (scaled) {
    e2 = e2 / outer;
    delta = T(1);
  }
  const T dsqr = delta * delta;
  T rho;
  switch (inner) {
    case 1: {  // Huber
      const T sqrte = dsqrt(e2 < T(1e-30) ? T(1e-30) : e2);
      rho = e2 <= dsqr ? e2 : T(2) * sqrte * delta - dsqr;
      break;
    }
    case 2: {  // PseudoHuber
      const T aux1 = (T(1) / dsqr) * e2 + T(1);
      rho = T(2) * dsqr * (dsqrt(aux1) - T(1));
      break;
    }
    case 3: {  // Cauchy
      const T aux = (T(1) / dsqr) * e2 + T(1);
      rho = dsqr * dlog(aux);
      break;
    }
    case 4:    // Saturated
      rho = e2 <= dsqr ? e2 : dsqr;
      break;
    case 5: {  // DCS
      T scale = (T(2) * delta) / (delta + e2);
      scale = scale > T(1) ? T(1) : scale;
      rho = scale * e2 * scale;
      break;
    }
    default:   // None
      rho = e2;
  }
  return scaled ? rho * outer : rho;
}

}  // namespace g2o_torch
