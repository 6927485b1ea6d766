// The projection edges of the expmap family with analytic Jacobians:
// EDGE_PROJECT_XYZ2UV:EXPMAP (R = 2) and the stereo EDGE_PROJECT_XYZ2UVU
// (R = 3), shared by K10's fused entry (ba_edge_blocks.cu), K17's
// analytic entries (edge_lin.cu) and, the residual alone, K7's trial chi2
// (trial.cu).
//
// Follows openslam_g2o_torch/models/sba.py `_edge_xyz2uv_error`,
// `_edge_xyz2uvu_error` and their Jacobians (openslam_g2o_tpu/models/
// sba.py:147-236): pc = T_w2c p, the residual obs - (f pc.xy / pc.z + c
// [, f (pc.x - b) / pc.z + cx]), de/dpc = -f [[1/z, 0, -x/z^2], [0, 1/z,
// -y/z^2] [, [1/z, 0, -(x - b)/z^2]]], J_point = de/dpc R(T) and J_cam =
// [de/dpc (-[pc]x) | de/dpc] (omega | upsilon), each slot's columns times
// its vertex's free flag.
#pragma once

#include "common.cuh"

namespace g2o_torch {

// One edge: the point (p0, p1, p2), the camera (t, q) at cam[0..7), the
// camera parameters (focal, cx, cy, baseline) at camp[0..4), the
// observation at obs[0..R); fl, fc the free flags of point and camera.
// The residual of one edge, r = obs - (f pc.xy / pc.z + c [, f (pc.x - b)
// / pc.z + cx]), and the point in the camera, pc = t + rotate(q, p)
template <typename T, int R>
__device__ __forceinline__ void xyz2uv_residual(
    T p0, T p1, T p2, const T* __restrict__ cam, const T* __restrict__ camp,
    const T* __restrict__ obs, T r[R], T pc[3]) {
  const T t0 = cam[0], t1 = cam[1], t2 = cam[2];
  const T qx = cam[3], qy = cam[4], qz = cam[5], qw = cam[6];
  // pc = t + rotate(q, p): v + 2 (w (u x v) + u x (u x v)), u = q.xyz
  T uv0 = qy * p2 - qz * p1, uv1 = qz * p0 - qx * p2, uv2 = qx * p1 - qy * p0;
  const T x = t0 + (p0 + T(2) * (qw * uv0 + (qy * uv2 - qz * uv1)));
  const T y = t1 + (p1 + T(2) * (qw * uv1 + (qz * uv0 - qx * uv2)));
  const T z = t2 + (p2 + T(2) * (qw * uv2 + (qx * uv1 - qy * uv0)));
  const T f = camp[0], cx = camp[1], cy = camp[2];
  r[0] = obs[0] - (x / z * f + cx);
  r[1] = obs[1] - (y / z * f + cy);
  if constexpr (R == 3) r[2] = obs[2] - ((x - camp[3]) / z * f + cx);
  pc[0] = x;
  pc[1] = y;
  pc[2] = z;
}

template <typename T, int R>
__device__ __forceinline__ void xyz2uv_linearize(
    T p0, T p1, T p2, const T* __restrict__ cam, const T* __restrict__ camp,
    const T* __restrict__ obs, T fl, T fc, T r[R], T jl[R][3],
    T jc[R][6]) {
  T pc[3];
  xyz2uv_residual<T, R>(p0, p1, p2, cam, camp, obs, r, pc);
  const T x = pc[0], y = pc[1], z = pc[2];
  const T qx = cam[3], qy = cam[4], qz = cam[5], qw = cam[6];
  const T f = camp[0];
  // de/dpc = -f [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2] (, [1/z, 0,
  // -(x - b)/z^2])]
  const T iz = T(1) / z;
  const T fiz = f * iz;
  T de[R][3];
  de[0][0] = -fiz;
  de[0][1] = T(0);
  de[0][2] = -(-fiz * x * iz);
  de[1][0] = T(0);
  de[1][1] = -fiz;
  de[1][2] = -(-fiz * y * iz);
  if constexpr (R == 3) {
    const T b = camp[3];
    de[2][0] = -fiz;
    de[2][1] = T(0);
    de[2][2] = -(-fiz * (x - b) * iz);
  }
  // R(q): column k = rotate(q, e_k)
  T Rm[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T v0 = k == 0 ? T(1) : T(0), v1 = k == 1 ? T(1) : T(0),
            v2 = k == 2 ? T(1) : T(0);
    const T a0 = qy * v2 - qz * v1, a1 = qz * v0 - qx * v2,
            a2 = qx * v1 - qy * v0;
    Rm[0][k] = v0 + T(2) * (qw * a0 + (qy * a2 - qz * a1));
    Rm[1][k] = v1 + T(2) * (qw * a1 + (qz * a0 - qx * a2));
    Rm[2][k] = v2 + T(2) * (qw * a2 + (qx * a1 - qy * a0));
  }
  const T gk[3][3] = {{T(0), -z, y}, {z, T(0), -x}, {-y, x, T(0)}};
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T sp = T(0), so = T(0);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        sp += de[a][m] * Rm[m][k];
        so += de[a][m] * gk[m][k];
      }
      jl[a][k] = sp * fl;
      jc[a][k] = -so * fc;
      jc[a][3 + k] = de[a][k] * fc;
    }
}

}  // namespace g2o_torch
