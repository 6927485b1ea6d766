// Kernel B: fused SE2 edge linearizer.
//
// Replaces, in one pass over the edges, the JAX chain
// `_edge_se2_error` (openslam_g2o_tpu/models/slam2d.py:62),
// `_edge_se2_jacobian` (:76), `linearize` (core/problem.py:350-392) and
// `_edge_blocks` (core/sparse.py:620-636); ROADMAP K1.
//
// One thread per edge e = (i, j) with measurement Z, information Omega and
// robust kernel `kernel_id` (core/robust.py ids):
//   e     = (Z^-1 (Xi^-1 Xj)).toVector()   angle wrapped by the floor formula
//   Ji,Jj = analytic Jacobians, columns of fixed vertices zeroed
//   W     = rho'(e^T Omega e) Omega
//   H_st  = J_s^T W J_t   for (s, t) in (i,i) (i,j) (j,i) (j,j)
//   b_s   = -J_s^T W e
// The (j, i) block is computed as Jj^T W Ji, as the JAX code does, not as
// the transpose of (i, j).
//
// Output: the per-edge contribution streams that kernel C gathers:
//   hblk [9, 4 * e_total]: entry r = 3a + c of block q = 2s + t of edge e
//        at hblk[r * 4 e_total + q * e_total + col0 + e]
//   bblk [3, 2 * e_total]: b_s[a] at bblk[a * 2 e_total + s * e_total + col0 + e]
// col0 is the edge group's first column, so several edge groups (one per
// robust kernel) share one stream.
//
// Bound: memory. Per edge it reads 2 index + 6 param + 1 free + 3 meas +
// 9 info + 1 delta values and writes 42; about 200 flops and 6
// sin/cos. Edge-minor output columns make every store coalesce; the two
// vertex gathers are the only irregular loads.
#include "se2_edge.cuh"

namespace g2o_torch {

template <typename T>
__global__ void edge_se2_blocks_kernel(
    const T* __restrict__ params, const T* __restrict__ free_mask,
    const int* __restrict__ ii, const int* __restrict__ jj,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, int kernel_id, T* __restrict__ hblk,
    T* __restrict__ bblk, int n_edges, int e_total, int col0) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= n_edges) return;
  const long long vi = ii[e], vj = jj[e];
  const T xi0 = params[3 * vi], xi1 = params[3 * vi + 1],
          xi2 = params[3 * vi + 2];
  const T xj0 = params[3 * vj], xj1 = params[3 * vj + 1],
          xj2 = params[3 * vj + 2];
  const T z0 = meas[3 * e], z1 = meas[3 * e + 1], z2 = meas[3 * e + 2];

  // error, in the operation order of lie.se2_error(se2_inverse(Z), Xi, Xj)
  T err[3], cz, sz, ci, si;
  se2_edge_error(xi0, xi1, xi2, xj0, xj1, xj2, z0, z1, z2, err, cz, sz, ci,
                 si);

  // analytic Jacobians (slam2d.py:76-112), fixed columns zeroed
  const T fm[2] = {free_mask[vi], free_mask[vj]};
  T J[2][3][3];
  se2_edge_jacobians(xi0, xi1, xj0, xj1, cz, sz, ci, si, J);
  for (int s = 0; s < 2; ++s)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) J[s][a][b] = J[s][a][b] * fm[s];

  T om[3][3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) om[a][b] = info[9 * e + 3 * a + b];
  T e2 = T(0);
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) e2 += err[a] * om[a][b] * err[b];
  const T rho1 = robust_rho1<T>(kernel_id, e2, delta[e]);

  const long long ldh = 4LL * e_total, ldb = 2LL * e_total;
  const long long col = col0 + e;
  for (int s = 0; s < 2; ++s) {
    T jw[3][3];                      // J_s^T (rho' Omega)
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        T acc = T(0);
        for (int c = 0; c < 3; ++c) acc += J[s][c][a] * (rho1 * om[c][b]);
        jw[a][b] = acc;
      }
    for (int a = 0; a < 3; ++a) {
      T acc = T(0);
      for (int b = 0; b < 3; ++b) acc += jw[a][b] * err[b];
      bblk[a * ldb + s * static_cast<long long>(e_total) + col] = -acc;
    }
    for (int t = 0; t < 2; ++t) {
      const long long qcol = (2 * s + t) * static_cast<long long>(e_total)
                             + col;
      for (int a = 0; a < 3; ++a)
        for (int c = 0; c < 3; ++c) {
          T acc = T(0);
          for (int b = 0; b < 3; ++b) acc += jw[a][b] * J[t][b][c];
          hblk[(3 * a + c) * ldh + qcol] = acc;
        }
    }
  }
}

template <typename T>
int launch_edge_se2_blocks(const T* params, const T* free_mask, const int* ii,
                           const int* jj, const T* meas, const T* info,
                           const T* delta, int kernel_id, T* hblk, T* bblk,
                           int n_edges, int e_total, int col0,
                           cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  edge_se2_blocks_kernel<T><<<grid_for(n_edges), kThreads, 0, stream>>>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2o_torch

extern "C" {

int g2o_edge_se2_blocks_f32(const float* params, const float* free_mask,
                            const int* ii, const int* jj, const float* meas,
                            const float* info, const float* delta,
                            int kernel_id, float* hblk, float* bblk,
                            int n_edges, int e_total, int col0,
                            void* stream) {
  return g2o_torch::launch_edge_se2_blocks<float>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

int g2o_edge_se2_blocks_f64(const double* params, const double* free_mask,
                            const int* ii, const int* jj, const double* meas,
                            const double* info, const double* delta,
                            int kernel_id, double* hblk, double* bblk,
                            int n_edges, int e_total, int col0,
                            void* stream) {
  return g2o_torch::launch_edge_se2_blocks<double>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
