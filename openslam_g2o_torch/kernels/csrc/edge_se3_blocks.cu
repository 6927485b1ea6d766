// K16: fused SE3 edge linearizer.
//
// Replaces, in one pass over the edges of one group, the JAX chain
// `_edge_se3_error` (openslam_g2o_tpu/models/slam3d.py:70-73) on
// `se3_error_mqt` / `se3_retract_mqt` (ops/lie.py:236-268), `linearize`
// (core/problem.py:336-392, vmap(jacfwd) over the tangent-residual function)
// and `_edge_blocks` (core/sparse.py:620-636); ROADMAP K16.
//
// One thread per edge e = (i, j) with measurement Z (7), information Omega
// (6x6) and robust kernel `kernel_id` (core/robust.py ids):
//   e     = toVectorMQT(Z^-1 Xi^-1 Xj)
//   Ji,Jj = d e(retract(Xi, di), retract(Xj, dj)) / d(di, dj) at 0, in
//           forward mode: twelve passes over the same templated error code
//           with a value-and-one-derivative scalar (se3_edge.cuh), one
//           tangent direction each, then the columns of fixed vertices
//           zeroed. An analytic formula for exact unit quaternions would
//           drop the 1/|q| factors of the renormalizations that jacfwd
//           differentiates through (stored quaternions are unit only to
//           rounding); the passes differentiate exactly what the error
//           computes, the sign flip and the clamp included
//   W     = rho'(e^T Omega e) Omega
//   H_st  = J_s^T W J_t   for (s, t) in (i,i) (i,j) (j,i) (j,j)
//   b_s   = -J_s^T W e
//
// The 72 Jacobian entries of a thread live in shared memory (one column per
// thread, so no bank conflicts and no barrier), Omega in registers; the
// products are staged per row of J_s^T W, so no 6x6 product is ever held
// whole.
//
// Output: the per-edge contribution streams that kernel C gathers:
//   hblk [36, 4 * e_total]: entry r = 6a + c of block q = 2s + t of edge e
//        at hblk[r * 4 e_total + q * e_total + col0 + e]
//   bblk [6, 2 * e_total]: b_s[a] at bblk[a * 2 e_total + s * e_total + col0 + e]
// col0 is the edge group's first column, so several edge groups share one
// stream. Edge-minor columns make every store coalesce.
//
// Bound: memory. Per edge it reads 2 indices and 14 + 2 + 7 + 36 + 1 values
// and writes 156; the thirteen error evaluations are about 4,000 flops.
#include "se3_edge.cuh"

namespace g2o_torch {

constexpr int kEdgeThreads = 64;

template <typename T>
__global__ void edge_se3_blocks_kernel(
    const T* __restrict__ params, const T* __restrict__ free_mask,
    const int* __restrict__ ii, const int* __restrict__ jj,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, int kernel_id, T* __restrict__ hblk,
    T* __restrict__ bblk, int n_edges, int e_total, int col0) {
  __shared__ T jac[72][kEdgeThreads];    // J_s[a][c] at 36 s + 6 a + c
  const int tid = threadIdx.x;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x) + tid;
  if (e >= n_edges) return;
  const long long vi = ii[e], vj = jj[e];
  T x[2][7], z[7], zinv[7];
  for (int k = 0; k < 7; ++k) {
    x[0][k] = params[7 * vi + k];
    x[1][k] = params[7 * vj + k];
    z[k] = meas[7 * e + k];
  }
  se3_inverse(z, zinv);
  T err[6];
  se3_error_mqt(zinv, x[0], x[1], err);

  // jacfwd differentiates e(retract(Xi, di), retract(Xj, dj)) at 0: the
  // vertex that a pass does not move is still retracted by zero, which
  // renormalizes its stored quaternion
  typedef Dual<T> S;
  S zinv_d[7];
  for (int k = 0; k < 7; ++k) zinv_d[k] = S(zinv[k]);
  T rest[2][7];
  {
    T zero[6];
    for (int k = 0; k < 6; ++k) zero[k] = T(0);
    se3_retract_mqt(x[0], zero, rest[0]);
    se3_retract_mqt(x[1], zero, rest[1]);
  }
  const T fmask[2] = {free_mask[vi], free_mask[vj]};
#pragma unroll 1
  for (int col = 0; col < 12; ++col) {
    const int s = col / 6, c = col - 6 * s;
    S step[6], at[7], moved[7], xs[2][7];
    for (int k = 0; k < 6; ++k) step[k] = S(T(0), k == c ? T(1) : T(0));
    for (int k = 0; k < 7; ++k) at[k] = S(x[s][k]);
    se3_retract_mqt(at, step, moved);
    for (int k = 0; k < 7; ++k) {
      xs[0][k] = s == 0 ? moved[k] : S(rest[0][k]);
      xs[1][k] = s == 1 ? moved[k] : S(rest[1][k]);
    }
    S de[6];
    se3_error_mqt(zinv_d, xs[0], xs[1], de);
    for (int a = 0; a < 6; ++a) jac[36 * s + 6 * a + c][tid] = de[a].d * fmask[s];
  }

  T om[6][6];
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) om[a][b] = info[36 * e + 6 * a + b];
  T e2 = T(0);
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) e2 += err[a] * om[a][b] * err[b];
  const T rho1 = robust_rho1<T>(kernel_id, e2, delta[e]);
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int b = 0; b < 6; ++b) om[a][b] = rho1 * om[a][b];

  const long long ldh = 4LL * e_total, ldb = 2LL * e_total;
  const long long column = col0 + e;
#pragma unroll 1
  for (int s = 0; s < 2; ++s) {
#pragma unroll 1
    for (int a = 0; a < 6; ++a) {
      T jw[6];                           // row a of J_s^T (rho' Omega)
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += jac[36 * s + 6 * c + a][tid] * om[c][b];
        jw[b] = acc;
      }
      T g = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) g += jw[b] * err[b];
      bblk[a * ldb + s * static_cast<long long>(e_total) + column] = -g;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const long long qcol = (2 * s + t) * static_cast<long long>(e_total)
                               + column;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          T acc = T(0);
#pragma unroll
          for (int b = 0; b < 6; ++b) acc += jw[b] * jac[36 * t + 6 * b + c][tid];
          hblk[(6 * a + c) * ldh + qcol] = acc;
        }
      }
    }
  }
}

template <typename T>
int launch_edge_se3_blocks(const T* params, const T* free_mask, const int* ii,
                           const int* jj, const T* meas, const T* info,
                           const T* delta, int kernel_id, T* hblk, T* bblk,
                           int n_edges, int e_total, int col0,
                           cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  const int blocks = (n_edges + kEdgeThreads - 1) / kEdgeThreads;
  edge_se3_blocks_kernel<T><<<blocks, kEdgeThreads, 0, stream>>>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

int g2o_edge_se3_blocks_f32(const float* params, const float* free_mask,
                            const int* ii, const int* jj, const float* meas,
                            const float* info, const float* delta,
                            int kernel_id, float* hblk, float* bblk,
                            int n_edges, int e_total, int col0,
                            void* stream) {
  return g2o_torch::launch_edge_se3_blocks<float>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

int g2o_edge_se3_blocks_f64(const double* params, const double* free_mask,
                            const int* ii, const int* jj, const double* meas,
                            const double* info, const double* delta,
                            int kernel_id, double* hblk, double* bblk,
                            int n_edges, int e_total, int col0,
                            void* stream) {
  return g2o_torch::launch_edge_se3_blocks<double>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
