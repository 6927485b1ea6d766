// K16: fused SE3 edge linearizer.
//
// Replaces, in one pass over the edges of one group, the JAX chain
// `_edge_se3_error` (openslam_g2o_tpu/models/slam3d.py:70-73) on
// `se3_error_mqt` / `se3_retract_mqt` (ops/lie.py:236-268), `linearize`
// (core/problem.py:336-392, vmap(jacfwd) over the tangent-residual function)
// and `_edge_blocks` (core/sparse.py:620-636); ROADMAP K16.
//
// For each edge e = (i, j) with measurement Z (7), information Omega (6x6)
// and robust kernel `kernel_id` (core/robust.py ids):
//   e     = toVectorMQT(Z^-1 Xi^-1 Xj)
//   Ji,Jj = d e(retract(Xi, di), retract(Xj, dj)) / d(di, dj) at 0, in
//           forward mode over the same templated error code (se3_edge.cuh)
//           with a value-and-N-derivatives scalar, then the columns of
//           fixed vertices zeroed. An analytic formula for exact unit
//           quaternions would drop the 1/|q| factors of the
//           renormalizations that jacfwd differentiates through (stored
//           quaternions are unit only to rounding); the passes
//           differentiate exactly what the error computes, the sign flip
//           and the clamp included
//   W     = rho'(e^T Omega e) Omega
//   H_st  = J_s^T W J_t   for (s, t) in (i,i) (i,j) (j,i) (j,j)
//   b_s   = -J_s^T W e
//
// Layout: a block takes kEdgeBlock = 32 consecutive edges and 12 / ND warps.
// Warp p is the part (s, c0) = (p / (6 / ND), ND (p % (6 / ND))): its lane
// i differentiates edge i's error along tangent directions c0 .. c0+ND-1 of
// vertex s in one pass (a Jet of ND derivatives, so the pass's values,
// reciprocals and square roots serve all ND directions), which gives
// columns c0.. of J_s; the last part (the cheaper chain of s = 1 when
// ND = 6) also evaluates e and rho'. The block's edge records (Omega, Z,
// delta, the two poses) are staged in shared memory with every load of a
// thread in flight at once. After one barrier, the same part forms rows
// c0.. of J_s^T W, b_s and rows c0.. of H_s0 and H_s1 from J_0 and J_1 in
// shared memory, in the order of summation of the one-thread-per-edge
// form, so that every store of a warp is 32 consecutive edges of one
// stream row.
//
// Output: the per-edge contribution streams that kernel C gathers:
//   hblk [36, 4 * e_total]: entry r = 6a + c of block q = 2s + t of edge e
//        at hblk[r * 4 e_total + q * e_total + col0 + e]
//   bblk [6, 2 * e_total]: b_s[a] at bblk[a * 2 e_total + s * e_total + col0 + e]
// col0 is the edge group's first column, so several edge groups share one
// stream. e_total is the stream's width per block: core/sparse.py rounds it
// up to a multiple of 32 columns, so that a warp's stores fill whole
// 128-byte lines (at the sphere's odd 149,963 they would straddle two).
//
// Bound: memory. Per edge it reads 2 indices and 7 + 36 + 1 values and
// writes 156, and each vertex's 7 + 1 values are read once: 37.1 us at the
// sphere's 100,000 poses and 149,963 edges in float32. One thread per edge
// running the twelve directions one after another recomputed the error's
// value, its divisions and square roots in every pass and ran 188 us.
// What is left is the passes' arithmetic and the 94 MB of stores, which
// the card does not fully overlap.
#include "se3_edge.cuh"

namespace g2o_torch {

constexpr int kEdgeBlock = 32;
constexpr int kJacLd = 37;             // padded row of a staged 36-value block

template <typename T, int ND, int MIN_BLOCKS>
__global__ void __launch_bounds__(32 * 12 / ND, MIN_BLOCKS)
edge_se3_blocks_kernel(
    const T* __restrict__ params, const T* __restrict__ free_mask,
    const int* __restrict__ ii, const int* __restrict__ jj,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, int kernel_id, T* __restrict__ hblk,
    T* __restrict__ bblk, int n_edges, int e_total, int col0) {
  constexpr int kParts = 12 / ND, kBlock = 32 * kParts;
  __shared__ T s_info[kEdgeBlock][kJacLd];   // Omega of edge i, row-major
  __shared__ T s_meas[kEdgeBlock][7];
  __shared__ T s_pose[2][kEdgeBlock][7];     // X_i, X_j
  __shared__ T s_jac[2][kEdgeBlock][kJacLd]; // J_s[a][c] at 6a + c
  __shared__ T s_err[kEdgeBlock][7];         // e, then rho'
  __shared__ T s_free[2][kEdgeBlock];
  const int tid = threadIdx.x;
  const int lane = tid & 31, part = tid >> 5;
  const int s = part / (6 / ND), c0 = ND * (part % (6 / ND));
  const long long e0 = blockIdx.x * static_cast<long long>(kEdgeBlock);
  const int n = static_cast<int>(
      n_edges - e0 < kEdgeBlock ? n_edges - e0 : kEdgeBlock);
  {
    // Stage the block's records: thread tid takes values tid, tid + kBlock,
    // ... of each table, every load issued before any store, so that a
    // thread has all of them in flight at once (a strided loop would wait
    // on each load in turn). Omega and Z are runs of consecutive values;
    // the poses are gathered seven values a vertex, the vertex ids read
    // by the threads that gather them.
    constexpr int kMeas = (7 * kEdgeBlock + kBlock - 1) / kBlock;
    constexpr int kInfo = (36 * kEdgeBlock + kBlock - 1) / kBlock;
    constexpr int kPose = (14 * kEdgeBlock + kBlock - 1) / kBlock;
    T mv[kMeas], iv[kInfo], pv[kPose], fv = T(0);
    long long vid[kPose];
#pragma unroll
    for (int k = 0; k < kPose; ++k) {
      const int q = tid + k * kBlock, s = q >= 7 * n, i = (q - 7 * n * s) / 7;
      vid[k] = q < 14 * n ? (s ? jj : ii)[e0 + i] : 0;
    }
    const int fs = tid >= n, fi = tid - n * fs;
    const long long fvid = tid < 2 * n ? (fs ? jj : ii)[e0 + fi] : 0;
#pragma unroll
    for (int k = 0; k < kMeas; ++k) {
      const int q = tid + k * kBlock;
      if (q < 7 * n) mv[k] = meas[7 * e0 + q];
    }
#pragma unroll
    for (int k = 0; k < kInfo; ++k) {
      const int q = tid + k * kBlock;
      if (q < 36 * n) iv[k] = info[36 * e0 + q];
    }
#pragma unroll
    for (int k = 0; k < kPose; ++k) {
      const int q = tid + k * kBlock, r = q - 7 * n * (q >= 7 * n);
      if (q < 14 * n) pv[k] = params[7 * vid[k] + r % 7];
    }
    if (tid < 2 * n) fv = free_mask[fvid];
#pragma unroll
    for (int k = 0; k < kMeas; ++k) {
      const int q = tid + k * kBlock;
      if (q < 7 * n) s_meas[q / 7][q % 7] = mv[k];
    }
#pragma unroll
    for (int k = 0; k < kInfo; ++k) {
      const int q = tid + k * kBlock;
      if (q < 36 * n) s_info[q / 36][q % 36] = iv[k];
    }
#pragma unroll
    for (int k = 0; k < kPose; ++k) {
      const int q = tid + k * kBlock, s = q >= 7 * n, r = q - 7 * n * s;
      if (q < 14 * n) s_pose[s][r / 7][r % 7] = pv[k];
    }
    if (tid < 2 * n) s_free[fs][fi] = fv;
  }
  __syncthreads();

  if (lane < n) {
    T zinv[7];
    {
      T z[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) z[k] = s_meas[lane][k];
      se3_inverse(z, zinv);
    }
    if (part == kParts - 1) {
      T xi[7], xj[7], err[6];
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        xi[k] = s_pose[0][lane][k];
        xj[k] = s_pose[1][lane][k];
      }
      se3_error_mqt(zinv, xi, xj, err);
      T e2 = T(0);
#pragma unroll
      for (int a = 0; a < 6; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b)
          e2 += err[a] * s_info[lane][6 * a + b] * err[b];
#pragma unroll
      for (int a = 0; a < 6; ++a) s_err[lane][a] = err[a];
      s_err[lane][6] = robust_rho1<T>(kernel_id, e2, delta[e0 + lane]);
    }
    // jacfwd differentiates e(retract(Xi, di), retract(Xj, dj)) at 0: the
    // vertex that a pass does not move is still retracted by zero, which
    // renormalizes its stored quaternion
    typedef Jet<T, ND> J;
    T rest[7];
    {
      T x[7], zero[6];
#pragma unroll
      for (int k = 0; k < 7; ++k) x[k] = s_pose[1 - s][lane][k];
#pragma unroll
      for (int k = 0; k < 6; ++k) zero[k] = T(0);
      se3_retract_mqt(x, zero, rest);
    }
    J de[6];
    {
      T x[7];
      J step[6], moved[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) x[k] = s_pose[s][lane][k];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        step[k] = J(T(0));
#pragma unroll
        for (int m = 0; m < ND; ++m) step[k].d[m] = k == c0 + m ? T(1) : T(0);
      }
      se3_retract_mqt(x, step, moved);
      if (s == 0)
        se3_error_mqt(zinv, moved, rest, de);
      else
        se3_error_mqt(zinv, rest, moved, de);
    }
    const T fm = s_free[s][lane];
#pragma unroll
    for (int a = 0; a < 6; ++a)
#pragma unroll
      for (int m = 0; m < ND; ++m)
        s_jac[s][lane][6 * a + c0 + m] = de[a].d[m] * fm;
  }
  __syncthreads();
  if (lane >= n) return;

  // rows c0 .. c0+ND-1 of J_s^T W, each entry summed over c in order, with
  // rho' Omega read once; then b_s; then H_st = (J_s^T W) J_t for t = 0, 1
  // with J_t read once: 150 shared loads a thread instead of 470 row by row
  const long long ldh = 4LL * e_total, ldb = 2LL * e_total;
  const long long column = col0 + e0 + lane;
  const T* js = s_jac[s][lane];
  T jw[ND][6];
  {
    T om[6][6];
    const T rho1 = s_err[lane][6];
#pragma unroll
    for (int c = 0; c < 6; ++c)
#pragma unroll
      for (int b = 0; b < 6; ++b) om[c][b] = rho1 * s_info[lane][6 * c + b];
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      T col[6];                          // column c0 + m of J_s
#pragma unroll
      for (int c = 0; c < 6; ++c) col[c] = js[6 * c + c0 + m];
#pragma unroll
      for (int b = 0; b < 6; ++b) {
        T acc = T(0);
#pragma unroll
        for (int c = 0; c < 6; ++c) acc += col[c] * om[c][b];
        jw[m][b] = acc;
      }
    }
  }
  {
    T err[6];
#pragma unroll
    for (int b = 0; b < 6; ++b) err[b] = s_err[lane][b];
#pragma unroll
    for (int m = 0; m < ND; ++m) {
      T g = T(0);
#pragma unroll
      for (int b = 0; b < 6; ++b) g += jw[m][b] * err[b];
      bblk[(c0 + m) * ldb + s * static_cast<long long>(e_total) + column] =
          -g;
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const long long qcol = (2 * s + t) * static_cast<long long>(e_total)
                           + column;
    T jt[36];
#pragma unroll
    for (int q = 0; q < 36; ++q) jt[q] = s_jac[t][lane][q];
#pragma unroll
    for (int m = 0; m < ND; ++m)
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < 6; ++b) acc += jw[m][b] * jt[6 * b + c];
        hblk[(6 * (c0 + m) + c) * ldh + qcol] = acc;
      }
  }
}

// The thread layout follows T: in float32 6 directions a thread, two warps
// a tile of 32 edges, held to 128 registers (8 blocks a SM); in float64 3
// directions a thread, four warps, 128 registers (4 blocks a SM: a 6-wide
// Jet of doubles spills at 128 registers). Each was the faster of the two
// in its type on the H100 (PERF.md).
template <typename T>
struct K16Layout {
  static constexpr int kDirections = 6, kMinBlocks = 8;
};
template <>
struct K16Layout<double> {
  static constexpr int kDirections = 3, kMinBlocks = 4;
};

template <typename T>
int launch_edge_se3_blocks(const T* params, const T* free_mask, const int* ii,
                           const int* jj, const T* meas, const T* info,
                           const T* delta, int kernel_id, T* hblk, T* bblk,
                           int n_edges, int e_total, int col0,
                           cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  constexpr int ND = K16Layout<T>::kDirections;
  const int blocks = (n_edges + kEdgeBlock - 1) / kEdgeBlock;
  edge_se3_blocks_kernel<T, ND, K16Layout<T>::kMinBlocks>
      <<<blocks, 32 * 12 / ND, 0, stream>>>(
          params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk,
          bblk, n_edges, e_total, col0);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

int g2o_edge_se3_blocks_f32(const float* params, const float* free_mask,
                            const int* ii, const int* jj, const float* meas,
                            const float* info, const float* delta,
                            int kernel_id, float* hblk, float* bblk,
                            int n_edges, int e_total, int col0, void* stream) {
  return g2o_torch::launch_edge_se3_blocks<float>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

int g2o_edge_se3_blocks_f64(const double* params, const double* free_mask,
                            const int* ii, const int* jj, const double* meas,
                            const double* info, const double* delta,
                            int kernel_id, double* hblk, double* bblk,
                            int n_edges, int e_total, int col0, void* stream) {
  return g2o_torch::launch_edge_se3_blocks<double>(
      params, free_mask, ii, jj, meas, info, delta, kernel_id, hblk, bblk,
      n_edges, e_total, col0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
