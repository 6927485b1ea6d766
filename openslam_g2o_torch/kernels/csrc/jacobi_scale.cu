// K4: symmetric block-Jacobi scaling of the damped block-ELL Hessian, and
// the per-row 3x3 block applications around the CG solve.
//
// `jacobi_scale` replaces `hot_add_diag` + `hot_scale_jacobi`
// (openslam_g2o_tpu/core/sparse.py:1173-1247):
//
//   S[k, :, n] = M_n (B[k, :, n] + [k = 0] extra[n] I) M_{nb[k, n]}^T
//
// with M = L^-1 of the damped diagonal blocks, entries [9, N] (K3). The
// damping is folded in while the diagonal slot is read, so no damped copy
// of the values is made, and the neighbour's factor is gathered inside the
// kernel. The TPU code's DIA shift stack, its hoisted transposed index
// tables and the two-tier split after the scaling were layout decisions
// for lane gathers; here one thread owns one block row and loops over its
// K slots in order.
//
// An off-diagonal slot whose nine entries are all zero (every padding
// slot: column 0, zero values) is written as exact zeros without touching
// the factors, so a NaN factor of row 0 or of the row itself does not leak
// into the padding: 0 * NaN would turn every padded row into NaN.
//
// `lane_block_mv` replaces `lane_block_mv` (core/sparse.py:871-880) for
// the unscale dx = M^T xhat and the warm start xhat0 = L^T dx0.
//
// Bound: memory. jacobi_scale reads and writes the values once (9 K N
// each) plus K indices and 9 K gathered factor entries per row; the
// factor table (9 N values) stays in L2 at pose-graph sizes.
#include "common.cuh"

namespace g2o_torch {

template <typename T>
__global__ void jacobi_scale_kernel(const int* __restrict__ nb,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ linv,
                                    const T* __restrict__ extra,
                                    T* __restrict__ out, int n, int k_width) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T Mi[9];
  for (int q = 0; q < 9; ++q) Mi[q] = linv[q * N + row];
  const T e = extra[row];
  for (int k = 0; k < k_width; ++k) {
    const T* v = vals + k * 9 * N + row;
    T* o = out + k * 9 * N + row;
    T B[9];
    bool all_zero = true;
    for (int q = 0; q < 9; ++q) {
      B[q] = v[q * N];
      all_zero = all_zero && (B[q] == T(0));
    }
    if (k == 0) {
      B[0] += e;
      B[4] += e;
      B[8] += e;
    } else if (all_zero) {
      for (int q = 0; q < 9; ++q) o[q * N] = T(0);
      continue;
    }
    const long long col = nb[k * N + row];
    T Mj[9];
    for (int q = 0; q < 9; ++q) Mj[q] = linv[q * N + col];
    // C = M_i B, then S = C M_j^T; full products in index order, as the
    // plain version sums them
    T C[9];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        C[3 * a + c] = Mi[3 * a] * B[c] + Mi[3 * a + 1] * B[3 + c]
                       + Mi[3 * a + 2] * B[6 + c];
    for (int a = 0; a < 3; ++a)
      for (int d = 0; d < 3; ++d)
        o[(3 * a + d) * N] = C[3 * a] * Mj[3 * d]
                             + C[3 * a + 1] * Mj[3 * d + 1]
                             + C[3 * a + 2] * Mj[3 * d + 2];
  }
}

// y[a, n] = sum_b M[a, b, n] x[b, n]; transpose: sum_b M[b, a, n] x[b, n].
template <typename T>
__global__ void lane_block_mv_kernel(const T* __restrict__ mats,
                                     const T* __restrict__ x,
                                     T* __restrict__ y, int n, int transpose) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  const T x0 = x[row];
  const T x1 = x[N + row];
  const T x2 = x[2 * N + row];
  for (int a = 0; a < 3; ++a) {
    const int q0 = transpose ? a : 3 * a;
    const int step = transpose ? 3 : 1;
    y[a * N + row] = mats[q0 * N + row] * x0
                     + mats[(q0 + step) * N + row] * x1
                     + mats[(q0 + 2 * step) * N + row] * x2;
  }
}

template <typename T>
int launch_jacobi_scale(const int* nb, const T* vals, const T* linv,
                        const T* extra, T* out, int n, int k_width,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  jacobi_scale_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, linv, extra, out, n, k_width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lane_block_mv(const T* mats, const T* x, T* y, int n,
                         int transpose, cudaStream_t stream) {
  if (n <= 0) return 0;
  lane_block_mv_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      mats, x, y, n, transpose);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2o_torch

extern "C" {

int g2o_jacobi_scale_f32(const int* nb, const float* vals, const float* linv,
                         const float* extra, float* out, int n, int k_width,
                         void* stream) {
  return g2o_torch::launch_jacobi_scale<float>(
      nb, vals, linv, extra, out, n, k_width,
      static_cast<cudaStream_t>(stream));
}

int g2o_jacobi_scale_f64(const int* nb, const double* vals,
                         const double* linv, const double* extra, double* out,
                         int n, int k_width, void* stream) {
  return g2o_torch::launch_jacobi_scale<double>(
      nb, vals, linv, extra, out, n, k_width,
      static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f32(const float* mats, const float* x, float* y, int n,
                          int transpose, void* stream) {
  return g2o_torch::launch_lane_block_mv<float>(
      mats, x, y, n, transpose, static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f64(const double* mats, const double* x, double* y,
                          int n, int transpose, void* stream) {
  return g2o_torch::launch_lane_block_mv<double>(
      mats, x, y, n, transpose, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
