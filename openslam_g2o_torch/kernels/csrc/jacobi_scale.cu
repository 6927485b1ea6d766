// K4: symmetric block-Jacobi scaling of the damped block-ELL Hessian, and
// the per-row DxD block applications around the CG solve, D in {3, 6}.
//
// `jacobi_scale` replaces `hot_add_diag` + `hot_scale_jacobi`
// (openslam_g2o_tpu/core/sparse.py:1173-1247):
//
//   S[k, :, n] = M_n (B[k, :, n] + [k = 0] extra[n] I) M_{nb[k, n]}^T
//
// with M = L^-1 of the damped diagonal blocks, entries [D*D, N] (K3). The
// damping is folded in while the diagonal slot is read, so no damped copy
// of the values is made, and the neighbour's factor is gathered inside the
// kernel. The TPU code's DIA shift stack, its hoisted transposed index
// tables and the two-tier split after the scaling were layout decisions
// for lane gathers; here one thread owns one block row and loops over its
// K slots in order.
//
// An off-diagonal slot whose D*D entries are all zero (every padding
// slot: column 0, zero values) is written as exact zeros without touching
// the factors, so a NaN factor of row 0 or of the row itself does not leak
// into the padding: 0 * NaN would turn every padded row into NaN.
//
// `lane_block_mv` replaces `lane_block_mv` (core/sparse.py:871-880) for
// the unscale dx = M^T xhat and the warm start xhat0 = L^T dx0, and applies
// the block-Jacobi preconditioners of both Schur paths; it is also built at
// D = 4, the intrinsics group of the general Schur path (core/ba.py), at
// D = 9, the BAL camera (models/bal.py) on the implicit dual-ELL route, and
// at D = 2, the point_xy group of LM-PCG over several vertex groups.
//
// Registers: the thread holds M_i for all its slots and, per slot, B and
// M_j; the product is staged row by row (one row of C = M_i B, then that
// row of S), so at D = 6 three 36-value operands are live, not five.
//
// Bound: memory. jacobi_scale reads and writes the values once (D*D K N
// each) plus K indices and D*D K gathered factor entries per row; the
// factor table (D*D N values) stays in L2 at pose-graph sizes.
#include "common.cuh"

namespace g2o_torch {

template <typename T, int D>
__global__ void jacobi_scale_kernel(const int* __restrict__ nb,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ linv,
                                    const T* __restrict__ extra,
                                    T* __restrict__ out, int n, int k_width) {
  constexpr int DD = D * D;
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T Mi[DD];
#pragma unroll
  for (int q = 0; q < DD; ++q) Mi[q] = linv[q * N + row];
  const T e = extra[row];
  for (int k = 0; k < k_width; ++k) {
    const T* v = vals + static_cast<long long>(k) * DD * N + row;
    T* o = out + static_cast<long long>(k) * DD * N + row;
    T B[DD];
    bool all_zero = true;
#pragma unroll
    for (int q = 0; q < DD; ++q) {
      B[q] = v[q * N];
      all_zero = all_zero && (B[q] == T(0));
    }
    if (k == 0) {
#pragma unroll
      for (int a = 0; a < D; ++a) B[(D + 1) * a] += e;
    } else if (all_zero) {
#pragma unroll
      for (int q = 0; q < DD; ++q) o[q * N] = T(0);
      continue;
    }
    const long long col = nb[k * N + row];
    T Mj[DD];
#pragma unroll
    for (int q = 0; q < DD; ++q) Mj[q] = linv[q * N + col];
    // row a of C = M_i B, then row a of S = C M_j^T; full products in
    // index order, as the plain version sums them
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T C[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        T acc = Mi[D * a] * B[c];
#pragma unroll
        for (int b = 1; b < D; ++b) acc += Mi[D * a + b] * B[D * b + c];
        C[c] = acc;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        T acc = C[0] * Mj[D * d];
#pragma unroll
        for (int c = 1; c < D; ++c) acc += C[c] * Mj[D * d + c];
        o[(D * a + d) * N] = acc;
      }
    }
  }
}

// y[a, n] = sum_b M[a, b, n] x[b, n]; transpose: sum_b M[b, a, n] x[b, n].
template <typename T, int D>
__global__ void lane_block_mv_kernel(const T* __restrict__ mats,
                                     const T* __restrict__ x,
                                     T* __restrict__ y, int n, int transpose) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T xv[D];
#pragma unroll
  for (int b = 0; b < D; ++b) xv[b] = x[b * N + row];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const int q0 = transpose ? a : D * a;
    const int step = transpose ? D : 1;
    T acc = mats[q0 * N + row] * xv[0];
#pragma unroll
    for (int b = 1; b < D; ++b) acc += mats[(q0 + b * step) * N + row] * xv[b];
    y[a * N + row] = acc;
  }
}

template <typename T, int D>
int run_jacobi_scale(const int* nb, const T* vals, const T* linv,
                     const T* extra, T* out, int n, int k_width,
                     cudaStream_t stream) {
  jacobi_scale_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, linv, extra, out, n, k_width);
  return launch_status();
}

template <typename T>
int launch_jacobi_scale(const int* nb, const T* vals, const T* linv,
                        const T* extra, T* out, int n, int k_width, int d,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 3:
      return run_jacobi_scale<T, 3>(nb, vals, linv, extra, out, n, k_width,
                                    stream);
    case 6:
      return run_jacobi_scale<T, 6>(nb, vals, linv, extra, out, n, k_width,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int run_lane_block_mv(const T* mats, const T* x, T* y, int n, int transpose,
                      cudaStream_t stream) {
  lane_block_mv_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      mats, x, y, n, transpose);
  return launch_status();
}

template <typename T>
int launch_lane_block_mv(const T* mats, const T* x, T* y, int n,
                         int transpose, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 2: return run_lane_block_mv<T, 2>(mats, x, y, n, transpose, stream);
    case 3: return run_lane_block_mv<T, 3>(mats, x, y, n, transpose, stream);
    case 4: return run_lane_block_mv<T, 4>(mats, x, y, n, transpose, stream);
    case 6: return run_lane_block_mv<T, 6>(mats, x, y, n, transpose, stream);
    case 9: return run_lane_block_mv<T, 9>(mats, x, y, n, transpose, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace g2o_torch

extern "C" {

int g2o_jacobi_scale_f32(const int* nb, const float* vals, const float* linv,
                         const float* extra, float* out, int n, int k_width,
                         int d, void* stream) {
  return g2o_torch::launch_jacobi_scale<float>(
      nb, vals, linv, extra, out, n, k_width, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_jacobi_scale_f64(const int* nb, const double* vals,
                         const double* linv, const double* extra, double* out,
                         int n, int k_width, int d, void* stream) {
  return g2o_torch::launch_jacobi_scale<double>(
      nb, vals, linv, extra, out, n, k_width, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f32(const float* mats, const float* x, float* y, int n,
                          int transpose, int d, void* stream) {
  return g2o_torch::launch_lane_block_mv<float>(
      mats, x, y, n, transpose, d, static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f64(const double* mats, const double* x, double* y,
                          int n, int transpose, int d, void* stream) {
  return g2o_torch::launch_lane_block_mv<double>(
      mats, x, y, n, transpose, d, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
