// K3: LM damping, the Cholesky factor of every damped diagonal block and
// its inverse, and the scaled right-hand side, in one pass over the diagonal
// blocks. The block width D (3: SE2 poses, 6: SE3 poses, and 2: the
// point_xy group of LM-PCG over several vertex groups) is a template
// parameter.
//
// Replaces the JAX chain of one LM-PCG trial: `hot_diag_blocks` and the
// `extra` / `dblocks` lines of `_pcg_trial`
// (openslam_g2o_tpu/core/sparse.py:1143, core/algorithms.py:220-228),
// `batched_chol_inv_lower` and `batched_chol_lower`
// (core/solvers.py:63-139) and `lane_block_mv(linv_lane, bT)`
// (core/sparse.py:871).
//
//   extra[n] = lam * free[n] + (1 - free[n])
//   A = D_n + extra[n] I        D_n = slot 0 of values, entries [D*D, N]
//   A = L L^T                   column by column:
//                               L_jj = sqrt(A_jj - sum_{k<j} L_jk^2)
//                               L_ij = (A_ij - sum_{k<j} L_ik L_jk) / L_jj
//   M = L^-1                    M_ii = 1 / L_ii
//                               M_ij = -(sum_{j<=k<i} L_ik M_kj) M_ii
//   bhat[:, n] = M b[:, n]
//
// Unrolled at D = 3 this is the closed form of solvers.py:87-98, operation
// by operation; at D = 6 it is the same recurrence three columns further
// (the JAX package hands D > 3 to jnp.linalg.cholesky, solvers.py:105-108).
// One thread owns one block and keeps A's lower triangle, L and M in
// registers.
//
// lam is read through a pointer: every LM scalar lives on the device and
// the host never reads it. A non-SPD block takes the square root of a
// negative number, and that NaN spreads through every later entry of the
// factor's column and row recurrences; the NaN factors fail the CG solve and
// trigger the LM retry. Nothing is clamped (and the build has no
// -use_fast_math). The strictly upper entries of both factors are written
// as exact zeros.
//
// Bound: memory. One thread per block row reads D*D + 1 + D values and
// writes 2 D*D + D + 1; every access is coalesced (N is the minor axis).
#include "common.cuh"

namespace g2o_torch {

template <typename T, int D>
__global__ void damp_chol_kernel(const T* __restrict__ diag,
                                 const T* __restrict__ free_mask,
                                 const T* __restrict__ b,
                                 const T* __restrict__ lam_ptr,
                                 T* __restrict__ linv, T* __restrict__ lchol,
                                 T* __restrict__ bhat, T* __restrict__ extra,
                                 int n) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  const T lam = lam_ptr[0];
  const T f = free_mask[row];
  const T e = lam * f + (T(1) - f);
  const T* d = diag + row;

  T L[D][D], M[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      L[i][j] = T(0);
      M[i][j] = T(0);
    }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T s = d[(D * j + j) * N] + e;
#pragma unroll
    for (int k = 0; k < j; ++k) s -= L[j][k] * L[j][k];
    L[j][j] = dsqrt(s);
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T t = d[(D * i + j) * N];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= L[i][k] * L[j][k];
      L[i][j] = t / L[j][j];
    }
  }
#pragma unroll
  for (int i = 0; i < D; ++i) M[i][i] = T(1) / L[i][i];
#pragma unroll
  for (int j = 0; j < D; ++j)
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T s = L[i][j] * M[j][j];
#pragma unroll
      for (int k = j + 1; k < i; ++k) s += L[i][k] * M[k][j];
      M[i][j] = -s * M[i][i];
    }

#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      lchol[(D * i + j) * N + row] = L[i][j];
      linv[(D * i + j) * N + row] = M[i][j];
    }
  T bv[D];
#pragma unroll
  for (int a = 0; a < D; ++a) bv[a] = b[a * N + row];
  // the full product, zeros included, as the plain version forms it (a
  // non-finite b entry then shows in every row, there and here)
#pragma unroll
  for (int a = 0; a < D; ++a) {
    T acc = M[a][0] * bv[0];
#pragma unroll
    for (int c = 1; c < D; ++c) acc += M[a][c] * bv[c];
    bhat[a * N + row] = acc;
  }
  extra[row] = e;
}

template <typename T, int D>
int run_damp_chol(const T* diag, const T* free_mask, const T* b, const T* lam,
                  T* linv, T* lchol, T* bhat, T* extra, int n,
                  cudaStream_t stream) {
  damp_chol_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n);
  return launch_status();
}

template <typename T>
int launch_damp_chol(const T* diag, const T* free_mask, const T* b,
                     const T* lam, T* linv, T* lchol, T* bhat, T* extra,
                     int n, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 2:
      return run_damp_chol<T, 2>(diag, free_mask, b, lam, linv, lchol, bhat,
                                 extra, n, stream);
    case 3:
      return run_damp_chol<T, 3>(diag, free_mask, b, lam, linv, lchol, bhat,
                                 extra, n, stream);
    case 6:
      return run_damp_chol<T, 6>(diag, free_mask, b, lam, linv, lchol, bhat,
                                 extra, n, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace g2o_torch

extern "C" {

int g2o_damp_chol_f32(const float* diag, const float* free_mask,
                      const float* b, const float* lam, float* linv,
                      float* lchol, float* bhat, float* extra, int n, int d,
                      void* stream) {
  return g2o_torch::launch_damp_chol<float>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_damp_chol_f64(const double* diag, const double* free_mask,
                      const double* b, const double* lam, double* linv,
                      double* lchol, double* bhat, double* extra, int n,
                      int d, void* stream) {
  return g2o_torch::launch_damp_chol<double>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n, d,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
