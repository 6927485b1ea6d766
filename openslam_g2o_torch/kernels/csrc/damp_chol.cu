// K3: LM damping, closed-form 3x3 Cholesky and its inverse, and the scaled
// right-hand side, in one pass over the diagonal blocks.
//
// Replaces the JAX chain of one LM-PCG trial: `hot_diag_blocks` and the
// `extra` / `dblocks` lines of `_pcg_trial`
// (openslam_g2o_tpu/core/sparse.py:1143, core/algorithms.py:220-228),
// `batched_chol_inv_lower` and `batched_chol_lower`
// (core/solvers.py:63-139) and `lane_block_mv(linv_lane, bT)`
// (core/sparse.py:871).
//
//   extra[n] = lam * free[n] + (1 - free[n])
//   A = D_n + extra[n] I        D_n = slot 0 of values, entries [9, N]
//   A = L L^T, M = L^-1         operation order of solvers.py:87-98
//   bhat[:, n] = M b[:, n]
//
// lam is read through a pointer: every LM scalar lives on the device and
// the host never reads it. A non-SPD block takes the square root of a
// negative number and yields NaN factors, which fail the CG solve and
// trigger the LM retry; nothing is clamped (and the build has no
// -use_fast_math). The strictly upper entries of both factors are written
// as exact zeros.
//
// Bound: memory. One thread per block row reads 9 + 1 + 3 values and
// writes 9 + 9 + 3 + 1; every access is coalesced (N is the minor axis).
#include "common.cuh"

namespace g2o_torch {

template <typename T>
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
  const T a00 = d[0] + e;
  const T a10 = d[3 * N];
  const T a11 = d[4 * N] + e;
  const T a20 = d[6 * N];
  const T a21 = d[7 * N];
  const T a22 = d[8 * N] + e;

  const T l11 = dsqrt(a00);
  const T l21 = a10 / l11;
  const T l31 = a20 / l11;
  const T l22 = dsqrt(a11 - l21 * l21);
  const T l32 = (a21 - l31 * l21) / l22;
  const T l33 = dsqrt(a22 - l31 * l31 - l32 * l32);
  const T m11 = T(1) / l11;
  const T m22 = T(1) / l22;
  const T m33 = T(1) / l33;
  const T m21 = -(l21 * m11) * m22;
  const T m31 = -(l31 * m11 + l32 * m21) * m33;
  const T m32 = -(l32 * m22) * m33;

  const T zero = T(0);
  const T L[9] = {l11, zero, zero, l21, l22, zero, l31, l32, l33};
  const T M[9] = {m11, zero, zero, m21, m22, zero, m31, m32, m33};
  for (int q = 0; q < 9; ++q) {
    lchol[q * N + row] = L[q];
    linv[q * N + row] = M[q];
  }
  const T b0 = b[row];
  const T b1 = b[N + row];
  const T b2 = b[2 * N + row];
  // the full product, zeros included, as the plain version forms it (a
  // non-finite b entry then shows in every row, there and here)
  for (int a = 0; a < 3; ++a)
    bhat[a * N + row] = M[3 * a] * b0 + M[3 * a + 1] * b1 + M[3 * a + 2] * b2;
  extra[row] = e;
}

template <typename T>
int launch_damp_chol(const T* diag, const T* free_mask, const T* b,
                     const T* lam, T* linv, T* lchol, T* bhat, T* extra,
                     int n, cudaStream_t stream) {
  if (n <= 0) return 0;
  damp_chol_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2o_torch

extern "C" {

int g2o_damp_chol_f32(const float* diag, const float* free_mask,
                      const float* b, const float* lam, float* linv,
                      float* lchol, float* bhat, float* extra, int n,
                      void* stream) {
  return g2o_torch::launch_damp_chol<float>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n,
      static_cast<cudaStream_t>(stream));
}

int g2o_damp_chol_f64(const double* diag, const double* free_mask,
                      const double* b, const double* lam, double* linv,
                      double* lchol, double* bhat, double* extra, int n,
                      void* stream) {
  return g2o_torch::launch_damp_chol<double>(
      diag, free_mask, b, lam, linv, lchol, bhat, extra, n,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
