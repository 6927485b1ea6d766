// K8: the Chebyshev polynomial preconditioner of the LM-PCG trial solve and
// the Gershgorin bound that brackets its spectrum.
//
// Replaces `hot_gershgorin_bound` / `ell_gershgorin_bound`
// (openslam_g2o_tpu/core/sparse.py:1270-1289, :787-817) and the scalar and
// vector work of `make_chebyshev_precond` (core/solvers.py:167-210; Saad,
// Iterative Methods for Sparse Linear Systems, Alg. 12.1):
//
//   hi    = max(max_{a, n} sum_{k, c} |S[k, D a + c, n]|, 1e-3), D in {3, 6}
//   theta = (hi + lo) / 2, delta = max((hi - lo) / 2, 1e-12),
//   sigma1 = theta / delta, rho_0 = 1 / sigma1,
//   rho_j = 1 / (2 sigma1 - rho_{j-1});  pair j: (rho_j rho_{j-1},
//                                                 2 rho_j / delta)
//   d = r / theta; z = d; then per pair: d = c1 d + c2 (r - S z); z += d
//
// The matvecs S z between the updates are kernel A. hi, lo and the
// coefficient pairs never leave the device: the bound is a two-pass max
// reduction (per-block maxima, then one block), the coefficients are
// computed by one thread into a small array that the vector kernels read.
// A NaN in S gives a NaN bound, as jnp.max does.
//
// Bound: memory. The Gershgorin pass reads the values once (D*D K N); the
// vector kernels move three (init) and six (update) CG vectors.
#include "common.cuh"

namespace g2o_torch {

template <typename T>
__device__ __forceinline__ T dabs(T v) { return v < T(0) ? -v : v; }

template <typename T, int D>
__global__ void gershgorin_rows_kernel(const T* __restrict__ vals,
                                       T* __restrict__ partials, int n,
                                       int k_width) {
  __shared__ T smem[32];
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long N = n;
  T m = T(0);
  if (row < n) {
    T s[D];
#pragma unroll
    for (int a = 0; a < D; ++a) s[a] = T(0);
    for (int k = 0; k < k_width; ++k) {
      const T* v = vals + static_cast<long long>(k) * (D * D) * N + row;
#pragma unroll
      for (int q = 0; q < D * D; ++q) s[q / D] += dabs(v[q * N]);
    }
    m = s[0];
#pragma unroll
    for (int a = 1; a < D; ++a) m = nan_max(m, s[a]);
  }
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void gershgorin_final_kernel(const T* __restrict__ partials,
                                        int count, T* __restrict__ hi) {
  __shared__ T smem[32];
  T m = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    m = nan_max(m, partials[i]);
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) hi[0] = nan_max(total, T(1e-3));
}

// coef[0] = theta, coef[1 + 2 j] = rho_{j+1} rho_j, coef[2 + 2 j] =
// 2 rho_{j+1} / delta, for j < degree - 1.
template <typename T>
__global__ void chebyshev_coeffs_kernel(const T* __restrict__ lo_ptr,
                                        const T* __restrict__ hi_ptr,
                                        int degree, T* __restrict__ coef) {
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const T lo = lo_ptr[0];
  const T hi = hi_ptr[0];
  const T theta = (hi + lo) * T(0.5);
  const T delta = nan_max((hi - lo) * T(0.5), T(1e-12));
  const T sigma1 = theta / delta;
  T rho = T(1) / sigma1;
  coef[0] = theta;
  for (int j = 0; j < degree - 1; ++j) {
    const T rho_new = T(1) / (T(2) * sigma1 - rho);
    coef[1 + 2 * j] = rho_new * rho;
    coef[2 + 2 * j] = T(2) * rho_new / delta;
    rho = rho_new;
  }
}

template <typename T>
__global__ void chebyshev_init_kernel(const T* __restrict__ coef,
                                      const T* __restrict__ r,
                                      T* __restrict__ d, T* __restrict__ z,
                                      long long n) {
  const T theta = coef[0];
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) {
      const T di = r[i] / theta;
      d[i] = di;
      z[i] = di;
    }
  }
}

template <typename T>
__global__ void chebyshev_update_kernel(const T* __restrict__ coef, int pair,
                                        const T* __restrict__ r,
                                        const T* __restrict__ sz,
                                        T* __restrict__ d, T* __restrict__ z,
                                        long long n) {
  const T c1 = coef[1 + 2 * pair];
  const T c2 = coef[2 + 2 * pair];
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) {
      const T di = c1 * d[i] + c2 * (r[i] - sz[i]);
      d[i] = di;
      z[i] = z[i] + di;
    }
  }
}

template <typename T>
int launch_gershgorin(const T* vals, T* partials, T* hi, int n, int k_width,
                      int d, cudaStream_t stream) {
  const int blocks = n <= 0 ? 1 : grid_for(n);
  if (d == 3)
    gershgorin_rows_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(
        vals, partials, n, k_width);
  else if (d == 6)
    gershgorin_rows_kernel<T, 6><<<blocks, kThreads, 0, stream>>>(
        vals, partials, n, k_width);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  gershgorin_final_kernel<T><<<1, kThreads, 0, stream>>>(partials, blocks,
                                                         hi);
  return launch_status();
}

template <typename T>
int launch_chebyshev_coeffs(const T* lo, const T* hi, int degree, T* coef,
                            cudaStream_t stream) {
  chebyshev_coeffs_kernel<T><<<1, 32, 0, stream>>>(lo, hi, degree, coef);
  return launch_status();
}

template <typename T>
int launch_chebyshev_init(const T* coef, const T* r, T* d, T* z, long long n,
                          cudaStream_t stream) {
  chebyshev_init_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      coef, r, d, z, n);
  return launch_status();
}

template <typename T>
int launch_chebyshev_update(const T* coef, int pair, const T* r, const T* sz,
                            T* d, T* z, long long n, cudaStream_t stream) {
  chebyshev_update_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      coef, pair, r, sz, d, z, n);
  return launch_status();
}

}  // namespace g2o_torch

#define G2O_STREAM static_cast<cudaStream_t>(stream)

extern "C" {

int g2o_gershgorin_f32(const float* vals, float* partials, float* hi, int n,
                       int k_width, int d, void* stream) {
  return g2o_torch::launch_gershgorin<float>(vals, partials, hi, n, k_width,
                                             d, G2O_STREAM);
}
int g2o_gershgorin_f64(const double* vals, double* partials, double* hi,
                       int n, int k_width, int d, void* stream) {
  return g2o_torch::launch_gershgorin<double>(vals, partials, hi, n, k_width,
                                              d, G2O_STREAM);
}

int g2o_chebyshev_coeffs_f32(const float* lo, const float* hi, int degree,
                             float* coef, void* stream) {
  return g2o_torch::launch_chebyshev_coeffs<float>(lo, hi, degree, coef,
                                                   G2O_STREAM);
}
int g2o_chebyshev_coeffs_f64(const double* lo, const double* hi, int degree,
                             double* coef, void* stream) {
  return g2o_torch::launch_chebyshev_coeffs<double>(lo, hi, degree, coef,
                                                    G2O_STREAM);
}

int g2o_chebyshev_init_f32(const float* coef, const float* r, float* d,
                           float* z, int n, void* stream) {
  return g2o_torch::launch_chebyshev_init<float>(coef, r, d, z, n,
                                                 G2O_STREAM);
}
int g2o_chebyshev_init_f64(const double* coef, const double* r, double* d,
                           double* z, int n, void* stream) {
  return g2o_torch::launch_chebyshev_init<double>(coef, r, d, z, n,
                                                  G2O_STREAM);
}

int g2o_chebyshev_update_f32(const float* coef, int pair, const float* r,
                             const float* sz, float* d, float* z, int n,
                             void* stream) {
  return g2o_torch::launch_chebyshev_update<float>(coef, pair, r, sz, d, z, n,
                                                   G2O_STREAM);
}
int g2o_chebyshev_update_f64(const double* coef, int pair, const double* r,
                             const double* sz, double* d, double* z, int n,
                             void* stream) {
  return g2o_torch::launch_chebyshev_update<double>(coef, pair, r, sz, d, z,
                                                    n, G2O_STREAM);
}

}  // extern "C"
