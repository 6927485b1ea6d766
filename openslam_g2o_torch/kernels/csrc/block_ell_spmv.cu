// Kernel A: 3x3 block-ELL sparse matrix-vector product y = H x.
//
// Replaces the TPU probe kernel `spmv_kernel` / `pallas_spmv`
// (scripts/probe_pallas_gather.py:77-97) and the JAX hot-loop matvec
// `ell_matvec_lane` / `ell_matvec_lane_kmajor_hot`
// (openslam_g2o_tpu/core/sparse.py:883-908, :1309-1354; ROADMAP K5).
//
//   y[s, n] = sum_k sum_t V[k, 3 s + t, n] * x[t, nb[k, n]]
//
// Layout (openslam_g2o_torch/core/sparse.py): nb [K, N] int32, values
// [K, 9, N], x and y [3, N]. Padding slots point at column 0 with zero
// values. One thread per block row; the K slots are summed in a fixed
// order, so the result is deterministic (no atomics).
//
// Bound: memory. Per row it reads K indices, 9K values and 3K gathered x
// entries and writes 3: about 4K + 4*9K + 4*3K bytes in float32 for
// 2*9K flops. Adjacent threads read adjacent values and indices (N is the
// minor axis of every table), so those loads coalesce; the x gather is
// irregular but x (3N values) stays in L2 at pose-graph sizes.
#include "block_ell.cuh"

namespace g2o_torch {

template <typename T>
__global__ void block_ell_spmv_kernel(const int* __restrict__ nb,
                                      const T* __restrict__ vals,
                                      const T* __restrict__ x,
                                      T* __restrict__ y, int n, int k_width) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T y0, y1, y2;
  block_ell_row(nb, vals, x, row, N, k_width, y0, y1, y2);
  y[row] = y0;
  y[N + row] = y1;
  y[2 * N + row] = y2;
}

template <typename T>
int launch_block_ell_spmv(const int* nb, const T* vals, const T* x, T* y,
                          int n, int k_width, cudaStream_t stream) {
  if (n <= 0) return 0;
  block_ell_spmv_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, x, y, n, k_width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2o_torch

extern "C" {

int g2o_block_ell_spmv_f32(const int* nb, const float* vals, const float* x,
                           float* y, int n, int k_width, void* stream) {
  return g2o_torch::launch_block_ell_spmv<float>(
      nb, vals, x, y, n, k_width, static_cast<cudaStream_t>(stream));
}

int g2o_block_ell_spmv_f64(const int* nb, const double* vals,
                           const double* x, double* y, int n, int k_width,
                           void* stream) {
  return g2o_torch::launch_block_ell_spmv<double>(
      nb, vals, x, y, n, k_width, static_cast<cudaStream_t>(stream));
}

const char* g2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
