// Kernel A: DxD block-ELL sparse matrix-vector product y = H x, D in {3, 6}.
//
// Replaces the TPU probe kernel `spmv_kernel` / `pallas_spmv`
// (scripts/probe_pallas_gather.py:77-97) and the JAX hot-loop matvec
// `ell_matvec_lane` / `ell_matvec_lane_kmajor_hot`
// (openslam_g2o_tpu/core/sparse.py:883-908, :1309-1354; ROADMAP K5).
//
//   y[s, n] = sum_k sum_t V[k, D s + t, n] * x[t, nb[k, n]]
//
// Layout (openslam_g2o_torch/core/sparse.py): nb [K, N] int32, values
// [K, D*D, N], x and y [D, N]. Padding slots point at column 0 with zero
// values. One thread per block row; the K slots are summed in a fixed
// order, so the result is deterministic (no atomics).
//
// Bound: memory. Per row it reads K indices, D*D K values and D K gathered
// x entries and writes D: about 4K + 4 D*D K + 4 D K bytes in float32 for
// 2 D*D K flops. Adjacent threads read adjacent values and indices (N is the
// minor axis of every table), so those loads coalesce, also at D = 6 where a
// thread walks 36 K of them; the x gather is irregular but x (D N values)
// stays in L2 at pose-graph sizes.
#include "block_ell.cuh"

namespace g2o_torch {

// Declared for 256 threads and 3 blocks an SM, so that ptxas keeps enough
// registers at D = 6 for a slot's loads to stay in flight (as spmv_dot and
// spmv_dot_p of cg_step.cu are).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3) block_ell_spmv_kernel(
    const int* __restrict__ nb, const T* __restrict__ vals,
    const T* __restrict__ x, T* __restrict__ y, int n, int k_width) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T acc[D];
  block_ell_row<T, D>(nb, vals, x, row, N, k_width, acc);
#pragma unroll
  for (int s = 0; s < D; ++s) y[s * N + row] = acc[s];
}

template <typename T, int D>
int run_block_ell_spmv(const int* nb, const T* vals, const T* x, T* y, int n,
                       int k_width, cudaStream_t stream) {
  block_ell_spmv_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, x, y, n, k_width);
  return launch_status();
}

template <typename T>
int launch_block_ell_spmv(const int* nb, const T* vals, const T* x, T* y,
                          int n, int k_width, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 3: return run_block_ell_spmv<T, 3>(nb, vals, x, y, n, k_width, stream);
    case 6: return run_block_ell_spmv<T, 6>(nb, vals, x, y, n, k_width, stream);
    default: return bad_block_width();
  }
}

}  // namespace g2o_torch

extern "C" {

int g2o_block_ell_spmv_f32(const int* nb, const float* vals, const float* x,
                           float* y, int n, int k_width, int d,
                           void* stream) {
  return g2o_torch::launch_block_ell_spmv<float>(
      nb, vals, x, y, n, k_width, d, static_cast<cudaStream_t>(stream));
}

int g2o_block_ell_spmv_f64(const int* nb, const double* vals,
                           const double* x, double* y, int n, int k_width,
                           int d, void* stream) {
  return g2o_torch::launch_block_ell_spmv<double>(
      nb, vals, x, y, n, k_width, d, static_cast<cudaStream_t>(stream));
}

const char* g2o_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
