// Lane gather: out[r, m] = x[r, idx[r, m]].
//
// Replaces the TPU probe kernel `gather_kernel` / `pallas_gather`
// (scripts/probe_pallas_gather.py:47-59), a `take_along_axis` on the lane
// axis that the probe timed against XLA's gather at SpMV shapes
// (R = 8, N = 3500, M = 35000, float32). No module of either package calls
// it: kernel A and the Jacobi scaling gather inside themselves. It exists
// so that the probe's own comparison can be made on this card: a block-ELL
// SpMV composed of this gather and a plain multiply-sum against kernel A.
//
// Bound: memory. One thread per output element reads one index and one
// gathered value and writes one value; indices and outputs coalesce, and a
// row of x (N values) stays in L1/L2.
#include "common.cuh"

namespace g2o_torch {

template <typename T>
__global__ void lane_gather_kernel(const T* __restrict__ x,
                                   const int* __restrict__ idx,
                                   T* __restrict__ out, int n, int m,
                                   long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const long long r = i / m;
  out[i] = x[r * n + idx[i]];
}

template <typename T>
int launch_lane_gather(const T* x, const int* idx, T* out, int rows, int n,
                       int m, cudaStream_t stream) {
  const long long total = static_cast<long long>(rows) * m;
  if (total <= 0) return 0;
  lane_gather_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(
      x, idx, out, n, m, total);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

int g2o_lane_gather_f32(const float* x, const int* idx, float* out, int rows,
                        int n, int m, void* stream) {
  return g2o_torch::launch_lane_gather<float>(
      x, idx, out, rows, n, m, static_cast<cudaStream_t>(stream));
}

int g2o_lane_gather_f64(const double* x, const int* idx, double* out,
                        int rows, int n, int m, void* stream) {
  return g2o_torch::launch_lane_gather<double>(
      x, idx, out, rows, n, m, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
