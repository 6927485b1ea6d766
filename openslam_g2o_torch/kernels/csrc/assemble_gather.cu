// Kernel C: deterministic contributor-gather assembly of H and b.
//
// Replaces `_assemble_pair` (openslam_g2o_tpu/core/sparse.py:646-678) and
// `_assemble_b` (:696-728), the gather form of `assemble_hot`
// (:1045-1140); ROADMAP K2.
//
// The host builds destination-major contributor tables once per topology
// (openslam_g2o_torch/core/sparse.py build_ell_pattern):
//   hidx [mh, K * N]: column ids into hblk of the contributions to block
//        slot (k, n), packed from m = 0 in stream order, -1 after the last
//   bidx [mb, N]: column ids into bblk of the contributions to b[:, n]
// One thread per destination: threads [0, K N) sum the 9 entries of one
// H block slot, threads [K N, K N + N) the 3 entries of one b row. Each
// sums its contributions in table order with gathers only (no atomics), so
// repeated runs agree bit for bit. Output: values [K, 9, N] (the layout
// kernel A reads) and b [3, N].
//
// Bound: memory. Each contribution gathers 9 (or 3) values from columns of
// the edge-minor stream that kernel B wrote; the index loads and all
// stores are coalesced (N minor).
#include "common.cuh"

namespace g2o_torch {

template <typename T>
__global__ void assemble_gather_kernel(
    const T* __restrict__ hblk, const T* __restrict__ bblk,
    const int* __restrict__ hidx, const int* __restrict__ bidx,
    T* __restrict__ vals, T* __restrict__ b, int n, int k_width, int mh,
    int mb, int e_total) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long N = n;
  const long long kn = static_cast<long long>(k_width) * N;
  if (t < kn) {
    const long long ldh = 4LL * e_total;
    T acc[9];
    for (int r = 0; r < 9; ++r) acc[r] = T(0);
    for (int m = 0; m < mh; ++m) {
      const int c = hidx[m * kn + t];
      if (c < 0) break;
      for (int r = 0; r < 9; ++r) acc[r] += hblk[r * ldh + c];
    }
    const long long k = t / N, row = t - k * N;
    for (int r = 0; r < 9; ++r) vals[(k * 9 + r) * N + row] = acc[r];
  } else if (t < kn + N) {
    const long long row = t - kn;
    const long long ldb = 2LL * e_total;
    T acc[3] = {T(0), T(0), T(0)};
    for (int m = 0; m < mb; ++m) {
      const int c = bidx[m * N + row];
      if (c < 0) break;
      for (int a = 0; a < 3; ++a) acc[a] += bblk[a * ldb + c];
    }
    for (int a = 0; a < 3; ++a) b[a * N + row] = acc[a];
  }
}

template <typename T>
int launch_assemble_gather(const T* hblk, const T* bblk, const int* hidx,
                           const int* bidx, T* vals, T* b, int n, int k_width,
                           int mh, int mb, int e_total, cudaStream_t stream) {
  const long long total = (static_cast<long long>(k_width) + 1) * n;
  if (total <= 0) return 0;
  assemble_gather_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace g2o_torch

extern "C" {

int g2o_assemble_gather_f32(const float* hblk, const float* bblk,
                            const int* hidx, const int* bidx, float* vals,
                            float* b, int n, int k_width, int mh, int mb,
                            int e_total, void* stream) {
  return g2o_torch::launch_assemble_gather<float>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total,
      static_cast<cudaStream_t>(stream));
}

int g2o_assemble_gather_f64(const double* hblk, const double* bblk,
                            const int* hidx, const int* bidx, double* vals,
                            double* b, int n, int k_width, int mh, int mb,
                            int e_total, void* stream) {
  return g2o_torch::launch_assemble_gather<double>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
