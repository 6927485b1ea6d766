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
// One thread per destination: threads [0, K N) sum the D*D entries of one
// H block slot, threads [K N, K N + N) the D entries of one b row. Each
// sums its contributions in table order with gathers only (no atomics), so
// repeated runs agree bit for bit. Output: values [K, D*D, N] (the layout
// kernel A reads) and b [D, N]. The block width D (3 or 6) is a template
// parameter, so the accumulators stay in registers.
//
// Bound: memory. Each contribution gathers D*D (or D) values from columns
// of the edge-minor stream that the linearizer wrote; the index loads and
// all stores are coalesced (N minor).
#include "common.cuh"

namespace g2o_torch {

template <typename T, int D>
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
    constexpr int DD = D * D;
    T acc[DD];
#pragma unroll
    for (int r = 0; r < DD; ++r) acc[r] = T(0);
    for (int m = 0; m < mh; ++m) {
      const int c = hidx[m * kn + t];
      if (c < 0) break;
#pragma unroll
      for (int r = 0; r < DD; ++r) acc[r] += hblk[r * ldh + c];
    }
    const long long k = t / N, row = t - k * N;
#pragma unroll
    for (int r = 0; r < DD; ++r) vals[(k * DD + r) * N + row] = acc[r];
  } else if (t < kn + N) {
    const long long row = t - kn;
    const long long ldb = 2LL * e_total;
    T acc[D];
#pragma unroll
    for (int a = 0; a < D; ++a) acc[a] = T(0);
    for (int m = 0; m < mb; ++m) {
      const int c = bidx[m * N + row];
      if (c < 0) break;
#pragma unroll
      for (int a = 0; a < D; ++a) acc[a] += bblk[a * ldb + c];
    }
#pragma unroll
    for (int a = 0; a < D; ++a) b[a * N + row] = acc[a];
  }
}

template <typename T, int D>
int run_assemble_gather(const T* hblk, const T* bblk, const int* hidx,
                        const int* bidx, T* vals, T* b, int n, int k_width,
                        int mh, int mb, int e_total, long long total,
                        cudaStream_t stream) {
  assemble_gather_kernel<T, D><<<grid_for(total), kThreads, 0, stream>>>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total);
  return launch_status();
}

template <typename T>
int launch_assemble_gather(const T* hblk, const T* bblk, const int* hidx,
                           const int* bidx, T* vals, T* b, int n, int k_width,
                           int mh, int mb, int e_total, int d,
                           cudaStream_t stream) {
  const long long total = (static_cast<long long>(k_width) + 1) * n;
  if (total <= 0) return 0;
  switch (d) {
    case 3:
      return run_assemble_gather<T, 3>(hblk, bblk, hidx, bidx, vals, b, n,
                                       k_width, mh, mb, e_total, total, stream);
    case 6:
      return run_assemble_gather<T, 6>(hblk, bblk, hidx, bidx, vals, b, n,
                                       k_width, mh, mb, e_total, total, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace g2o_torch

extern "C" {

int g2o_assemble_gather_f32(const float* hblk, const float* bblk,
                            const int* hidx, const int* bidx, float* vals,
                            float* b, int n, int k_width, int mh, int mb,
                            int e_total, int d, void* stream) {
  return g2o_torch::launch_assemble_gather<float>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_assemble_gather_f64(const double* hblk, const double* bblk,
                            const int* hidx, const int* bidx, double* vals,
                            double* b, int n, int k_width, int mh, int mb,
                            int e_total, int d, void* stream) {
  return g2o_torch::launch_assemble_gather<double>(
      hblk, bblk, hidx, bidx, vals, b, n, k_width, mh, mb, e_total, d,
      static_cast<cudaStream_t>(stream));
}

}  // extern "C"
