// K13: the Schur coupling products of the implicit solve and of the
// reduced right-hand side and back-substitution of both routes.
//
// Replaces `_apply_w_lane` (openslam_g2o_tpu/core/ba_ell.py:482-510),
// `_sandwich_lane` (:513-534) and the block applications around them in
// `_solve` (:720, :769-824):
//
//   ba_wtx       one thread per landmark, over its slots in order:
//                u = acc + sum_k W_k^T x[cam(k)] (acc optional), then
//                out = Hinv (b - u) (or Hinv u, or u) times free: W^T x
//                with the landmark solve fused (the implicit S x's first
//                half; dx_l of the back-substitution). The general Schur
//                path (core/ba.py) calls it once per pose group, the later
//                groups starting from the earlier groups' u, so the sum
//                runs in a fixed order; (Dp, dl) = (4, 3) is its intrinsics
//                group.
//   ba_wv        W v per pose vertex over its CSR list,
//                y = (base + Hcc_d x + extra - sum_j W_j v[lm(j)]) free,
//                optionally with the partial dot x . y per vertex (the
//                implicit S x's second half with the CG dot; the reduced
//                right-hand side b_p - W Hinv b_l)
//   ba_sandwich  Hcc_d - sum_j W_j Hinv_lm(j) W_j^T per pose vertex, the
//                block-Jacobi blocks of S (K11 inverts them)
//
// Both walk the CSR lists by chunks: a block per chunk of at most 256
// consecutive entries of one vertex (a strided loop, then
// block_reduce_values; every vertex owns at least one chunk, an empty one
// where it has no entry). ba_wv finishes each vertex in the same launch:
// the last of its chunks' blocks to arrive sums their partials with all its
// threads (an arrival counter per vertex orders the blocks). ba_sandwich
// runs a second pass, a thread per vertex summing its chunks in order. A
// camera with 1768 observations and one with 55 cost what they hold, and
// the one intrinsics vertex that every observation of the general path's
// shared-intrinsics scene sees (degree 80,000) is 313 blocks, not one.
// Every sum runs in a fixed order, without atomics on values: a run repeats
// bit for bit. (Dp, dl) in {(6, 3), (4, 3), (3, 2)}.
//
// The TPU code gathered from degree-bucketed, K-chunked tables
// (`_bucketize`, `_place`, `_bucket_scan`); here the landmark side walks the
// [K, L] slot table (K = 8 at both BAL shapes) and the pose side the chunked
// CSR lists.
//
// Bound: memory. One implicit S x reads W twice (Dp dl E values each) and
// the small vectors.
#include "ba_blocks.cuh"

namespace g2o_torch {

constexpr int kCoupleThreads = 128;

template <typename T, int DP, int DL>
__global__ void ba_wtx_kernel(const T* __restrict__ w_lm,
                              const int* __restrict__ lm_cam,
                              const T* __restrict__ x, int n_lm, int k_width,
                              int n_cam, const T* __restrict__ hinv,
                              const T* __restrict__ b,
                              const T* __restrict__ free,
                              const T* __restrict__ acc,
                              T* __restrict__ out) {
  const long long l = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (l >= n_lm) return;
  const long long L = n_lm, KL = static_cast<long long>(k_width) * L,
                  C = n_cam;
  T u[DL];
#pragma unroll
  for (int t = 0; t < DL; ++t) u[t] = acc != nullptr ? acc[t * L + l] : T(0);
  for (int k = 0; k < k_width; ++k) {
    const long long c = lm_cam[k * L + l];
    if (c < 0) continue;
    const long long pos = k * L + l;
    T xc[DP];
#pragma unroll
    for (int s = 0; s < DP; ++s) xc[s] = x[s * C + c];
#pragma unroll
    for (int s = 0; s < DP; ++s)
#pragma unroll
      for (int t = 0; t < DL; ++t)
        u[t] += w_lm[(s * DL + t) * KL + pos] * xc[s];
  }
  T r[DL];
#pragma unroll
  for (int t = 0; t < DL; ++t)
    r[t] = b != nullptr ? b[t * L + l] - u[t] : u[t];
  T y[DL];
  if (hinv != nullptr) {
    lane_mv<T, DL>(hinv, l, L, r, y);
  } else {
#pragma unroll
    for (int t = 0; t < DL; ++t) y[t] = r[t];
  }
  const T f = free != nullptr ? free[l] : T(1);
#pragma unroll
  for (int t = 0; t < DL; ++t)
    out[t * L + l] = free != nullptr ? y[t] * f : y[t];
}

// ba_wv, one launch: a block per chunk computes the chunk's share
// sum over its entries j of sum_t W_j[s, t] v[t, lm(j)] (a strided loop,
// then block_reduce_values). A vertex of one chunk is finished by that
// block. Of a vertex with several chunks, each block writes its partial to
// part[s, c], fences it and counts its arrival on the vertex's counter;
// the block that arrives last sums the vertex's partials with all its
// threads (lanes stride over the chunks in chunk order, then the same
// fixed tree), finishes the row and sets the counter back to 0 for the
// next call. The atomic orders the blocks only: no value is summed
// atomically, so a run repeats bit for bit.
template <typename T, int DP, int DL>
__global__ void __launch_bounds__(kCoupleThreads) ba_wv_kernel(
    const T* __restrict__ w_cam, const int* __restrict__ pose_lm,
    const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
    const int* __restrict__ row_chunk, int* __restrict__ arrivals,
    const T* __restrict__ v, int n_lm, long long ld, int n_chunks,
    int n_rows, const T* __restrict__ base, const T* __restrict__ hcc_d,
    const T* __restrict__ x, const T* __restrict__ extra,
    const T* __restrict__ free, T* __restrict__ part, T* __restrict__ y,
    T* __restrict__ partials) {
  __shared__ T smem[kMaxWarps][DP];
  __shared__ T vals[DP];
  __shared__ int last;
  const int c = blockIdx.x;
  const long long L = n_lm, NC = n_chunks;
  const int j0 = chunk_ptr[c], j1 = chunk_ptr[c + 1];
  T acc[DP];
#pragma unroll
  for (int s = 0; s < DP; ++s) acc[s] = T(0);
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const long long l = pose_lm[j];
    T vl[DL];
#pragma unroll
    for (int t = 0; t < DL; ++t) vl[t] = v[t * L + l];
#pragma unroll
    for (int s = 0; s < DP; ++s)
#pragma unroll
      for (int t = 0; t < DL; ++t)
        acc[s] += w_cam[(s * DL + t) * ld + j] * vl[t];
  }
  T wv = block_reduce_values<T, DP>(acc, smem);   // in thread s < DP
  const long long n = chunk_row[c];
  const int c0 = row_chunk[n], c1 = row_chunk[n + 1];
  if (c1 - c0 > 1) {
    if (threadIdx.x < DP) part[threadIdx.x * NC + c] = wv;
    __threadfence();                 // the partial, before the arrival
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrivals + n, 1) == c1 - c0 - 1;
    __syncthreads();
    if (!last) return;
    // every other chunk of the vertex has written and fenced its partial;
    // read them from L2 (__ldcg), past this SM's L1
#pragma unroll
    for (int s = 0; s < DP; ++s) acc[s] = T(0);
    for (int cc = c0 + threadIdx.x; cc < c1; cc += blockDim.x)
#pragma unroll
      for (int s = 0; s < DP; ++s) acc[s] += __ldcg(part + s * NC + cc);
    wv = block_reduce_values<T, DP>(acc, smem);
    if (threadIdx.x == 0) arrivals[n] = 0;
  }
  const long long N = n_rows;
  if (threadIdx.x < DP) {
    const int s = threadIdx.x;
    T head = base != nullptr ? base[s * N + n] : T(0);
    if (hcc_d != nullptr) {
      T hx = T(0);
#pragma unroll
      for (int t = 0; t < DP; ++t)
        hx += hcc_d[(s * DP + t) * N + n] * x[t * N + n];
      head = base != nullptr ? head + hx : hx;
    }
    if (extra != nullptr) head = head + extra[s * N + n];
    T val = head - wv;
    if (free != nullptr) val = val * free[n];
    y[s * N + n] = val;
    vals[s] = val;
  }
  if (partials == nullptr) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    T dot = T(0);
#pragma unroll
    for (int s = 0; s < DP; ++s) dot += x[s * N + n] * vals[s];
    partials[n] = dot;
  }
}

// pass 1 of ba_sandwich: part[(a, b), c] = sum over chunk c's entries j of
// (W_j Hinv_lm(j) W_j^T)[a, b]
template <typename T, int DP, int DL>
__global__ void ba_sandwich_part_kernel(const T* __restrict__ w_cam,
                                        const int* __restrict__ pose_lm,
                                        const int* __restrict__ chunk_ptr,
                                        const T* __restrict__ hinv, int n_lm,
                                        long long ld, int n_chunks,
                                        T* __restrict__ part) {
  constexpr int DD = DP * DP;
  __shared__ T smem[kMaxWarps][DD];
  const int c = blockIdx.x;
  const long long L = n_lm;
  const int j0 = chunk_ptr[c], j1 = chunk_ptr[c + 1];
  T acc[DD];
#pragma unroll
  for (int q = 0; q < DD; ++q) acc[q] = T(0);
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const long long l = pose_lm[j];
    T W[DP][DL], M[DL][DL];
#pragma unroll
    for (int s = 0; s < DP; ++s)
#pragma unroll
      for (int t = 0; t < DL; ++t) W[s][t] = w_cam[(s * DL + t) * ld + j];
#pragma unroll
    for (int t = 0; t < DL; ++t)
#pragma unroll
      for (int u = 0; u < DL; ++u) M[t][u] = hinv[(t * DL + u) * L + l];
#pragma unroll
    for (int s = 0; s < DP; ++s) {
      T tmp[DL];                                   // (W M)[s, :]
#pragma unroll
      for (int u = 0; u < DL; ++u) {
        T a = T(0);
#pragma unroll
        for (int t = 0; t < DL; ++t) a += W[s][t] * M[t][u];
        tmp[u] = a;
      }
#pragma unroll
      for (int q = 0; q < DP; ++q) {
        T a = T(0);
#pragma unroll
        for (int u = 0; u < DL; ++u) a += tmp[u] * W[q][u];
        acc[s * DP + q] += a;
      }
    }
  }
  const T total = block_reduce_values<T, DD>(acc, smem);
  if (threadIdx.x < DD)
    part[threadIdx.x * static_cast<long long>(n_chunks) + c] = total;
}

// pass 2 of ba_sandwich: one thread per pose vertex n
template <typename T, int DP>
__global__ void ba_sandwich_finish_kernel(const T* __restrict__ part,
                                          const int* __restrict__ row_chunk,
                                          int n_rows, int n_chunks,
                                          const T* __restrict__ hcc_d,
                                          T* __restrict__ out) {
  const long long n = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (n >= n_rows) return;
  const long long N = n_rows, NC = n_chunks;
  const int c0 = row_chunk[n], c1 = row_chunk[n + 1];
#pragma unroll
  for (int q = 0; q < DP * DP; ++q) {
    T corr = T(0);
    for (int c = c0; c < c1; ++c) corr += part[q * NC + c];
    out[q * N + n] = hcc_d[q * N + n] - corr;
  }
}

// -- launchers ---------------------------------------------------------------

template <typename T, int DP, int DL>
void wtx_dims(const T* w_lm, const int* lm_cam, const T* x, int n_lm,
              int k_width, int n_cam, const T* hinv, const T* b,
              const T* free, const T* acc, T* out, cudaStream_t stream) {
  ba_wtx_kernel<T, DP, DL><<<grid_for(n_lm), kThreads, 0, stream>>>(
      w_lm, lm_cam, x, n_lm, k_width, n_cam, hinv, b, free, acc, out);
}

template <typename T>
int launch_wtx(const T* w_lm, const int* lm_cam, const T* x, int n_lm,
               int k_width, int n_cam, const T* hinv, const T* b,
               const T* free, const T* acc, int DP, int DL, T* out,
               cudaStream_t stream) {
  if (n_lm <= 0) return 0;
  if (DP == 6 && DL == 3)
    wtx_dims<T, 6, 3>(w_lm, lm_cam, x, n_lm, k_width, n_cam, hinv, b, free,
                      acc, out, stream);
  else if (DP == 4 && DL == 3)
    wtx_dims<T, 4, 3>(w_lm, lm_cam, x, n_lm, k_width, n_cam, hinv, b, free,
                      acc, out, stream);
  else if (DP == 3 && DL == 2)
    wtx_dims<T, 3, 2>(w_lm, lm_cam, x, n_lm, k_width, n_cam, hinv, b, free,
                      acc, out, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

template <typename T, int DP, int DL>
void wv_dims(const T* w_cam, const int* pose_lm, const int* chunk_ptr,
             const int* chunk_row, const int* row_chunk, int* arrivals,
             const T* v, int n_lm, long long ld, int n_chunks, int n_rows,
             const T* base, const T* hcc_d, const T* x, const T* extra,
             const T* free, T* part, T* y, T* partials,
             cudaStream_t stream) {
  ba_wv_kernel<T, DP, DL><<<n_chunks, kCoupleThreads, 0, stream>>>(
      w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk, arrivals, v, n_lm, ld,
      n_chunks, n_rows, base, hcc_d, x, extra, free, part, y, partials);
}

template <typename T>
int launch_wv(const T* w_cam, const int* pose_lm, const int* chunk_ptr,
              const int* chunk_row, const int* row_chunk, int* arrivals,
              const T* v, int n_lm, long long ld, int n_chunks, int n_rows,
              const T* base, const T* hcc_d, const T* x, const T* extra,
              const T* free, int DP, int DL, T* part, T* y, T* partials,
              cudaStream_t stream) {
  // every vertex owns at least one chunk (kernels/ba_coupling.py
  // build_pose_rows), so every row has a finishing block
  if (n_rows <= 0) return 0;
  if (n_chunks < n_rows) return static_cast<int>(cudaErrorInvalidValue);
  if (DP == 6 && DL == 3)
    wv_dims<T, 6, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                     arrivals, v, n_lm, ld, n_chunks, n_rows, base, hcc_d, x,
                     extra, free, part, y, partials, stream);
  else if (DP == 4 && DL == 3)
    wv_dims<T, 4, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                     arrivals, v, n_lm, ld, n_chunks, n_rows, base, hcc_d, x,
                     extra, free, part, y, partials, stream);
  else if (DP == 3 && DL == 2)
    wv_dims<T, 3, 2>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                     arrivals, v, n_lm, ld, n_chunks, n_rows, base, hcc_d, x,
                     extra, free, part, y, partials, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

template <typename T, int DP, int DL>
void sandwich_dims(const T* w_cam, const int* pose_lm, const int* chunk_ptr,
                   const int* row_chunk, const T* hinv, int n_lm,
                   long long ld, int n_chunks, int n_rows, const T* hcc_d,
                   T* part, T* out, cudaStream_t stream) {
  if (n_chunks > 0)
    ba_sandwich_part_kernel<T, DP, DL>
        <<<n_chunks, kCoupleThreads, 0, stream>>>(w_cam, pose_lm, chunk_ptr,
                                                  hinv, n_lm, ld, n_chunks,
                                                  part);
  ba_sandwich_finish_kernel<T, DP>
      <<<grid_for(n_rows), kThreads, 0, stream>>>(part, row_chunk, n_rows,
                                                  n_chunks, hcc_d, out);
}

template <typename T>
int launch_sandwich(const T* w_cam, const int* pose_lm, const int* chunk_ptr,
                    const int* row_chunk, const T* hinv, int n_lm,
                    long long ld, int n_chunks, int n_rows, const T* hcc_d,
                    int DP, int DL, T* part, T* out, cudaStream_t stream) {
  if (n_rows <= 0) return 0;
  if (DP == 6 && DL == 3)
    sandwich_dims<T, 6, 3>(w_cam, pose_lm, chunk_ptr, row_chunk, hinv, n_lm,
                           ld, n_chunks, n_rows, hcc_d, part, out, stream);
  else if (DP == 4 && DL == 3)
    sandwich_dims<T, 4, 3>(w_cam, pose_lm, chunk_ptr, row_chunk, hinv, n_lm,
                           ld, n_chunks, n_rows, hcc_d, part, out, stream);
  else if (DP == 3 && DL == 2)
    sandwich_dims<T, 3, 2>(w_cam, pose_lm, chunk_ptr, row_chunk, hinv, n_lm,
                           ld, n_chunks, n_rows, hcc_d, part, out, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_BA_COUPLING_ENTRY(SUFFIX, T)                                       \
  int g2o_ba_wtx_##SUFFIX(const T* w_lm, const int* lm_cam, const T* x,        \
                          int n_lm, int k_width, int n_cam, const T* hinv,     \
                          const T* b, const T* free, const T* acc, int DP,     \
                          int DL, T* out, void* stream) {                      \
    return g2o_torch::launch_wtx<T>(w_lm, lm_cam, x, n_lm, k_width, n_cam,     \
                                    hinv, b, free, acc, DP, DL, out,           \
                                    static_cast<cudaStream_t>(stream));        \
  }                                                                            \
  int g2o_ba_wv_##SUFFIX(                                                      \
      const T* w_cam, const int* pose_lm, const int* chunk_ptr,                \
      const int* chunk_row, const int* row_chunk, int* arrivals, const T* v,   \
      int n_lm, long long ld, int n_chunks, int n_rows, const T* base,         \
      const T* hcc_d, const T* x, const T* extra, const T* free, int DP,       \
      int DL, T* part, T* y, T* partials, void* stream) {                      \
    return g2o_torch::launch_wv<T>(                                            \
        w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk, arrivals, v, n_lm,    \
        ld, n_chunks, n_rows, base, hcc_d, x, extra, free, DP, DL, part, y,    \
        partials, static_cast<cudaStream_t>(stream));                          \
  }                                                                            \
  int g2o_ba_sandwich_##SUFFIX(                                                \
      const T* w_cam, const int* pose_lm, const int* chunk_ptr,                \
      const int* row_chunk, const T* hinv, int n_lm, long long ld,             \
      int n_chunks, int n_rows, const T* hcc_d, int DP, int DL, T* part,       \
      T* out, void* stream) {                                                  \
    return g2o_torch::launch_sandwich<T>(                                      \
        w_cam, pose_lm, chunk_ptr, row_chunk, hinv, n_lm, ld, n_chunks,        \
        n_rows, hcc_d, DP, DL, part, out,                                      \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_BA_COUPLING_ENTRY(f32, float)
G2O_BA_COUPLING_ENTRY(f64, double)

#undef G2O_BA_COUPLING_ENTRY

}  // extern "C"
