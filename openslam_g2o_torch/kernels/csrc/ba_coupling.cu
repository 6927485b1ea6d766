// K13: the Schur coupling products of the implicit solve and of the
// reduced right-hand side and back-substitution of both routes.
//
// Replaces `_apply_w_lane` (openslam_g2o_tpu/core/ba_ell.py:482-510),
// `_sandwich_lane` (:513-534) and the block applications around them in
// `_solve` (:720, :769-824), and the W products of the general path's
// `schur_solve` (openslam_g2o_tpu/core/ba.py:199-287; its landmark half
// W^T x, Hinv of `s_matvec` :229-241 and of the back-substitution):
//
//   ba_wtx       u = acc + sum over up to three pose groups of
//                sum_k W_k^T x[cam(k)] (acc optional), then out = Hinv
//                (b - u) (or Hinv u, or u) times free: W^T x with the
//                landmark solve fused (the implicit S x's first half; dx_l
//                of the back-substitution). A lane per landmark and a warp
//                per slot, the warps' sums added in a fixed order. The
//                general Schur path (core/ba.py) makes one launch over
//                all its pose groups (the intrinsics group (4, 3) beside
//                the cameras' (6, 3) ones).
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
// where it has no entry). Both finish each vertex in the same launch: the
// last of its chunks' blocks to arrive sums their partials (ba_wv with all
// its threads, ba_sandwich in chunk order; an arrival counter per vertex
// orders the blocks). A
// camera with 1768 observations and one with 55 cost what they hold, and
// the one intrinsics vertex that every observation of the general path's
// shared-intrinsics scene sees (degree 80,000) is 313 blocks, not one.
// Every sum runs in a fixed order, without atomics on values: a run repeats
// bit for bit. (Dp, dl) in {(6, 3), (4, 3), (3, 2), (9, 3)} ((9, 3): the
// BAL camera of models/bal.py; ba_sandwich's 81 sums a thread spill in
// float64 there, on 900 cameras at the implicit route's shape).
//
// The TPU code gathered from degree-bucketed, K-chunked tables
// (`_bucketize`, `_place`, `_bucket_scan`); here the landmark side walks the
// [K, L] slot table (K = 8 at both BAL shapes) and the pose side the chunked
// CSR lists.
//
// Bound: memory. One implicit S x reads W twice (Dp dl E values each) and
// the small vectors. ba_wtx's bound is its W slots (Dp dl K L values),
// the slot table and the landmark vectors: 1.96 us at 80k and 9.8 us at
// 400k in float32 at 3.35 TB/s. With one thread per landmark the kernel
// ran 40 blocks at 80k (10,000 landmarks on 132 SMs), each thread
// walking its 8 slots as 8 dependent chains (slot table, x gather, W),
// and the general path chained one launch per pose group through u in
// memory. Now a warp per slot and a lane per landmark put every slot's
// loads in flight at once, coalesced (313 blocks at 80k), and the pose
// groups share one launch.
#include "ba_blocks.cuh"

namespace g2o_torch {

constexpr int kCoupleThreads = 128;

// ba_wtx: a block takes 32 landmarks, one a lane, and kWtxStripes = 8
// warps; warp j takes slots j, j + kWtxStripes, ... of each pose group in
// turn (one slot a warp at K = 8, both BAL shapes), so a warp's loads of a
// slot's pose index and of each of its Dp dl W entries are 32 consecutive
// values, and the 8 warps have every slot's loads in flight at once
// (80,000 threads at 80k, against one thread walking 8 dependent slots in
// series). The warps' sums meet in shared memory and are added in warp
// order; warp t < dl then applies acc, b, row t of Hinv and free to its 32
// landmarks and stores row t.
constexpr int kWtxStripes = kThreads / 32;
constexpr int kWtxLandmarks = 32;

// One pose group of W^T x: W_lm [Dp*dl, K, L] lane-major, its slot table
// [K, L] of pose indices (-1 on padding) and x [Dp, C]; dp = 0: no group.
template <typename T>
struct WtxGroup {
  const T* w;
  const int* cam;
  const T* x;
  int k;
  int n_cam;
  int dp;
};

// The pose groups of one launch, in summation order: every pose type of
// the port's models that observes one landmark type (the SBA point's
// SE3 expmap and SBACam cameras and the shared intrinsics), so that the
// general path's S x is always one launch. Each group's Dp is read at run
// time and picks a body built for it (6, 9 or 4 at dl = 3, 3 at dl = 2;
// 9: the BAL camera of models/bal.py).
constexpr int kMaxWtxGroups = 3;

template <typename T>
struct WtxGroups {
  WtxGroup<T> g[kMaxWtxGroups];
};

// u += the W_k^T x[cam(k)] of slots k = stripe, stripe + kWtxStripes, ...
// of group g for landmark l
template <typename T, int DP, int DL>
__device__ __forceinline__ void wtx_slots(const WtxGroup<T>& g, long long l,
                                          long long L, int stripe,
                                          T (&u)[DL]) {
  const long long KL = static_cast<long long>(g.k) * L, C = g.n_cam;
  for (int k = stripe; k < g.k; k += kWtxStripes) {
    const long long pos = k * L + l;
    const int c = g.cam[pos];
    T w[DP * DL];
#pragma unroll
    for (int q = 0; q < DP * DL; ++q) w[q] = g.w[q * KL + pos];
    if (c < 0) continue;                       // padding contributes nothing
    T xc[DP];
#pragma unroll
    for (int s = 0; s < DP; ++s) xc[s] = g.x[s * C + c];
#pragma unroll
    for (int s = 0; s < DP; ++s)
#pragma unroll
      for (int t = 0; t < DL; ++t) u[t] += w[s * DL + t] * xc[s];
  }
}

// u = acc + sum over the groups (in order) of W^T x, then out = ((b - u)
// or u, Hinv applied if given) times free.
template <typename T, int DL>
__global__ void __launch_bounds__(kThreads) ba_wtx_kernel(
    const WtxGroups<T> gs, int n_lm, const T* __restrict__ hinv,
    const T* __restrict__ b, const T* __restrict__ free,
    const T* __restrict__ acc, T* __restrict__ out) {
  __shared__ T part[kWtxStripes][DL][kWtxLandmarks];
  const int lane = threadIdx.x & 31, stripe = threadIdx.x >> 5;
  const long long l = blockIdx.x * static_cast<long long>(kWtxLandmarks)
                      + lane;
  const long long L = n_lm;
  T u[DL];
#pragma unroll
  for (int t = 0; t < DL; ++t) u[t] = T(0);
  if (l < L) {
#pragma unroll
    for (int i = 0; i < kMaxWtxGroups; ++i) {
      const WtxGroup<T>& g = gs.g[i];
      if constexpr (DL == 3) {
        if (g.dp == 6)
          wtx_slots<T, 6, 3>(g, l, L, stripe, u);
        else if (g.dp == 9)
          wtx_slots<T, 9, 3>(g, l, L, stripe, u);
        else if (g.dp == 4)
          wtx_slots<T, 4, 3>(g, l, L, stripe, u);
      } else if (g.dp == 3) {
        wtx_slots<T, 3, 2>(g, l, L, stripe, u);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < DL; ++t) part[stripe][t][lane] = u[t];
  __syncthreads();
  if (l >= L || stripe >= DL) return;
  const int t = stripe;
  T rv[DL];
#pragma unroll
  for (int s = 0; s < DL; ++s) {
    T v = part[0][s][lane];
#pragma unroll
    for (int j = 1; j < kWtxStripes; ++j) v += part[j][s][lane];
    if (acc != nullptr) v = acc[s * L + l] + v;
    rv[s] = b != nullptr ? b[s * L + l] - v : v;
  }
  T y = rv[t];
  if (hinv != nullptr) {
    y = T(0);
#pragma unroll
    for (int s = 0; s < DL; ++s) y += hinv[(t * DL + s) * L + l] * rv[s];
  }
  out[t * L + l] = free != nullptr ? y * free[l] : y;
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

// ba_sandwich, one launch, in the order of summation of the two-pass form
// it replaces (a chunk pass, then a pass of one thread per vertex), so
// that it gives the same bits: a block of kCoupleThreads per chunk sums
// (W_j Hinv_lm(j) W_j^T)[a, b] over the chunk's entries, thread tid its
// entries j0 + tid, j0 + tid + 128, ..., then block_reduce_values. A vertex
// of one chunk is finished by that block. Of several, as in ba_wv: each
// block writes its partial, fences it and counts its arrival on the
// vertex's counter, and the last to arrive adds the vertex's partials in
// chunk order, as the one-thread vertex pass did, and resets the counter.
// Thread q < DP^2 adds its value of each chunk in turn, the loads in
// flight at once: up to 16 chunks it loads them itself, beyond that all
// threads stage them in shared memory, kStageBytes at a time. The vertex
// pass read them one dependent load after another (86 us on the 313-chunk
// intrinsics vertex).
// No value is summed atomically, so a run repeats bit for bit.
//
// A first pass of 64 threads summing the upper triangle from Hinv's upper
// triangle (fewer of the Hinv gathers that bound the pass at 400k) was
// faster there but summed in another order, and the general path's
// P2MC_INTRINSICS scene then ended one unit off in the sixth digit of its
// chi2 ratio.
constexpr int kStageBytes = 16384;

template <typename T, int DP, int DL>
__global__ void __launch_bounds__(kCoupleThreads) ba_sandwich_kernel(
    const T* __restrict__ w_cam, const int* __restrict__ pose_lm,
    const int* __restrict__ chunk_ptr, const int* __restrict__ chunk_row,
    const int* __restrict__ row_chunk, int* __restrict__ arrivals,
    const T* __restrict__ hinv, int n_lm, long long ld, int n_chunks,
    int n_rows, const T* __restrict__ hcc_d, T* __restrict__ part,
    T* __restrict__ out) {
  constexpr int DD = DP * DP;
  constexpr int kStage = kStageBytes / sizeof(T);      // staged values
  constexpr int kRound = kStage / (DD + 1);            // chunks a round
  constexpr int kPer = (kRound + kCoupleThreads - 1) / kCoupleThreads;
  __shared__ T smem[kMaxWarps][DD];
  __shared__ T staged[kStage];
  __shared__ int last;
  const int c = blockIdx.x;
  const long long L = n_lm, NC = n_chunks;
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
  const T total = block_reduce_values<T, DD>(acc, smem);  // in thread q < DD
  const long long n = chunk_row[c];
  const int c0 = row_chunk[n], c1 = row_chunk[n + 1];
  T corr = T(0);
  if (c1 - c0 == 1) {
    corr = corr + total;
  } else {
    if (threadIdx.x < DD) part[threadIdx.x * NC + c] = total;
    __threadfence();                 // the partial, before the arrival
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrivals + n, 1) == c1 - c0 - 1;
    __syncthreads();
    if (!last) return;
    // every other chunk of the vertex has written and fenced its partial;
    // read them from L2 (__ldcg), past this SM's L1: up to kDirect chunks
    // by the summing threads themselves, more a round of chunks at a time
    // through shared memory
    constexpr int kDirect = 16;
    if (c1 - c0 <= kDirect) {
      if (threadIdx.x < DD) {
        T v[kDirect];
#pragma unroll
        for (int k = 0; k < kDirect; ++k)
          if (k < c1 - c0) v[k] = __ldcg(part + threadIdx.x * NC + c0 + k);
#pragma unroll
        for (int k = 0; k < kDirect; ++k)
          if (k < c1 - c0) corr += v[k];
      }
    }
    for (int r0 = c0; c1 - c0 > kDirect && r0 < c1; r0 += kRound) {
      // thread tid loads chunks r0 + tid, r0 + tid + 128, ... of the round
      // (every value of one chunk: each warp load is 32 consecutive
      // partials of one row of part), all in flight, then stores them as
      // rows of DD + 1 values (no bank conflicts either way)
      const int m = c1 - r0 < kRound ? c1 - r0 : kRound;
      T v[kPer][DD];
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int cl = threadIdx.x + k * kCoupleThreads;
        if (cl < m) {
#pragma unroll
          for (int q = 0; q < DD; ++q)
            v[k][q] = __ldcg(part + q * NC + r0 + cl);
        }
      }
#pragma unroll
      for (int k = 0; k < kPer; ++k) {
        const int cl = threadIdx.x + k * kCoupleThreads;
        if (cl < m) {
#pragma unroll
          for (int q = 0; q < DD; ++q) staged[cl * (DD + 1) + q] = v[k][q];
        }
      }
      __syncthreads();
      if (threadIdx.x < DD) {
#pragma unroll 8
        for (int k = 0; k < m; ++k)
          corr += staged[k * (DD + 1) + threadIdx.x];
      }
      __syncthreads();
    }
    if (threadIdx.x == 0) arrivals[n] = 0;
  }
  if (threadIdx.x < DD) {
    const long long N = n_rows, q = threadIdx.x;
    out[q * N + n] = hcc_d[q * N + n] - corr;
  }
}

// -- launchers ---------------------------------------------------------------

// The groups fill gs.g from the front, each of a width DL serves (Dp 6, 9
// or 4 at DL = 3, 3 at DL = 2); anything else is refused.
template <typename T>
int launch_wtx(const WtxGroups<T>& gs, int n_lm, const T* hinv, const T* b,
               const T* free, const T* acc, int DL, T* out,
               cudaStream_t stream) {
  if (n_lm <= 0) return 0;
  bool ok = gs.g[0].dp != 0 && (DL == 2 || DL == 3);
  for (int i = 0; i < kMaxWtxGroups; ++i) {
    const int dp = gs.g[i].dp;
    if (dp != 0)
      ok = ok && (i == 0 || gs.g[i - 1].dp != 0)
           && (DL == 3 ? (dp == 6 || dp == 9 || dp == 4) : dp == 3);
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_lm + kWtxLandmarks - 1) / kWtxLandmarks;
  if (DL == 3)
    ba_wtx_kernel<T, 3><<<blocks, kThreads, 0, stream>>>(
        gs, n_lm, hinv, b, free, acc, out);
  else
    ba_wtx_kernel<T, 2><<<blocks, kThreads, 0, stream>>>(
        gs, n_lm, hinv, b, free, acc, out);
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
  else if (DP == 9 && DL == 3)
    wv_dims<T, 9, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
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
                   const int* chunk_row, const int* row_chunk, int* arrivals,
                   const T* hinv, int n_lm, long long ld, int n_chunks,
                   int n_rows, const T* hcc_d, T* part, T* out,
                   cudaStream_t stream) {
  ba_sandwich_kernel<T, DP, DL><<<n_chunks, kCoupleThreads, 0, stream>>>(
      w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk, arrivals, hinv, n_lm,
      ld, n_chunks, n_rows, hcc_d, part, out);
}

template <typename T>
int launch_sandwich(const T* w_cam, const int* pose_lm, const int* chunk_ptr,
                    const int* chunk_row, const int* row_chunk, int* arrivals,
                    const T* hinv, int n_lm, long long ld, int n_chunks,
                    int n_rows, const T* hcc_d, int DP, int DL, T* part,
                    T* out, cudaStream_t stream) {
  // every vertex owns at least one chunk (kernels/ba_coupling.py
  // build_pose_rows), so every row has a finishing block
  if (n_rows <= 0) return 0;
  if (n_chunks < n_rows) return static_cast<int>(cudaErrorInvalidValue);
  if (DP == 6 && DL == 3)
    sandwich_dims<T, 6, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                           arrivals, hinv, n_lm, ld, n_chunks, n_rows, hcc_d,
                           part, out, stream);
  else if (DP == 4 && DL == 3)
    sandwich_dims<T, 4, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                           arrivals, hinv, n_lm, ld, n_chunks, n_rows, hcc_d,
                           part, out, stream);
  else if (DP == 9 && DL == 3)
    sandwich_dims<T, 9, 3>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                           arrivals, hinv, n_lm, ld, n_chunks, n_rows, hcc_d,
                           part, out, stream);
  else if (DP == 3 && DL == 2)
    sandwich_dims<T, 3, 2>(w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk,
                           arrivals, hinv, n_lm, ld, n_chunks, n_rows, hcc_d,
                           part, out, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_BA_COUPLING_ENTRY(SUFFIX, T)                                       \
  int g2o_ba_wtx_##SUFFIX(                                                     \
      const T* w0, const int* cam0, const T* x0, int k0, int c0, int dp0,      \
      const T* w1, const int* cam1, const T* x1, int k1, int c1, int dp1,      \
      const T* w2, const int* cam2, const T* x2, int k2, int c2, int dp2,      \
      int n_lm, const T* hinv, const T* b, const T* free, const T* acc,        \
      int DL, T* out, void* stream) {                                          \
    const g2o_torch::WtxGroups<T> gs = {{{w0, cam0, x0, k0, c0, dp0},          \
                                         {w1, cam1, x1, k1, c1, dp1},          \
                                         {w2, cam2, x2, k2, c2, dp2}}};        \
    return g2o_torch::launch_wtx<T>(gs, n_lm, hinv, b, free, acc, DL, out,     \
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
      const int* chunk_row, const int* row_chunk, int* arrivals,               \
      const T* hinv, int n_lm, long long ld, int n_chunks, int n_rows,         \
      const T* hcc_d, int DP, int DL, T* part, T* out, void* stream) {         \
    return g2o_torch::launch_sandwich<T>(                                      \
        w_cam, pose_lm, chunk_ptr, chunk_row, row_chunk, arrivals, hinv,       \
        n_lm, ld, n_chunks, n_rows, hcc_d, DP, DL, part, out,                  \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_BA_COUPLING_ENTRY(f32, float)
G2O_BA_COUPLING_ENTRY(f64, double)

#undef G2O_BA_COUPLING_ENTRY

}  // extern "C"
