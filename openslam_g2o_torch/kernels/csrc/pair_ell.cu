// K2', K4', K5', K8': the block-ELL kernels of LM-PCG over several vertex
// groups (core/sparse.py `PairPattern`), for block pairs (Dr, Dc) of the
// widths {2, 3, 6} (point_xy, se2 / point_xyz, se3 / se3_expmap), square
// or rectangular.
//
// Layout, per (row group, column group) pair: nb [K, Nr] int32 (the column
// of slot k of row n; a square pair's slot 0 is the row's own diagonal
// block, also for a vertex without edges; padding slots point at column 0
// with zero values), values [K, Dr*Dc, Nr] (entry Dc a + c of the block in
// slot k of row n), vectors lane-major [D, N] per group.
//
//   pair_assemble  (K2') replaces `_edge_blocks` + `_assemble_pair` +
//                  `_assemble_b` (openslam_g2o_tpu/core/sparse.py:620-728)
//                  for any pair: per contribution (an edge of one source,
//                  i.e. one edge group and slot pair (s, t)) the block
//                  J_s^T (rho' Omega) J_t, or -J_s^T (rho' Omega) e for b,
//                  formed from K17's outputs inside the kernel and summed
//                  into its destination through a destination-major table
//                  built on the host once per topology. One launch per
//                  pair (and one per vertex group for b) over every source
//                  of it; a source's pointers and residual width travel in
//                  the launch's parameters. A destination's contributions
//                  (in table order: source order, then edge order, which is
//                  the JAX stream's order) are cut into chunks of at most
//                  PAIR_CHUNK (kernels/pair_ell.py); a group of threads
//                  per chunk, a lane per entry of the destination. A
//                  destination of one chunk is written by its group; of
//                  several (a landmark seen by many poses), each group
//                  writes its sum to a scratch row and counts its arrival
//                  on the destination's counter (the only atomic); the last
//                  to arrive adds the rows in chunk order, writes the entry
//                  and resets the counter. So every
//                  entry is summed in one order and a run repeats bit for
//                  bit, with no floating-point atomics. Chunks cover the
//                  used slots only (a used slot without contributions, the
//                  diagonal of a vertex without edges, owns one empty chunk
//                  and is written as zeros); a first launch writes the
//                  padding slots' zeros.
//   pair_spmv      (K5') replaces `ell_matvec_lane` (sparse.py:883-908) and
//                  the probe's `spmv_kernel` for Dr != Dc: y_r = sum over
//                  the row group's pairs, in pattern order, of V x_c; one
//                  launch per row group, 1 to 32 lanes of a warp per row
//                  (about four used slots a lane of its widest table: a
//                  landmark's row holds a slot per observing pose), each
//                  lane walking only the used slots of the row (`cnt`),
//                  the lanes' sums added in a fixed tree; with p given it
//                  also writes partial sums of p . y per block (the fused
//                  dot of the CG step).
//   pair_scale     (K4') replaces `ell_add_diag` + `ell_scale_jacobi`
//                  (sparse.py:731-784, hot forms :1173, :1204), a thread
//                  per slot:
//                  S[k, :, n] = M_r,n (B[k, :, n] + [square, k = 0] extra[n]
//                  I) M_c,nb[k, n]^T with M = L^-1 of each group's damped
//                  diagonal blocks (K3); an all-zero slot that takes no
//                  damping, and every slot past a row's used ones, stays
//                  exactly zero whatever the factors hold.
//   pair_gershgorin (K8') replaces `ell_gershgorin_bound` /
//                  `hot_gershgorin_bound` (sparse.py:787-817, :1270): the
//                  row sums of |S| over the used slots, added over a row
//                  group's pairs (lanes per row as K5'), their maximum per
//                  block (one launch per row group into one
//                  partials table), then max(max of those, 1e-3).
//
// Bound: memory (chip_smoke.py `pair_work`: each input once, only the used
// slots of a table read, every slot of a written table written). K2'
// itself reads J_s^T's row and rho' Omega once per contribution, not once
// per edge; K5' reads the used values and nb and gathers x once per CG
// iteration; K4' reads the used values and the factors and writes every
// slot; K8' reads the used values.
#include "common.cuh"

namespace g2o_torch {

constexpr int kPairMaxSources = 32;   // sources of one pair (pair_ell.py)
constexpr int kPairMaxPairs = 8;      // pairs of one row group
constexpr int kPairMaxResid = 6;      // widest residual a source may have
constexpr int kPairBlock = 64;        // threads per block of pair_assemble

template <typename T>
struct PairSources {
  const T* js[kPairMaxSources];     // [E, D, Dr]
  const T* jt[kPairMaxSources];     // [E, D, Dc] (unused for b)
  const T* info[kPairMaxSources];   // [E, D, D]
  const T* rho1[kPairMaxSources];   // [E]
  const T* resid[kPairMaxSources];  // [E, D] (b only)
  int d[kPairMaxSources];           // residual width D
};

template <typename T>
struct PairRowOps {                 // the pairs of one row group
  const int* nb[kPairMaxPairs];     // [K, Nr]
  const int* cnt[kPairMaxPairs];    // [Nr]: the used slots of each row
  const T* vals[kPairMaxPairs];     // [K, Dr*Dc, Nr]
  const T* x[kPairMaxPairs];        // [Dc, Nc]
  long long ncol[kPairMaxPairs];    // Nc
  int k[kPairMaxPairs];
  int dc[kPairMaxPairs];
};

// a barrier over a group of kGroup threads: the block, one warp (whose
// block's other warp may have returned already), or part of a warp
template <int kGroup>
__device__ __forceinline__ void pair_group_sync() {
  if constexpr (kGroup == kPairBlock) {
    __syncthreads();
  } else if constexpr (kGroup == 32) {
    __syncwarp();
  } else {
    const unsigned lane = threadIdx.x & 31u;
    __syncwarp(((1u << kGroup) - 1u) << (lane / kGroup * kGroup));
  }
}

// A group of kGroup threads per chunk, kPairBlock / kGroup groups a block.
// dc > 0: destination d is slot d / n_rows of row d % n_rows, its Dr*Dc
// entries (Dc a + c) the block's; dc == 0: destination d is vertex d, its
// Dr entries b's.
template <typename T, int kGroup>
__global__ void __launch_bounds__(kPairBlock) pair_assemble_kernel(
    PairSources<T> src, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_dest, const int* __restrict__ dest_chunk,
    const int* __restrict__ csrc, const int* __restrict__ cedge,
    int* __restrict__ arrivals, T* __restrict__ part, T* __restrict__ out,
    int n_rows, int dr, int dc, int n_chunks) {
  constexpr int kPerBlock = kPairBlock / kGroup;
  __shared__ int last_all[kPerBlock];
  const int gi = threadIdx.x / kGroup, lane = threadIdx.x % kGroup;
  const int ch = blockIdx.x * kPerBlock + gi;
  if (ch >= n_chunks) return;                 // whole groups leave together
  const int entries = dc > 0 ? dr * dc : dr;
  const bool owns = lane < entries;
  const int a = dc > 0 ? lane / dc : lane;    // row of the entry
  const int c = dc > 0 ? lane - a * dc : 0;   // its column (blocks)
  const int d = chunk_dest[ch];
  const int c0 = dest_chunk[d], c1 = dest_chunk[d + 1];
  T acc = T(0);
  if (owns) {
    const int m_end = chunk_ptr[ch + 1];
    for (int m = chunk_ptr[ch]; m < m_end; ++m) {
      const int s = csrc[m];
      const long long e = cedge[m];
      const int D = src.d[s];
      const T* js = src.js[s] + e * D * dr;
      const T* om = src.info[s] + e * D * D;
      const T w = src.rho1[s][e];
      // column a of J_s, then row a of J_s^T (rho' Omega) one value at a
      // time, times column c of J_t (or e)
      T jsa[kPairMaxResid];
#pragma unroll
      for (int i = 0; i < kPairMaxResid; ++i)
        jsa[i] = i < D ? js[i * dr + a] : T(0);
      const T* rhs = dc > 0 ? src.jt[s] + e * D * dc + c : src.resid[s] + e * D;
      const int rstride = dc > 0 ? dc : 1;
      T v = T(0);
#pragma unroll
      for (int j = 0; j < kPairMaxResid; ++j) {
        if (j < D) {
          T jw = T(0);
#pragma unroll
          for (int i = 0; i < kPairMaxResid; ++i)
            if (i < D) jw += jsa[i] * (w * om[i * D + j]);
          v += jw * rhs[j * rstride];
        }
      }
      acc += dc > 0 ? v : -v;
    }
  }
  const long long slot = d / n_rows;
  const long long row = d - slot * n_rows;
  const long long at = (slot * entries + lane) * n_rows + row;
  if (c1 - c0 == 1) {
    if (owns) out[at] = acc;
    return;
  }
  if (owns) part[static_cast<long long>(ch) * entries + lane] = acc;
  __threadfence();                            // the row, before the arrival
  pair_group_sync<kGroup>();
  if (lane == 0) last_all[gi] = atomicAdd(arrivals + d, 1) == c1 - c0 - 1;
  pair_group_sync<kGroup>();
  if (!last_all[gi]) return;
  __threadfence();
  if (owns) {
    // the chunks' rows in chunk order, read through L2
    T tot = T(0);
    for (int q = c0; q < c1; ++q)
      tot += __ldcg(part + static_cast<long long>(q) * entries + lane);
    out[at] = tot;
  }
  if (lane == 0) arrivals[d] = 0;
}

// y[s] += sum_k sum_t V[k, Dc s + t, row] x[t, nb[k, row]] over the used
// slots k = lane, lane + kLanes, ... of one pair's row, each slot's block
// row summed first.
template <typename T, int Dr, int Dc, int kLanes>
__device__ __forceinline__ void pair_row_acc(const int* __restrict__ nb,
                                             const int* __restrict__ cnt,
                                             const T* __restrict__ vals,
                                             const T* __restrict__ x,
                                             long long ncol, int lane,
                                             long long row, long long N,
                                             T (&y)[Dr]) {
  const int used = cnt[row];
  for (int k = lane; k < used; k += kLanes) {
    const long long col = nb[k * N + row];
    const T* v = vals + static_cast<long long>(k) * (Dr * Dc) * N + row;
    T xg[Dc];
#pragma unroll
    for (int t = 0; t < Dc; ++t) xg[t] = x[t * ncol + col];
#pragma unroll
    for (int s = 0; s < Dr; ++s) {
      T acc = v[(Dc * s) * N] * xg[0];
#pragma unroll
      for (int t = 1; t < Dc; ++t) acc += v[(Dc * s + t) * N] * xg[t];
      y[s] += acc;
    }
  }
}

// A row's y over all its pairs in pattern order, its slots spread over
// kLanes consecutive lanes of a warp (kLanes a power of two up to 32),
// then added across them in a fixed tree (lane 0 holds the sum). Every
// lane of the warp must call it: the shuffles take the whole warp.
template <typename T, int Dr, int kLanes>
__device__ __forceinline__ void pair_row(const PairRowOps<T>& ops,
                                         int n_pairs, bool live, int lane,
                                         long long row, long long N,
                                         T (&y)[Dr]) {
#pragma unroll
  for (int s = 0; s < Dr; ++s) y[s] = T(0);
  if (live) {
    for (int q = 0; q < n_pairs; ++q) {
      switch (ops.dc[q]) {
        case 2:
          pair_row_acc<T, Dr, 2, kLanes>(ops.nb[q], ops.cnt[q], ops.vals[q],
                                         ops.x[q], ops.ncol[q], lane, row, N,
                                         y);
          break;
        case 3:
          pair_row_acc<T, Dr, 3, kLanes>(ops.nb[q], ops.cnt[q], ops.vals[q],
                                         ops.x[q], ops.ncol[q], lane, row, N,
                                         y);
          break;
        default:
          pair_row_acc<T, Dr, 6, kLanes>(ops.nb[q], ops.cnt[q], ops.vals[q],
                                         ops.x[q], ops.ncol[q], lane, row, N,
                                         y);
          break;
      }
    }
  }
  if constexpr (kLanes > 1) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int s = 0; s < Dr; ++s)
        y[s] += __shfl_down_sync(0xffffffffu, y[s], o, kLanes);
  }
}

// kLanes lanes per row (pair_lanes); lane 0 of a row writes y and adds
// p . y to the block's partial sum.
template <typename T, int Dr, int kLanes>
__global__ void __launch_bounds__(kThreads) pair_spmv_kernel(
    PairRowOps<T> ops, int n_pairs, const T* __restrict__ p,
    T* __restrict__ y, T* __restrict__ partials, int n) {
  __shared__ T smem[32];
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long row = t / kLanes;
  const int lane = static_cast<int>(t % kLanes);
  const long long N = n;
  T acc[Dr];
  pair_row<T, Dr, kLanes>(ops, n_pairs, row < n, lane, row, N, acc);
  T local = T(0);
  if (row < n && lane == 0) {
#pragma unroll
    for (int s = 0; s < Dr; ++s) y[s * N + row] = acc[s];
    if (partials != nullptr) {
      local = p[row] * acc[0];
#pragma unroll
      for (int s = 1; s < Dr; ++s) local += p[s * N + row] * acc[s];
    }
  }
  if (partials != nullptr) {                  // the same for the whole grid
    const T total = block_sum(local, smem);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
}

// A thread per slot (k, row): the slots are independent, so a landmark's
// hundred slots spread over as many threads, and a warp's loads of one
// slot index over consecutive rows stay coalesced.
template <typename T, int Dr, int Dc>
__global__ void __launch_bounds__(kThreads) pair_scale_kernel(
    const int* __restrict__ nb, const int* __restrict__ cnt,
    const T* __restrict__ vals,
    const T* __restrict__ linv_r, const T* __restrict__ linv_c,
    const T* __restrict__ extra, T* __restrict__ out, int n, long long ncol,
    int k_width) {
  constexpr int DD = Dr * Dc;
  const long long N = n;
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= N * k_width) return;
  const int k = static_cast<int>(t / N);
  const long long row = t - k * N;
  const T* v = vals + static_cast<long long>(k) * DD * N + row;
  T* o = out + static_cast<long long>(k) * DD * N + row;
  if (k >= cnt[row]) {                        // a padding slot: zeros
#pragma unroll
    for (int q = 0; q < DD; ++q) o[q * N] = T(0);
    return;
  }
  T B[DD];
  bool all_zero = true;
#pragma unroll
  for (int q = 0; q < DD; ++q) {
    B[q] = v[q * N];
    all_zero = all_zero && (B[q] == T(0));
  }
  if (k == 0 && extra != nullptr) {         // a square pair's diagonal
    const T e = extra[row];
#pragma unroll
    for (int a = 0; a < Dr; ++a) B[(Dc + 1) * a] += e;
  } else if (all_zero) {
#pragma unroll
    for (int q = 0; q < DD; ++q) o[q * N] = T(0);
    return;
  }
  T Mi[Dr * Dr];
#pragma unroll
  for (int q = 0; q < Dr * Dr; ++q) Mi[q] = linv_r[q * N + row];
  const long long col = nb[k * N + row];
  T Mj[Dc * Dc];
#pragma unroll
  for (int q = 0; q < Dc * Dc; ++q) Mj[q] = linv_c[q * ncol + col];
  // row a of C = M_i B, then row a of S = C M_j^T, in index order
#pragma unroll
  for (int a = 0; a < Dr; ++a) {
    T C[Dc];
#pragma unroll
    for (int cc = 0; cc < Dc; ++cc) {
      T acc = Mi[Dr * a] * B[cc];
#pragma unroll
      for (int b = 1; b < Dr; ++b) acc += Mi[Dr * a + b] * B[Dc * b + cc];
      C[cc] = acc;
    }
#pragma unroll
    for (int d = 0; d < Dc; ++d) {
      T acc = C[0] * Mj[Dc * d];
#pragma unroll
      for (int cc = 1; cc < Dc; ++cc) acc += C[cc] * Mj[Dc * d + cc];
      o[(Dc * a + d) * N] = acc;
    }
  }
}

template <typename T>
__device__ __forceinline__ T pair_abs(T v) { return v < T(0) ? -v : v; }

// The row sums of |S| over the used slots k = lane, lane + kLanes, ... of
// one pair's row.
template <typename T, int Dr, int Dc, int kLanes>
__device__ __forceinline__ void pair_row_abs(const T* __restrict__ vals,
                                             const int* __restrict__ cnt,
                                             int lane, long long row,
                                             long long N, T (&s)[Dr]) {
  const int used = cnt[row];
  for (int k = lane; k < used; k += kLanes) {
    const T* v = vals + static_cast<long long>(k) * (Dr * Dc) * N + row;
#pragma unroll
    for (int q = 0; q < Dr * Dc; ++q) s[q / Dc] += pair_abs(v[q * N]);
  }
}

// kLanes lanes per row, as pair_spmv; the lanes' row sums added in a fixed
// tree, lane 0's maximum over the row's entries to the block's maximum.
template <typename T, int Dr, int kLanes>
__global__ void __launch_bounds__(kThreads) pair_gershgorin_kernel(
    PairRowOps<T> ops, int n_pairs, T* __restrict__ partials, int n) {
  __shared__ T smem[32];
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long row = t / kLanes;
  const int lane = static_cast<int>(t % kLanes);
  const long long N = n;
  T s[Dr];
#pragma unroll
  for (int a = 0; a < Dr; ++a) s[a] = T(0);
  if (row < n) {
    for (int q = 0; q < n_pairs; ++q) {
      switch (ops.dc[q]) {
        case 2: pair_row_abs<T, Dr, 2, kLanes>(ops.vals[q], ops.cnt[q], lane,
                                               row, N, s);
          break;
        case 3: pair_row_abs<T, Dr, 3, kLanes>(ops.vals[q], ops.cnt[q], lane,
                                               row, N, s);
          break;
        default: pair_row_abs<T, Dr, 6, kLanes>(ops.vals[q], ops.cnt[q],
                                                lane, row, N, s);
      }
    }
  }
  if constexpr (kLanes > 1) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
#pragma unroll
      for (int a = 0; a < Dr; ++a)
        s[a] += __shfl_down_sync(0xffffffffu, s[a], o, kLanes);
  }
  T m = T(0);
  if (row < n && lane == 0) {
    m = s[0];
#pragma unroll
    for (int a = 1; a < Dr; ++a) m = nan_max(m, s[a]);
  }
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void pair_gershgorin_final_kernel(const T* __restrict__ partials,
                                             int count, T* __restrict__ hi) {
  __shared__ T smem[32];
  T m = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    m = nan_max(m, partials[i]);
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) hi[0] = nan_max(total, T(1e-3));
}

inline bool pair_width_ok(int d) { return d == 2 || d == 3 || d == 6; }

inline int pair_bad() { return static_cast<int>(cudaErrorInvalidValue); }

// a group of kGroup lanes per chunk: the narrowest that holds a lane per
// entry (8 for b and the 2 x 2, 2 x 3, 3 x 2 blocks, 16 for 3 x 3, 32 for
// 3 x 6 and 6 x 3, 64 for 6 x 6)
template <typename T, int kGroup>
void run_pair_assemble(const PairSources<T>& src, const int* chunk_ptr,
                       const int* chunk_dest, const int* dest_chunk,
                       const int* csrc, const int* cedge, int* arrivals,
                       T* part, T* out, int n_rows, int dr, int dc,
                       int n_chunks, cudaStream_t stream) {
  constexpr int kPerBlock = kPairBlock / kGroup;
  const int grid = (n_chunks + kPerBlock - 1) / kPerBlock;
  pair_assemble_kernel<T, kGroup><<<grid, kPairBlock, 0, stream>>>(
      src, chunk_ptr, chunk_dest, dest_chunk, csrc, cedge, arrivals, part,
      out, n_rows, dr, dc, n_chunks);
}

// The padding slots of a pair table (slot k >= cnt[row]) as zeros: a
// thread per value of the table, consecutive threads on consecutive rows.
template <typename T>
__global__ void pair_zero_pad_kernel(const int* __restrict__ cnt,
                                     T* __restrict__ out, int n_rows,
                                     int entries, long long total) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= total) return;
  const long long plane = n_rows;
  const long long row = i % plane;
  const int k = static_cast<int>(i / (plane * entries));
  if (k >= cnt[row]) out[i] = T(0);
}

// cnt: the pair table's used slots per row (its padding slots get zeros
// from pair_zero_pad_kernel; the chunks cover the used slots), or null for
// b (every vertex a destination); k_width: its slots.
template <typename T>
int launch_pair_assemble(const long long* ptrs, const int* dims, int n_src,
                         const int* chunk_ptr, const int* chunk_dest,
                         const int* dest_chunk, const int* csrc,
                         const int* cedge, int* arrivals, T* part, T* out,
                         const int* cnt, int n_rows, int k_width, int dr,
                         int dc, int n_chunks, cudaStream_t stream) {
  if (n_src < 1 || n_src > kPairMaxSources || !pair_width_ok(dr)
      || (dc != 0 && !pair_width_ok(dc)) || (cnt != nullptr && dc == 0))
    return pair_bad();
  const int entries = dc > 0 ? dr * dc : dr;
  if (cnt != nullptr && n_rows > 0) {
    const long long total = static_cast<long long>(k_width) * entries
                            * n_rows;
    pair_zero_pad_kernel<T><<<grid_for(total), kThreads, 0, stream>>>(
        cnt, out, n_rows, entries, total);
  }
  if (n_chunks <= 0) return launch_status();
  PairSources<T> src;
  for (int s = 0; s < kPairMaxSources; ++s) {
    const bool used = s < n_src;
    src.js[s] = used ? reinterpret_cast<const T*>(ptrs[s]) : nullptr;
    src.jt[s] = used ? reinterpret_cast<const T*>(ptrs[n_src + s]) : nullptr;
    src.info[s] = used ? reinterpret_cast<const T*>(ptrs[2 * n_src + s])
                       : nullptr;
    src.rho1[s] = used ? reinterpret_cast<const T*>(ptrs[3 * n_src + s])
                       : nullptr;
    src.resid[s] = used ? reinterpret_cast<const T*>(ptrs[4 * n_src + s])
                        : nullptr;
    src.d[s] = used ? dims[s] : 0;
    if (used && (dims[s] < 1 || dims[s] > kPairMaxResid)) return pair_bad();
  }
  if (entries <= 8)
    run_pair_assemble<T, 8>(src, chunk_ptr, chunk_dest, dest_chunk, csrc,
                            cedge, arrivals, part, out, n_rows, dr, dc,
                            n_chunks, stream);
  else if (entries <= 16)
    run_pair_assemble<T, 16>(src, chunk_ptr, chunk_dest, dest_chunk, csrc,
                             cedge, arrivals, part, out, n_rows, dr, dc,
                             n_chunks, stream);
  else if (entries <= 32)
    run_pair_assemble<T, 32>(src, chunk_ptr, chunk_dest, dest_chunk, csrc,
                             cedge, arrivals, part, out, n_rows, dr, dc,
                             n_chunks, stream);
  else
    run_pair_assemble<T, 64>(src, chunk_ptr, chunk_dest, dest_chunk, csrc,
                             cedge, arrivals, part, out, n_rows, dr, dc,
                             n_chunks, stream);
  return launch_status();
}

template <typename T>
bool fill_row_ops(PairRowOps<T>& ops, const long long* ptrs,
                  const long long* ncol, const int* dims, int n_pairs) {
  if (n_pairs < 1 || n_pairs > kPairMaxPairs) return false;
  for (int q = 0; q < kPairMaxPairs; ++q) {
    const bool used = q < n_pairs;
    ops.nb[q] = used ? reinterpret_cast<const int*>(ptrs[q]) : nullptr;
    ops.cnt[q] = used ? reinterpret_cast<const int*>(ptrs[n_pairs + q])
                      : nullptr;
    ops.vals[q] = used ? reinterpret_cast<const T*>(ptrs[2 * n_pairs + q])
                       : nullptr;
    ops.x[q] = used ? reinterpret_cast<const T*>(ptrs[3 * n_pairs + q])
                    : nullptr;
    ops.ncol[q] = used ? ncol[q] : 0;
    ops.k[q] = used ? dims[q] : 0;
    ops.dc[q] = used ? dims[n_pairs + q] : 0;
    if (used && !pair_width_ok(ops.dc[q])) return false;
  }
  return true;
}

template <typename T, int Dr, int kLanes>
void run_pair_spmv(const PairRowOps<T>& ops, int n_pairs, const T* p, T* y,
                   T* partials, int n, cudaStream_t stream) {
  pair_spmv_kernel<T, Dr, kLanes>
      <<<grid_for(static_cast<long long>(n) * kLanes), kThreads, 0,
         stream>>>(ops, n_pairs, p, y, partials, n);
}

template <typename T, int Dr>
void pair_spmv_lanes(const PairRowOps<T>& ops, int n_pairs, const T* p,
                     T* y, T* partials, int n, int lanes,
                     cudaStream_t stream) {
  switch (lanes) {
    case 1: run_pair_spmv<T, Dr, 1>(ops, n_pairs, p, y, partials, n, stream);
      break;
    case 2: run_pair_spmv<T, Dr, 2>(ops, n_pairs, p, y, partials, n, stream);
      break;
    case 4: run_pair_spmv<T, Dr, 4>(ops, n_pairs, p, y, partials, n, stream);
      break;
    case 8: run_pair_spmv<T, Dr, 8>(ops, n_pairs, p, y, partials, n, stream);
      break;
    case 16: run_pair_spmv<T, Dr, 16>(ops, n_pairs, p, y, partials, n,
                                      stream);
      break;
    default: run_pair_spmv<T, Dr, 32>(ops, n_pairs, p, y, partials, n,
                                      stream);
  }
}

// `lanes` per row (1, 2, 4, 8, 16 or 32; kernels/pair_ell.py `pair_lanes`
// picks it from the row group's widest table, and the partial sums are
// one per block of kThreads / lanes rows).
template <typename T>
int launch_pair_spmv(const long long* ptrs, const long long* ncol,
                     const int* dims, int n_pairs, const T* p, T* y,
                     T* partials, int n, int dr, int lanes,
                     cudaStream_t stream) {
  if (n <= 0) return 0;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return pair_bad();
  PairRowOps<T> ops;
  if (!fill_row_ops(ops, ptrs, ncol, dims, n_pairs)) return pair_bad();
  switch (dr) {
    case 2: pair_spmv_lanes<T, 2>(ops, n_pairs, p, y, partials, n, lanes,
                                  stream);
      break;
    case 3: pair_spmv_lanes<T, 3>(ops, n_pairs, p, y, partials, n, lanes,
                                  stream);
      break;
    case 6: pair_spmv_lanes<T, 6>(ops, n_pairs, p, y, partials, n, lanes,
                                  stream);
      break;
    default:
      return pair_bad();
  }
  return launch_status();
}

template <typename T, int Dr, int Dc>
void run_pair_scale(const int* nb, const int* cnt, const T* vals,
                    const T* linv_r, const T* linv_c, const T* extra, T* out,
                    int n, long long ncol, int k_width, cudaStream_t stream) {
  pair_scale_kernel<T, Dr, Dc>
      <<<grid_for(static_cast<long long>(n) * k_width), kThreads, 0,
         stream>>>(nb, cnt, vals, linv_r, linv_c, extra, out, n, ncol,
                   k_width);
}

template <typename T, int Dr>
bool pair_scale_dc(const int* nb, const int* cnt, const T* vals,
                   const T* linv_r, const T* linv_c, const T* extra, T* out,
                   int n, long long ncol, int k_width, int dc,
                   cudaStream_t stream) {
  switch (dc) {
    case 2: run_pair_scale<T, Dr, 2>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, stream);
      return true;
    case 3: run_pair_scale<T, Dr, 3>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, stream);
      return true;
    case 6: run_pair_scale<T, Dr, 6>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, stream);
      return true;
    default: return false;
  }
}

template <typename T>
int launch_pair_scale(const int* nb, const int* cnt, const T* vals,
                      const T* linv_r, const T* linv_c, const T* extra,
                      T* out, int n, long long ncol, int k_width, int dr,
                      int dc, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (extra != nullptr && dr != dc) return pair_bad();
  bool ok = false;
  switch (dr) {
    case 2: ok = pair_scale_dc<T, 2>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, dc, stream);
      break;
    case 3: ok = pair_scale_dc<T, 3>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, dc, stream);
      break;
    case 6: ok = pair_scale_dc<T, 6>(nb, cnt, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, dc, stream);
      break;
    default: break;
  }
  return ok ? launch_status() : pair_bad();
}

template <typename T, int Dr, int kLanes>
void run_pair_gershgorin(const PairRowOps<T>& ops, int n_pairs, T* partials,
                         int n, cudaStream_t stream) {
  pair_gershgorin_kernel<T, Dr, kLanes>
      <<<grid_for(static_cast<long long>(n) * kLanes), kThreads, 0,
         stream>>>(ops, n_pairs, partials, n);
}

template <typename T, int Dr>
void pair_gershgorin_lanes(const PairRowOps<T>& ops, int n_pairs,
                           T* partials, int n, int lanes,
                           cudaStream_t stream) {
  switch (lanes) {
    case 1: run_pair_gershgorin<T, Dr, 1>(ops, n_pairs, partials, n, stream);
      break;
    case 2: run_pair_gershgorin<T, Dr, 2>(ops, n_pairs, partials, n, stream);
      break;
    case 4: run_pair_gershgorin<T, Dr, 4>(ops, n_pairs, partials, n, stream);
      break;
    case 8: run_pair_gershgorin<T, Dr, 8>(ops, n_pairs, partials, n, stream);
      break;
    case 16: run_pair_gershgorin<T, Dr, 16>(ops, n_pairs, partials, n,
                                            stream);
      break;
    default: run_pair_gershgorin<T, Dr, 32>(ops, n_pairs, partials, n,
                                            stream);
  }
}

// One row group's pass into `partials`: one maximum per block of
// kThreads / lanes rows (lanes as pair_spmv's, kernels/pair_ell.py).
template <typename T>
int launch_pair_gershgorin(const long long* ptrs, const long long* ncol,
                           const int* dims, int n_pairs, T* partials, int n,
                           int dr, int lanes, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) != 0)
    return pair_bad();
  PairRowOps<T> ops;
  if (!fill_row_ops(ops, ptrs, ncol, dims, n_pairs)) return pair_bad();
  switch (dr) {
    case 2: pair_gershgorin_lanes<T, 2>(ops, n_pairs, partials, n, lanes,
                                        stream);
      break;
    case 3: pair_gershgorin_lanes<T, 3>(ops, n_pairs, partials, n, lanes,
                                        stream);
      break;
    case 6: pair_gershgorin_lanes<T, 6>(ops, n_pairs, partials, n, lanes,
                                        stream);
      break;
    default:
      return pair_bad();
  }
  return launch_status();
}

template <typename T>
int launch_pair_gershgorin_final(const T* partials, int count, T* hi,
                                 cudaStream_t stream) {
  if (count <= 0) return pair_bad();
  pair_gershgorin_final_kernel<T><<<1, 1024, 0, stream>>>(partials, count,
                                                          hi);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_PAIR_ENTRY(SUFFIX, T)                                              \
  int g2o_pair_assemble_##SUFFIX(                                              \
      const long long* ptrs, const int* dims, int n_src,                       \
      const int* chunk_ptr, const int* chunk_dest, const int* dest_chunk,      \
      const int* csrc, const int* cedge, int* arrivals, T* part, T* out,       \
      const int* cnt, int n_rows, int k_width, int dr, int dc, int n_chunks,   \
      void* stream) {                                                          \
    return g2o_torch::launch_pair_assemble<T>(                                 \
        ptrs, dims, n_src, chunk_ptr, chunk_dest, dest_chunk, csrc, cedge,     \
        arrivals, part, out, cnt, n_rows, k_width, dr, dc, n_chunks,           \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_pair_spmv_##SUFFIX(const long long* ptrs, const long long* ncol,     \
                             const int* dims, int n_pairs, const T* p, T* y,   \
                             T* partials, int n, int dr, int lanes,            \
                             void* stream) {                                   \
    return g2o_torch::launch_pair_spmv<T>(ptrs, ncol, dims, n_pairs, p, y,     \
                                          partials, n, dr, lanes,              \
                                          static_cast<cudaStream_t>(stream));  \
  }                                                                            \
  int g2o_pair_scale_##SUFFIX(const int* nb, const int* cnt, const T* vals,  \
                              const T* linv_r, const T* linv_c,               \
                              const T* extra, T* out, int n, long long ncol,   \
                              int k_width, int dr, int dc, void* stream) {     \
    return g2o_torch::launch_pair_scale<T>(                                    \
        nb, cnt, vals, linv_r, linv_c, extra, out, n, ncol, k_width, dr, dc,   \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_pair_gershgorin_##SUFFIX(const long long* ptrs,                      \
                                   const long long* ncol, const int* dims,     \
                                   int n_pairs, T* partials, int n, int dr,    \
                                   int lanes, void* stream) {                  \
    return g2o_torch::launch_pair_gershgorin<T>(                               \
        ptrs, ncol, dims, n_pairs, partials, n, dr, lanes,                     \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_pair_gershgorin_final_##SUFFIX(const T* partials, int count, T* hi,  \
                                         void* stream) {                       \
    return g2o_torch::launch_pair_gershgorin_final<T>(                         \
        partials, count, hi, static_cast<cudaStream_t>(stream));               \
  }

G2O_PAIR_ENTRY(f32, float)
G2O_PAIR_ENTRY(f64, double)

#undef G2O_PAIR_ENTRY

}  // extern "C"
