// K2', K4', K5', K8': the block-ELL kernels of LM-PCG over several vertex
// groups (core/sparse.py `PairPattern`), for block pairs (Dr, Dc) of the
// widths {2, 3, 6} (point_xy, se2 / point_xyz, se3 / se3_expmap), square
// or rectangular.
//
// Layouts, per (row group, column group) pair table. Assembled: nb [K, Nr]
// int32 (the column of slot k of row n; a square pair's slot 0 is the
// row's own diagonal block, also for a vertex without edges; padding slots
// point at column 0 with zero values) and values [K, Dr*Dc, Nr] (entry
// Dc a + c of the block in slot k of row n), what K3 and K4' read.
// Scaled ("used-slot" layout, written by K4', read by K5' and K8'):
// rowptr [Nr + 1] int32 (row n's used slots are u = rowptr[n] ..
// rowptr[n + 1] - 1, in slot order), cols [U] int32 (their columns) and
// values [Dr*Dc, U] (entry q of used slot u at q U + u): no padding, and
// lanes on consecutive used slots read consecutive addresses. The CG
// vectors of all vertex groups are one flat buffer, each group's part
// vertex-major [N, D] at its offset: a column's Dc values, which a slot
// gathers, share a 32-byte sector.
//
//   pair_stream    (K2', pass 1) replaces `_edge_blocks`
//                  (openslam_g2o_tpu/core/sparse.py:620-644), edge-major:
//                  a thread per edge and slot s of an edge group (a "unit")
//                  forms each block J_s^T (rho' Omega) J_t of every slot t,
//                  and -J_s^T (rho' Omega) e for b, in registers and writes
//                  it as one record (its values rounded up to a multiple of
//                  4, zero padded: whole 16-byte stores) at its place in
//                  its table's destination-major stream (host-built
//                  positions, once per topology). One launch over every
//                  unit.
//   pair_sum       (K2', pass 2) replaces `_assemble_pair` + `_assemble_b`
//                  (:646-728): a thread per destination (slot of a row, or
//                  vertex for b) of every pair table and b, the padding
//                  slots' zeros included, reads its run of records as whole
//                  16-byte pieces (a few records' loads in flight at once),
//                  sums them in order (source order, then edge order: the
//                  JAX stream's order) in chunks of kPairChunk, the chunk
//                  sums added in chunk order, and writes its values with
//                  consecutive threads on consecutive rows. One launch over
//                  every table; no atomics, so a run repeats bit for bit,
//                  and each contribution and each sum is the earlier
//                  one-pass kernel's arithmetic (its bits).
//   pair_scale     (K4') replaces `ell_add_diag` + `ell_scale_jacobi`
//                  (sparse.py:731-784, hot forms :1173, :1204): a thread
//                  per slot of a tile of 32 rows x 4 slots, consecutive
//                  threads on consecutive rows (coalesced loads):
//                  S[k, :, n] = M_r,n (B[k, :, n] + [square, k = 0] extra[n]
//                  I) M_c,nb[k, n]^T with M = L^-1 of each group's damped
//                  diagonal blocks (K3); an all-zero slot that takes no
//                  damping stays exactly zero whatever the factors hold.
//                  The tile's blocks go through shared memory and leave in
//                  the used-slot layout as runs of a row's 4 slots.
//   pair_flat      (K5') replaces `ell_matvec_lane` (sparse.py:883-908) and
//                  the probe's `spmv_kernel` for any (Dr, Dc): y_r = sum
//                  over the row group's pairs, in pattern order, of V x_c,
//                  for up to kPairMaxGroups row groups in one launch (a
//                  block range per group, its tables and widths in the
//                  launch parameters; kernels/pair_ell.py launches again
//                  for more). `lanes` threads a row walk the row's used
//                  slots u = first + lane, + lanes, ... of each table in
//                  turn (coalesced) and form all Dr outputs; the lanes'
//                  sums are added in a fixed tree. Modes: y = H x; with
//                  the partial sums of x . y per block (the CG step's
//                  dot); or with the next direction folded in, x_new =
//                  beta x + r formed as it multiplies (every column
//                  gathers beta x + r, the row's own part is stored into
//                  x_new, another buffer), y = H x_new and the partials of
//                  x_new . y.
//   pair_bound     (K8') replaces `ell_gershgorin_bound` /
//                  `hot_gershgorin_bound` (sparse.py:787-817, :1270): the
//                  row sums of |S| over every row group's tables (the
//                  teams of pair_flat), their maximum per block, then
//                  max(max of those, 1e-3) in a second kernel after the
//                  last launch.
//
// Bound: memory (chip_smoke.py `pair_work`: each input once, only the used
// slots of a table read, every slot of a written table written). K2' moves
// K17's outputs, the positions and the tables (the stream, ~15 MB at phase
// 4s's world in float32, stays in the 50 MB L2); K5' reads the used values,
// cols and rowptr and gathers the vectors once per CG iteration; K4' reads
// the used values and the factors; K8' the used values.
#include "common.cuh"

namespace g2o_torch {

constexpr int kPairChunk = 16;        // PAIR_CHUNK of kernels/pair_ell.py
constexpr int kPairMaxSlots = 3;      // slots of an edge (MAX_SLOTS)
constexpr int kPairMaxUnits = 12;     // units of one pair_stream launch
constexpr int kPairMaxOuts = 24;      // tables of one pair_sum launch
constexpr int kPairMaxGroups = 4;     // row groups of one pair_flat launch
constexpr int kPairMaxTables = 16;    // their tables
constexpr int kPairMaxPairs = 8;      // tables of one row group (MAX_PAIRS)
constexpr int kPairMaxResid = 6;      // widest residual of an edge group
constexpr int kPairBeta = 9;          // BETA of kernels/cg_step.py

inline bool pair_width_ok(int d) { return d == 2 || d == 3 || d == 6; }

inline int pair_bad() { return static_cast<int>(cudaErrorInvalidValue); }

// -- pass 1: the blocks of every edge, into the destination-major stream --

template <typename T>
struct StreamUnit {                   // slot s of one edge group
  const T* js;                        // [E, D, Dr] slot s's Jacobian
  const T* resid;                     // [E, D]
  const T* rho1;                      // [E]
  const T* info;                      // [E, D, D]
  const T* jt[kPairMaxSlots];         // [E, D, Dc] slot t's Jacobian
  const int* pos[kPairMaxSlots];      // [E] each edge's record in table t
  T* out[kPairMaxSlots];              // table (s, t)'s stream, Dr*Dc a record
  const int* bpos;                    // [E] each edge's record in b
  T* bout;                            // b's stream, Dr a record
  int dc[kPairMaxSlots];
  int n_t, n_edges, d, dr, block0;
};

template <typename T>
struct StreamOps {
  StreamUnit<T> u[kPairMaxUnits];
  int n;
};

// A record of E values and its stride in the stream: E rounded up to a
// multiple of 4 values (16 bytes in float32, 32 in float64), so that a
// record is written and read as whole 16-byte pieces, its padding zeros.
template <int E>
__host__ __device__ constexpr int record_stride() { return (E + 3) / 4 * 4; }

// Row a of J_s^T (rho' Omega): jw[j] = sum_i J_s[i, a] (rho' Omega[i, j]),
// i in order (the one-pass kernel's products and order).
template <typename T, int Dr, int D>
__device__ __forceinline__ void stream_jw_row(const T* __restrict__ js,
                                              const T* __restrict__ om, T w,
                                              int a, T (&jwa)[D]) {
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T jw = T(0);
#pragma unroll
    for (int i = 0; i < D; ++i) jw += js[i * Dr + a] * (w * om[i * D + j]);
    jwa[j] = jw;
  }
}

// One record of Dr rows of Dc entries (Dc = 0: b, one entry a row), written
// as it is formed: entry Dc a + c is sum_j jw[j] J_t[j, c] (b: -sum_j jw[j]
// e[j]), in j order, with jw row a of J_s^T (rho' Omega); every 16-byte
// piece stored once full, the padding zeros. So a thread holds one jw row
// and one piece, whatever the block's size.
template <typename T, int Dr, int D, int Dc>
__device__ __forceinline__ void stream_record(const T* __restrict__ js,
                                              const T* __restrict__ om, T w,
                                              const T* __restrict__ rhs,
                                              T* __restrict__ dst) {
  constexpr int kC = Dc > 0 ? Dc : 1;
  constexpr int E = Dr * kC;
  constexpr int S = record_stride<E>();
  constexpr int kPer = 16 / sizeof(T);
  float4* out = reinterpret_cast<float4*>(dst);
  Piece16<T> piece;
  T jwa[D];
#pragma unroll
  for (int e = 0; e < S; ++e) {
    T v = T(0);
    if (e < E) {
      const int a = e / kC, c = e - a * kC;
      if (c == 0) stream_jw_row<T, Dr, D>(js, om, w, a, jwa);
#pragma unroll
      for (int j = 0; j < D; ++j)
        v += jwa[j] * (Dc > 0 ? rhs[j * Dc + c] : rhs[j]);
      if (Dc == 0) v = -v;
    }
    piece.t[e % kPer] = v;
    if (e % kPer == kPer - 1) out[e / kPer] = piece.v;
  }
}

// One edge of one unit: every block (s, t) and the b part -J_s^T (rho'
// Omega) e, each a record at its place in its table's stream.
template <typename T, int Dr, int D>
__device__ __forceinline__ void stream_edge(const StreamUnit<T>& U,
                                            long long e) {
  const T w = U.rho1[e];
  const T* om = U.info + e * (D * D);
  const T* js = U.js + e * (D * Dr);
  for (int t = 0; t < U.n_t; ++t) {
    const int dc = U.dc[t];
    const long long m = U.pos[t][e];
    const T* jt = U.jt[t] + e * (D * dc);
    switch (dc) {
      case 2: stream_record<T, Dr, D, 2>(
          js, om, w, jt, U.out[t] + m * record_stride<Dr * 2>()); break;
      case 3: stream_record<T, Dr, D, 3>(
          js, om, w, jt, U.out[t] + m * record_stride<Dr * 3>()); break;
      default: stream_record<T, Dr, D, 6>(
          js, om, w, jt, U.out[t] + m * record_stride<Dr * 6>()); break;
    }
  }
  stream_record<T, Dr, D, 0>(js, om, w, U.resid + e * D,
                             U.bout + static_cast<long long>(U.bpos[e])
                             * record_stride<Dr>());
}

template <typename T, int Dr>
__device__ __forceinline__ void stream_edge_d(const StreamUnit<T>& U,
                                              long long e) {
  switch (U.d) {
    case 1: stream_edge<T, Dr, 1>(U, e); break;
    case 2: stream_edge<T, Dr, 2>(U, e); break;
    case 3: stream_edge<T, Dr, 3>(U, e); break;
    case 4: stream_edge<T, Dr, 4>(U, e); break;
    case 5: stream_edge<T, Dr, 5>(U, e); break;
    default: stream_edge<T, Dr, 6>(U, e); break;
  }
}

// A thread per edge of a unit; a block range per unit (block0).
template <typename T>
__global__ void __launch_bounds__(kThreads) pair_stream_kernel(
    const __grid_constant__ StreamOps<T> ops) {
  int ui = 0;
  while (ui + 1 < ops.n && static_cast<int>(blockIdx.x) >= ops.u[ui + 1].block0)
    ++ui;
  const StreamUnit<T>& U = ops.u[ui];
  const long long e = static_cast<long long>(blockIdx.x - U.block0) * kThreads
                      + threadIdx.x;
  if (e >= U.n_edges) return;
  switch (U.dr) {
    case 2: stream_edge_d<T, 2>(U, e); break;
    case 3: stream_edge_d<T, 3>(U, e); break;
    default: stream_edge_d<T, 6>(U, e); break;
  }
}

// -- pass 2: every table's destinations, summed in stream order ----------

template <typename T>
struct SumOut {                       // one pair table or one group's b
  const T* stream;                    // its records, destination-major
  const int* ptr;                     // [K Nr + 1] each destination's run
  T* out;                             // [K, entries, Nr]
  int n_rows, n_dest, entries, block0;
};

template <typename T>
struct SumOps {
  SumOut<T> o[kPairMaxOuts];
  int n;
};

// Destination d = slot Nr + row: its run ptr[d] .. ptr[d + 1] read two
// 16-byte pieces of every record at a time (2 kPer entries; the loads of
// kUnroll records in flight at once), entry q of each summed in order,
// kPairChunk records a chunk; a destination of one chunk (a padding slot:
// an empty run) is that chunk's sum, of several the chunk sums added in
// order from zero. Its values go to (slot E + q) Nr + row: consecutive
// threads on consecutive rows. Two pieces at a time keep a thread's state
// small whatever the block's size.
template <typename T, int E>
__device__ __forceinline__ void sum_dest(const SumOut<T>& O, int d) {
  constexpr int S = record_stride<E>();
  constexpr int kPer = 16 / sizeof(T);
  constexpr int kPieces = S / kPer;
  constexpr int kGroup = 2;                   // pieces a pass
  constexpr int kUnroll = 8;
  const int row = d % O.n_rows, slot = d / O.n_rows;
  const int p0 = O.ptr[d], p1 = O.ptr[d + 1];
  const bool multi = p1 - p0 > kPairChunk;
  const float4* recs = reinterpret_cast<const float4*>(O.stream);
  T* out = O.out + static_cast<long long>(slot) * E * O.n_rows + row;
#pragma unroll
  for (int i0 = 0; i0 < kPieces; i0 += kGroup) {
    constexpr int kN = kGroup * kPer;         // entries a pass
    T acc[kN], tot[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) tot[j] = T(0);
    int m = p0;
    do {
      const int c1 = min(m + kPairChunk, p1);
#pragma unroll
      for (int j = 0; j < kN; ++j) acc[j] = T(0);
      for (; m + kUnroll <= c1; m += kUnroll) {
        Piece16<T> buf[kUnroll][kGroup];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
            if (i0 + g < kPieces)
              buf[u][g].v = __ldg(recs + static_cast<long long>(m + u)
                                             * kPieces + i0 + g);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int g = 0; g < kGroup; ++g)
#pragma unroll
            for (int j = 0; j < kPer; ++j)
              if (i0 + g < kPieces) acc[g * kPer + j] += buf[u][g].t[j];
      }
      for (; m < c1; ++m) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          if (i0 + g < kPieces) {
            Piece16<T> v;
            v.v = __ldg(recs + static_cast<long long>(m) * kPieces + i0 + g);
#pragma unroll
            for (int j = 0; j < kPer; ++j) acc[g * kPer + j] += v.t[j];
          }
        }
      }
      if (multi) {
#pragma unroll
        for (int j = 0; j < kN; ++j) tot[j] += acc[j];
      }
    } while (m < p1);
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int q = i0 * kPer + j;
      if (q < E)
        out[static_cast<long long>(q) * O.n_rows] = multi ? tot[j] : acc[j];
    }
  }
}

// A thread per destination of every table; a block range per table.
template <typename T>
__global__ void __launch_bounds__(kThreads) pair_sum_kernel(
    const __grid_constant__ SumOps<T> ops) {
  int oi = 0;
  while (oi + 1 < ops.n && static_cast<int>(blockIdx.x) >= ops.o[oi + 1].block0)
    ++oi;
  const SumOut<T>& O = ops.o[oi];
  const int d = (static_cast<int>(blockIdx.x) - O.block0) * kThreads
                + static_cast<int>(threadIdx.x);
  if (d >= O.n_dest) return;
  switch (O.entries) {
    case 2: sum_dest<T, 2>(O, d); break;
    case 3: sum_dest<T, 3>(O, d); break;
    case 4: sum_dest<T, 4>(O, d); break;
    case 6: sum_dest<T, 6>(O, d); break;
    case 9: sum_dest<T, 9>(O, d); break;
    case 12: sum_dest<T, 12>(O, d); break;
    case 18: sum_dest<T, 18>(O, d); break;
    default: sum_dest<T, 36>(O, d); break;
  }
}

// -- K4': the scaled tables in the used-slot layout ----------------------

constexpr int kScaleRows = 32;
constexpr int kScaleSlots = 4;
constexpr int kScaleThreads = kScaleRows * kScaleSlots;
constexpr int kScalePitch = 40;   // no bank conflicts either way

// Block (x, y): rows 32 x .. 32 x + 31, slots 4 y .. 4 y + 3; thread (r,
// kl) = (threadIdx % 32, threadIdx / 32).
template <typename T, int Dr, int Dc>
__global__ void __launch_bounds__(kScaleThreads) pair_scale_kernel(
    const int* __restrict__ nb, const int* __restrict__ rowptr,
    const T* __restrict__ vals, const T* __restrict__ linv_r,
    const T* __restrict__ linv_c, const T* __restrict__ extra,
    T* __restrict__ out, int n, long long ncol, long long used) {
  constexpr int DD = Dr * Dc;
  __shared__ T tile[DD][kScaleSlots * kScalePitch];
  __shared__ int s_u0[kScaleRows], s_cnt[kScaleRows];
  const long long N = n;
  const int r = threadIdx.x % kScaleRows, kl = threadIdx.x / kScaleRows;
  const long long row = static_cast<long long>(blockIdx.x) * kScaleRows + r;
  const int k = static_cast<int>(blockIdx.y) * kScaleSlots + kl;
  int u0 = 0, cr = 0;
  if (row < N) {
    u0 = rowptr[row];
    cr = rowptr[row + 1] - u0;
  }
  if (kl == 0) {
    s_u0[r] = u0;
    s_cnt[r] = cr;
  }
  if (!__syncthreads_or(k < cr)) return;      // only padding slots here
  if (k < cr) {
    const T* v = vals + static_cast<long long>(k) * DD * N + row;
    T B[DD];
    bool all_zero = true;
#pragma unroll
    for (int q = 0; q < DD; ++q) {
      B[q] = v[q * N];
      all_zero = all_zero && (B[q] == T(0));
    }
    T* o = &tile[0][kl * kScalePitch + r];
    constexpr int kPlane = kScaleSlots * kScalePitch;
    if constexpr (Dr == Dc) {
      if (k == 0 && extra != nullptr) {       // a square pair's diagonal
        const T e = extra[row];
#pragma unroll
        for (int a = 0; a < Dr; ++a) B[(Dc + 1) * a] += e;
        all_zero = false;
      }
    }
    if (all_zero) {
#pragma unroll
      for (int q = 0; q < DD; ++q) o[q * kPlane] = T(0);
    } else {
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
          o[(Dc * a + d) * kPlane] = acc;
        }
      }
    }
  }
  __syncthreads();
  // out: thread (r2, kl2) = (threadIdx / 4, threadIdx % 4) writes slot kl2
  // of row r2, entry by entry: a row's used slots of the tile as one run
  const int kl2 = threadIdx.x % kScaleSlots, r2 = threadIdx.x / kScaleSlots;
  const int k2 = static_cast<int>(blockIdx.y) * kScaleSlots + kl2;
  if (k2 >= s_cnt[r2]) return;
  T* o2 = out + s_u0[r2] + k2;
#pragma unroll
  for (int q = 0; q < DD; ++q) o2[q * used] = tile[q][kl2 * kScalePitch + r2];
}

// -- K5' and K8': every row group's tables in one launch -----------------

struct FlatGroup {                    // one row group
  long long off;                      // its part of the flat vectors
  int n, dr;                          // rows, outputs a row
  int lanes_log, rows_log;            // lanes a row, rows a block
  int block0, tab0, n_tabs;
};

// One pair table of a row group in the used-slot layout: used slot u
// (row n's are rowptr[n] .. rowptr[n + 1] - 1) has its column at cols[u]
// and values entry q at vals[q used + u].
template <typename T>
struct FlatTab {
  const int* rowptr;                  // [Nr + 1]
  const int* cols;                    // [U]
  const T* vals;                      // [Dr*Dc, U]
  long long used;                     // U
  long long col_off;                  // the column group's part
  int ncol, dc;
};

template <typename T>
struct FlatOps {
  FlatGroup g[kPairMaxGroups];
  FlatTab<T> t[kPairMaxTables];
  int n;
};

enum FlatMode { kFlatMul = 0, kFlatDot = 1, kFlatFold = 2 };

// The team of this thread: its row group, row and lane.
struct FlatPlace {
  int gi, lane;
  long long row;
  bool live;
};

template <typename T>
__device__ __forceinline__ FlatPlace flat_place(const FlatOps<T>& ops) {
  FlatPlace p;
  p.gi = 0;
  while (p.gi + 1 < ops.n
         && static_cast<int>(blockIdx.x) >= ops.g[p.gi + 1].block0)
    ++p.gi;
  const FlatGroup& G = ops.g[p.gi];
  p.row = (static_cast<long long>(blockIdx.x - G.block0) << G.rows_log)
          + (threadIdx.x >> G.lanes_log);
  p.lane = threadIdx.x & ((1 << G.lanes_log) - 1);
  p.live = p.row < G.n;
  return p;
}

// acc[a] += sum over the row's used slots u = first + lane, + lanes, ...
// of one table of sum_t V[Dc a + t] xg[t], each block row's products in t
// order; xg the column's Dc values of x (or of beta x + r), contiguous in
// the vertex-major vectors.
template <typename T, int Dr, int Dc, int kMode>
__device__ __forceinline__ void flat_acc(const FlatTab<T>& tb,
                                         const T* __restrict__ x,
                                         const T* __restrict__ r, T beta,
                                         long long row, int lane, int lanes,
                                         T (&acc)[Dr]) {
  const int b0 = __ldg(tb.rowptr + row);
  const int cnt = __ldg(tb.rowptr + row + 1) - b0;
  const T* xc = x + tb.col_off;
  const T* rc = r + tb.col_off;
  const T* v = tb.vals + b0;
  const int* cols = tb.cols + b0;
  for (int j = lane; j < cnt; j += lanes) {
    const long long col = static_cast<long long>(__ldg(cols + j)) * Dc;
    const T* vj = v + j;
    T xg[Dc];
#pragma unroll
    for (int t = 0; t < Dc; ++t) {
      if constexpr (kMode == kFlatFold)
        xg[t] = beta * __ldg(xc + col + t) + __ldg(rc + col + t);
      else
        xg[t] = __ldg(xc + col + t);
    }
#pragma unroll
    for (int a = 0; a < Dr; ++a) {
      T s = __ldg(vj + (a * Dc) * tb.used) * xg[0];
#pragma unroll
      for (int t = 1; t < Dc; ++t) s += __ldg(vj + (a * Dc + t) * tb.used) * xg[t];
      acc[a] += s;
    }
  }
}

// The team's row: its Dr outputs over the group's tables in pattern order,
// the lanes added in a fixed tree; lane 0 stores y (and x_new) and adds its
// part of the dot to `local`. Every lane of the warp calls it (the shuffles
// take the whole warp).
template <typename T, int Dr, int kMode>
__device__ __forceinline__ void flat_row(const FlatOps<T>& ops,
                                         const FlatGroup& G,
                                         const FlatPlace& p, T beta,
                                         const T* __restrict__ x,
                                         const T* __restrict__ r,
                                         T* __restrict__ x_new,
                                         T* __restrict__ y, T& local) {
  const int lanes = 1 << G.lanes_log;
  T acc[Dr];
#pragma unroll
  for (int a = 0; a < Dr; ++a) acc[a] = T(0);
  if (p.live) {
    for (int q = 0; q < G.n_tabs; ++q) {
      const FlatTab<T>& tb = ops.t[G.tab0 + q];
      switch (tb.dc) {
        case 2: flat_acc<T, Dr, 2, kMode>(tb, x, r, beta, p.row, p.lane,
                                          lanes, acc);
          break;
        case 3: flat_acc<T, Dr, 3, kMode>(tb, x, r, beta, p.row, p.lane,
                                          lanes, acc);
          break;
        default: flat_acc<T, Dr, 6, kMode>(tb, x, r, beta, p.row, p.lane,
                                           lanes, acc);
          break;
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int a = 0; a < Dr; ++a)
      acc[a] += __shfl_down_sync(0xffffffffu, acc[a], o, lanes);
  if (p.live && p.lane == 0) {
    const long long at0 = G.off + p.row * Dr;
#pragma unroll
    for (int a = 0; a < Dr; ++a) {
      const long long at = at0 + a;
      y[at] = acc[a];
      if constexpr (kMode == kFlatDot) {
        local += x[at] * acc[a];
      } else if constexpr (kMode == kFlatFold) {
        const T pn = beta * x[at] + r[at];
        x_new[at] = pn;
        local += pn * acc[a];
      }
    }
  }
}

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads) pair_flat_kernel(
    const __grid_constant__ FlatOps<T> ops, const T* __restrict__ scal,
    const T* __restrict__ x, const T* __restrict__ r, T* __restrict__ x_new,
    T* __restrict__ y, T* __restrict__ partials) {
  __shared__ T smem[32];
  const FlatPlace p = flat_place(ops);
  const FlatGroup& G = ops.g[p.gi];
  T beta = T(0);
  if constexpr (kMode == kFlatFold) beta = scal[kPairBeta];
  T local = T(0);
  switch (G.dr) {
    case 2: flat_row<T, 2, kMode>(ops, G, p, beta, x, r, x_new, y, local);
      break;
    case 3: flat_row<T, 3, kMode>(ops, G, p, beta, x, r, x_new, y, local);
      break;
    default: flat_row<T, 6, kMode>(ops, G, p, beta, x, r, x_new, y, local);
      break;
  }
  if constexpr (kMode != kFlatMul) {
    // cg_update_xr, launched after it with programmatic stream
    // serialization, may be placed once every block is here; its blocks
    // wait for this grid to finish
    asm volatile("griddepcontrol.launch_dependents;");
    const T total = block_sum(local, smem);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
  }
}

template <typename T>
__device__ __forceinline__ T pair_abs(T v) { return v < T(0) ? -v : v; }

// The row sums of |S| over one table's slots j = lane, lane + lanes, ...
// (the walk of flat_acc).
template <typename T, int Dr, int Dc>
__device__ __forceinline__ void flat_abs(const FlatTab<T>& tb, long long row,
                                         int lane, int lanes, T (&acc)[Dr]) {
  const int b0 = __ldg(tb.rowptr + row);
  const int cnt = __ldg(tb.rowptr + row + 1) - b0;
  const T* v = tb.vals + b0;
  for (int j = lane; j < cnt; j += lanes)
#pragma unroll
    for (int a = 0; a < Dr; ++a)
#pragma unroll
      for (int t = 0; t < Dc; ++t)
        acc[a] += pair_abs(__ldg(v + j + (a * Dc + t) * tb.used));
}

// The row sums over the group's tables, added across the lanes; lane 0's
// maximum over its outputs.
template <typename T, int Dr>
__device__ __forceinline__ T flat_row_abs(const FlatOps<T>& ops,
                                          const FlatGroup& G,
                                          const FlatPlace& p) {
  const int lanes = 1 << G.lanes_log;
  T acc[Dr];
#pragma unroll
  for (int a = 0; a < Dr; ++a) acc[a] = T(0);
  if (p.live) {
    for (int q = 0; q < G.n_tabs; ++q) {
      const FlatTab<T>& tb = ops.t[G.tab0 + q];
      switch (tb.dc) {
        case 2: flat_abs<T, Dr, 2>(tb, p.row, p.lane, lanes, acc); break;
        case 3: flat_abs<T, Dr, 3>(tb, p.row, p.lane, lanes, acc); break;
        default: flat_abs<T, Dr, 6>(tb, p.row, p.lane, lanes, acc);
      }
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1)
#pragma unroll
    for (int a = 0; a < Dr; ++a)
      acc[a] += __shfl_down_sync(0xffffffffu, acc[a], o, lanes);
  T m = T(0);
  if (p.live && p.lane == 0) {
    m = acc[0];
#pragma unroll
    for (int a = 1; a < Dr; ++a) m = nan_max(m, acc[a]);
  }
  return m;
}

// The teams of pair_flat; each block's maximum row sum into partials.
template <typename T>
__global__ void __launch_bounds__(kThreads) pair_bound_kernel(
    const __grid_constant__ FlatOps<T> ops, T* __restrict__ partials) {
  __shared__ T smem[32];
  const FlatPlace p = flat_place(ops);
  const FlatGroup& G = ops.g[p.gi];
  T m;
  switch (G.dr) {
    case 2: m = flat_row_abs<T, 2>(ops, G, p); break;
    case 3: m = flat_row_abs<T, 3>(ops, G, p); break;
    default: m = flat_row_abs<T, 6>(ops, G, p); break;
  }
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void pair_bound_final_kernel(const T* __restrict__ partials,
                                        int count, T* __restrict__ hi) {
  __shared__ T smem[32];
  T m = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    m = nan_max(m, partials[i]);
  const T total = block_max(m, smem);
  if (threadIdx.x == 0) hi[0] = nan_max(total, T(1e-3));
}

// -- launchers ------------------------------------------------------------

// desc: per unit 23 words: js, resid, rho1, info, jt[3], pos[3], out[3],
// dc[3], bpos, bout, n_t, n_edges, d, dr, block0.
constexpr int kStreamWords = 23;

template <typename T>
int launch_pair_stream(const long long* desc, int n_units, int n_blocks,
                       cudaStream_t stream) {
  if (n_units < 1 || n_units > kPairMaxUnits || n_blocks < 0)
    return pair_bad();
  StreamOps<T> ops = {};
  ops.n = n_units;
  for (int i = 0; i < n_units; ++i) {
    const long long* w = desc + i * kStreamWords;
    StreamUnit<T>& U = ops.u[i];
    U.js = reinterpret_cast<const T*>(w[0]);
    U.resid = reinterpret_cast<const T*>(w[1]);
    U.rho1 = reinterpret_cast<const T*>(w[2]);
    U.info = reinterpret_cast<const T*>(w[3]);
    for (int t = 0; t < kPairMaxSlots; ++t) {
      U.jt[t] = reinterpret_cast<const T*>(w[4 + t]);
      U.pos[t] = reinterpret_cast<const int*>(w[7 + t]);
      U.out[t] = reinterpret_cast<T*>(w[10 + t]);
      U.dc[t] = static_cast<int>(w[13 + t]);
    }
    U.bpos = reinterpret_cast<const int*>(w[16]);
    U.bout = reinterpret_cast<T*>(w[17]);
    U.n_t = static_cast<int>(w[18]);
    U.n_edges = static_cast<int>(w[19]);
    U.d = static_cast<int>(w[20]);
    U.dr = static_cast<int>(w[21]);
    U.block0 = static_cast<int>(w[22]);
    if (U.n_t < 1 || U.n_t > kPairMaxSlots || !pair_width_ok(U.dr)
        || U.d < 1 || U.d > kPairMaxResid)
      return pair_bad();
    for (int t = 0; t < U.n_t; ++t)
      if (!pair_width_ok(U.dc[t])) return pair_bad();
  }
  if (n_blocks == 0) return 0;
  pair_stream_kernel<T><<<n_blocks, kThreads, 0, stream>>>(ops);
  return launch_status();
}

// desc: per table 7 words: stream, ptr, out, n_rows, n_dest (K Nr, or N
// for b), entries, block0.
constexpr int kSumWords = 7;

template <typename T>
int launch_pair_sum(const long long* desc, int n_outs, int n_blocks,
                    cudaStream_t stream) {
  if (n_outs < 1 || n_outs > kPairMaxOuts || n_blocks < 0) return pair_bad();
  SumOps<T> ops = {};
  ops.n = n_outs;
  for (int i = 0; i < n_outs; ++i) {
    const long long* w = desc + i * kSumWords;
    SumOut<T>& O = ops.o[i];
    O.stream = reinterpret_cast<const T*>(w[0]);
    O.ptr = reinterpret_cast<const int*>(w[1]);
    O.out = reinterpret_cast<T*>(w[2]);
    const long long e = w[5];
    if (w[3] < 1 || w[4] < 0 || w[4] * e > 0x7fffffffLL
        || !(e == 2 || e == 3 || e == 4 || e == 6 || e == 9 || e == 12
             || e == 18 || e == 36))
      return pair_bad();
    O.n_rows = static_cast<int>(w[3]);
    O.n_dest = static_cast<int>(w[4]);
    O.entries = static_cast<int>(e);
    O.block0 = static_cast<int>(w[6]);
  }
  if (n_blocks == 0) return 0;
  pair_sum_kernel<T><<<n_blocks, kThreads, 0, stream>>>(ops);
  return launch_status();
}

template <typename T, int Dr, int Dc>
void run_pair_scale(const int* nb, const int* rowptr, const T* vals,
                    const T* linv_r, const T* linv_c, const T* extra, T* out,
                    int n, long long ncol, int k_width, long long used,
                    cudaStream_t stream) {
  const dim3 grid((n + kScaleRows - 1) / kScaleRows,
                  (k_width + kScaleSlots - 1) / kScaleSlots);
  pair_scale_kernel<T, Dr, Dc><<<grid, kScaleThreads, 0, stream>>>(
      nb, rowptr, vals, linv_r, linv_c, extra, out, n, ncol, used);
}

template <typename T, int Dr>
bool pair_scale_dc(const int* nb, const int* rowptr, const T* vals,
                   const T* linv_r, const T* linv_c, const T* extra, T* out,
                   int n, long long ncol, int k_width, long long used, int dc,
                   cudaStream_t stream) {
  switch (dc) {
    case 2: run_pair_scale<T, Dr, 2>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, stream);
      return true;
    case 3: run_pair_scale<T, Dr, 3>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, stream);
      return true;
    case 6: run_pair_scale<T, Dr, 6>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, stream);
      return true;
    default: return false;
  }
}

template <typename T>
int launch_pair_scale(const int* nb, const int* rowptr, const T* vals,
                      const T* linv_r, const T* linv_c, const T* extra,
                      T* out, int n, long long ncol, int k_width,
                      long long used, int dr, int dc, cudaStream_t stream) {
  if (n <= 0 || k_width <= 0 || used <= 0) return 0;
  if ((extra != nullptr && dr != dc) || k_width > 65535 * kScaleSlots)
    return pair_bad();
  bool ok = false;
  switch (dr) {
    case 2: ok = pair_scale_dc<T, 2>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, dc, stream);
      break;
    case 3: ok = pair_scale_dc<T, 3>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, dc, stream);
      break;
    case 6: ok = pair_scale_dc<T, 6>(nb, rowptr, vals, linv_r, linv_c, extra,
                                     out, n, ncol, k_width, used, dc, stream);
      break;
    default: break;
  }
  return ok ? launch_status() : pair_bad();
}

// desc: per row group 7 words (off, n, dr, lanes, block0, tab0, n_tabs),
// then per table 7 words (rowptr, cols, vals, used, col_off, ncol, dc:
// FlatTab); lanes a power of two up to 32.
constexpr int kFlatGroupWords = 7;
constexpr int kFlatTabWords = 7;

inline int ceil_log2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T>
bool fill_flat_ops(FlatOps<T>& ops, const long long* desc, int n_groups) {
  if (n_groups < 1 || n_groups > kPairMaxGroups) return false;
  ops = {};
  ops.n = n_groups;
  int n_tabs = 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* w = desc + i * kFlatGroupWords;
    FlatGroup& G = ops.g[i];
    G.off = w[0];
    G.n = static_cast<int>(w[1]);
    G.dr = static_cast<int>(w[2]);
    const int lanes = static_cast<int>(w[3]);
    G.block0 = static_cast<int>(w[4]);
    G.tab0 = static_cast<int>(w[5]);
    G.n_tabs = static_cast<int>(w[6]);
    if (!pair_width_ok(G.dr) || lanes < 1 || lanes > 32
        || (lanes & (lanes - 1)) != 0 || G.n < 0 || G.tab0 != n_tabs
        || G.n_tabs < 1 || G.n_tabs > kPairMaxPairs)
      return false;
    G.lanes_log = ceil_log2(lanes);
    G.rows_log = ceil_log2(kThreads) - G.lanes_log;
    n_tabs += G.n_tabs;
  }
  if (n_tabs > kPairMaxTables) return false;
  const long long* tw = desc + n_groups * kFlatGroupWords;
  for (int i = 0; i < n_tabs; ++i) {
    const long long* w = tw + i * kFlatTabWords;
    FlatTab<T>& tb = ops.t[i];
    tb.rowptr = reinterpret_cast<const int*>(w[0]);
    tb.cols = reinterpret_cast<const int*>(w[1]);
    tb.vals = reinterpret_cast<const T*>(w[2]);
    tb.used = w[3];
    tb.col_off = w[4];
    tb.ncol = static_cast<int>(w[5]);
    tb.dc = static_cast<int>(w[6]);
    if (!pair_width_ok(tb.dc) || tb.used < 0) return false;
  }
  return true;
}

template <typename T>
int launch_pair_flat(const long long* desc, int n_groups, int n_blocks,
                     int mode, const T* scal, const T* x, const T* r,
                     T* x_new, T* y, T* partials, cudaStream_t stream) {
  FlatOps<T> ops;
  if (!fill_flat_ops(ops, desc, n_groups) || n_blocks < 0 || mode < kFlatMul
      || mode > kFlatFold)
    return pair_bad();
  if (n_blocks == 0) return 0;
  switch (mode) {
    case kFlatMul:
      pair_flat_kernel<T, kFlatMul><<<n_blocks, kThreads, 0, stream>>>(
          ops, scal, x, r, x_new, y, partials);
      break;
    case kFlatDot:
      pair_flat_kernel<T, kFlatDot><<<n_blocks, kThreads, 0, stream>>>(
          ops, scal, x, r, x_new, y, partials);
      break;
    default:
      pair_flat_kernel<T, kFlatFold><<<n_blocks, kThreads, 0, stream>>>(
          ops, scal, x, r, x_new, y, partials);
      break;
  }
  return launch_status();
}

// The row-sum pass into `partials` (one per block); then, where hi is
// given, the final maximum over the first n_all entries of all_partials
// (the partials of every launch over the row groups, this one's last).
template <typename T>
int launch_pair_bound(const long long* desc, int n_groups, int n_blocks,
                      T* partials, const T* all_partials, int n_all, T* hi,
                      cudaStream_t stream) {
  FlatOps<T> ops;
  if (!fill_flat_ops(ops, desc, n_groups) || n_blocks < 0 || n_all < 0)
    return pair_bad();
  if (n_blocks > 0)
    pair_bound_kernel<T><<<n_blocks, kThreads, 0, stream>>>(ops, partials);
  if (hi != nullptr)
    pair_bound_final_kernel<T><<<1, 1024, 0, stream>>>(all_partials, n_all,
                                                       hi);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_PAIR_ENTRY(SUFFIX, T)                                              \
  int g2o_pair_stream_##SUFFIX(const long long* desc, int n_units,             \
                               int n_blocks, void* stream) {                   \
    return g2o_torch::launch_pair_stream<T>(                                   \
        desc, n_units, n_blocks, static_cast<cudaStream_t>(stream));           \
  }                                                                            \
  int g2o_pair_sum_##SUFFIX(const long long* desc, int n_outs, int n_blocks,   \
                            void* stream) {                                    \
    return g2o_torch::launch_pair_sum<T>(desc, n_outs, n_blocks,               \
                                         static_cast<cudaStream_t>(stream));   \
  }                                                                            \
  int g2o_pair_scale_##SUFFIX(const int* nb, const int* rowptr, const T* vals, \
                              const T* linv_r, const T* linv_c,               \
                              const T* extra, T* out, int n, long long ncol,   \
                              int k_width, long long used, int dr, int dc,     \
                              void* stream) {                                  \
    return g2o_torch::launch_pair_scale<T>(                                    \
        nb, rowptr, vals, linv_r, linv_c, extra, out, n, ncol, k_width, used,  \
        dr, dc, static_cast<cudaStream_t>(stream));                            \
  }                                                                            \
  int g2o_pair_flat_##SUFFIX(const long long* desc, int n_groups,              \
                             int n_blocks, int mode, const T* scal,            \
                             const T* x, const T* r, T* x_new, T* y,           \
                             T* partials, void* stream) {                      \
    return g2o_torch::launch_pair_flat<T>(                                     \
        desc, n_groups, n_blocks, mode, scal, x, r, x_new, y, partials,        \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_pair_bound_##SUFFIX(const long long* desc, int n_groups,             \
                              int n_blocks, T* partials,                       \
                              const T* all_partials, int n_all, T* hi,         \
                              void* stream) {                                  \
    return g2o_torch::launch_pair_bound<T>(                                    \
        desc, n_groups, n_blocks, partials, all_partials, n_all, hi,           \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_PAIR_ENTRY(f32, float)
G2O_PAIR_ENTRY(f64, double)

#undef G2O_PAIR_ENTRY

}  // extern "C"
