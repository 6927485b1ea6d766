// K14: the general Schur path (core/ba.py): the per-edge landmark blocks of
// an edge of any arity. K13's products (ba_coupling.cu) read the W it
// writes.
//
// Replaces the per-edge products and sorted segment sums of `schur_build`
// (openslam_g2o_tpu/core/ba.py:81-168, `_accumulate_lm`:171 and
// `_accumulate_pose`:177). For one edge group with one landmark slot and
// one of its pose slots t it forms Jl_w = Jl^T (w Omega), then (first pose
// slot only) Hll_e = Jl_w Jl and b_l,e = -Jl_w r into the lane-major
// landmark streams (summed per landmark by K10's ba_lm_sums), and
// W_e = Jt^T (w Omega) Jl [Dp, dl] into both layouts the products read:
// landmark-major [Dp*dl, K, L] at slot lm_pos[e] and pose-major [Dp*dl, M]
// at its CSR position pose_pos[e]. Every destination has one writer, so
// nothing is atomic.
//
// The TPU code sorted every (edge group, landmark slot, pose slot) by
// landmark and by pose once on the host and summed with sorted segment
// sums, because random scatters serialize on the TPU (ba.py:157-160). Here
// the host builds the same orderings as destination-major tables (the slot
// table per landmark, the CSR list and its chunks per pose vertex), and the
// sums run in a fixed order: a run repeats bit for bit.
//
// Instantiated at (Dp, dl) = (6, 3), (4, 3), (3, 2) and, for the 9-wide
// BAL camera of models/bal.py, (9, 3) with residual widths 1 and 2 only
// (edge_dims).
//
// Bound: memory. It reads (R + R dl + R Dp + 1 + R^2) values and two
// positions per edge and writes dl^2 + dl + 2 Dp dl. Two kernels, so that
// every output value is written by a coalesced store:
//   schur_tile_kernel   a block per tile of kEdgeTile consecutive edges
//                       stages the tile's inputs (each a contiguous run)
//                       in shared memory with coalesced loads, writes
//                       Hll_e and b_l,e (lane-major: coalesced), forms W_e
//                       into shared memory and stores it landmark-major in
//                       the tile's order of lm_pos (`lm_order`, host-built:
//                       core/ba.py build_schur_pattern). Edges come point
//                       by point, so a tile's landmark-major columns are a
//                       few runs of consecutive slots, written whole.
//   schur_dest_kernel   a thread per pose-major position, in CSR order
//                       (`pose_order`, host-built): it gathers its edge's
//                       contiguous records (Jl, Jt, Omega, rho') and
//                       stores W_e's Dp*dl rows at consecutive columns. In
//                       edge order those stores hit a sector each: the
//                       CSR order is camera by camera.
// Both form W_e by one function in the parent's order of operations, so
// the two layouts and the parent's one-thread-per-edge kernel agree bit
// for bit. Measured and dropped (PERF.md §6): the pose-major layout
// through the tile's order too (one pass; a sector a store where the CSR
// order is camera by camera), the landmark-major one by a destination
// pass (gathers at 4n), both kernels as one launch (the destination
// blocks then run at the tile blocks' occupancy), and the pose layout
// tiled where a tile's positions come in runs (no gain).
#include "ba_blocks.cuh"

namespace g2o_torch {

// Edges a block of schur_tile_kernel stages: kernels/schur_general.py
// EDGE_TILE, which the host's tile order is built for
constexpr int kEdgeTile = 128;

template <typename T>
struct SchurEdgeArgs {
  const T* resid;          // [E, R]
  const T* jl;             // [E, R, DL]
  const T* jp;             // [E, R, DP] or null
  const T* rho1;           // [E]
  const T* info;           // [E, R, R]
  int n_edges;
  long long off, ld;       // the streams' column offset and row stride
  T* hll;                  // [DL*DL, ld] or null
  T* bl;                   // [DL, ld] or null
  const int* lm_pos;       // [E]
  const int* lm_order;     // [E]: each tile's edges in the order of lm_pos
  long long ld_lm;
  T* w_lm;                 // [DP*DL, ld_lm]
  const int* pose_pos;     // [E]
  const int* pose_order;   // [E]: the edges in the order of pose_pos
  long long ld_pose;
  T* w_pose;               // [DP*DL, ld_pose]
};

template <typename T, int R>
__device__ __forceinline__ void weighted_info(T w, const T* info,
                                              T (&om)[R][R]) {
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) om[a][b] = w * info[a * R + b];
}

// Jl_w = Jl^T (w Omega), then Hll_e = Jl_w Jl and b_l,e = -Jl_w r into
// column `col` of the lane-major streams
template <typename T, int R, int DL>
__device__ __forceinline__ void landmark_block(const T (&r)[R],
                                               const T (&jl)[R][DL],
                                               const T (&om)[R][R],
                                               long long col, long long ld,
                                               T* __restrict__ hll,
                                               T* __restrict__ bl) {
#pragma unroll
  for (int s = 0; s < DL; ++s) {
    T jlw[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < R; ++a) acc += jl[a][s] * om[a][b];
      jlw[b] = acc;
    }
    T g = T(0);
#pragma unroll
    for (int b = 0; b < R; ++b) g += jlw[b] * r[b];
    bl[s * ld + col] = -g;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jlw[b] * jl[b][t];
      hll[(s * DL + t) * ld + col] = acc;
    }
  }
}

// W_e = Jt^T (w Omega) Jl [DP, DL] row-major, one row of Jt^T (w Omega) at
// a time; jp is the edge's [R, DP] record
template <typename T, int R, int DP, int DL>
__device__ __forceinline__ void w_block(const T* jp, const T (&om)[R][R],
                                        const T (&jl)[R][DL],
                                        T (&w)[DP * DL]) {
#pragma unroll
  for (int s = 0; s < DP; ++s) {
    T jpw[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < R; ++a) acc += jp[a * DP + s] * om[a][b];
      jpw[b] = acc;
    }
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jpw[b] * jl[b][t];
      w[s * DL + t] = acc;
    }
  }
}

// src[0..count) -> dst, consecutive threads on consecutive values
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* __restrict__ src,
                                          int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) dst[k] = src[k];
}

// Tile blocks: a block stages a tile of kEdgeTile consecutive edges,
// writes their Hll_e and b_l,e, and W_e landmark-major in the tile's order
// of lm_pos
template <typename T, int R, int DP, int DL>
__global__ void __launch_bounds__(kEdgeTile)
schur_tile_kernel(const SchurEdgeArgs<T> a) {
  constexpr int kIn = R + R * DL + R * DP + 1 + R * R;   // values an edge
  constexpr int kWs = (DP * DL) | 1;   // W_e's row in the stage (odd: no
                                       // bank conflicts in float32)
  constexpr int kStage = kIn > kWs ? kIn : kWs;
  static_assert(kEdgeTile * kStage * sizeof(T) + kEdgeTile * sizeof(int)
                    <= 48 * 1024,
                "the tile's stage must fit a static shared array");
  __shared__ T stage[kEdgeTile * kStage];
  __shared__ int s_pos[kEdgeTile];
  const long long e0 = static_cast<long long>(blockIdx.x) * kEdgeTile;
  const int n = static_cast<int>(
      a.n_edges - e0 < kEdgeTile ? a.n_edges - e0 : kEdgeTile);
  const int i = threadIdx.x;
  const bool want_w = a.w_lm != nullptr;
  T* s_r = stage;
  T* s_jl = s_r + kEdgeTile * R;
  T* s_jp = s_jl + kEdgeTile * R * DL;
  T* s_info = s_jp + kEdgeTile * R * DP;
  T* s_rho = s_info + kEdgeTile * R * R;
  if (a.hll != nullptr) stage_run(s_r, a.resid + e0 * R, n * R);
  stage_run(s_jl, a.jl + e0 * R * DL, n * R * DL);
  if (want_w) {
    stage_run(s_jp, a.jp + e0 * R * DP, n * R * DP);
    if (i < n) s_pos[i] = a.lm_pos[e0 + i];
  }
  stage_run(s_info, a.info + e0 * R * R, n * R * R);
  stage_run(s_rho, a.rho1 + e0, n);
  __syncthreads();
  T w_e[DP * DL];
  if (i < n) {
    T jl[R][DL], om[R][R];
#pragma unroll
    for (int b = 0; b < R; ++b)
#pragma unroll
      for (int s = 0; s < DL; ++s) jl[b][s] = s_jl[(i * R + b) * DL + s];
    weighted_info<T, R>(s_rho[i], s_info + i * R * R, om);
    if (a.hll != nullptr) {
      T r[R];
#pragma unroll
      for (int b = 0; b < R; ++b) r[b] = s_r[i * R + b];
      landmark_block<T, R, DL>(r, jl, om, a.off + e0 + i, a.ld, a.hll, a.bl);
    }
    if (want_w) w_block<T, R, DP, DL>(s_jp + i * R * DP, om, jl, w_e);
  }
  if (!want_w) return;                 // uniform over the block
  __syncthreads();                     // the inputs are read: W_e goes in
  if (i < n) {
#pragma unroll
    for (int k = 0; k < DP * DL; ++k) stage[i * kWs + k] = w_e[k];
  }
  __syncthreads();
  // in the tile's order of lm_pos: a warp's stores of one row are runs of
  // consecutive columns
  if (i < n) {
    const int li = a.lm_order[e0 + i] - static_cast<int>(e0);
    const long long pos = s_pos[li];
#pragma unroll
    for (int k = 0; k < DP * DL; ++k)
      a.w_lm[k * a.ld_lm + pos] = stage[li * kWs + k];
  }
}

// Destination blocks: a thread per pose-major position, in CSR order: the
// edge's records gathered, its W_e's rows stored at consecutive columns
template <typename T, int R, int DP, int DL>
__global__ void __launch_bounds__(kThreads)
schur_dest_kernel(const SchurEdgeArgs<T> a) {
  const long long j = blockIdx.x * static_cast<long long>(kThreads)
                      + threadIdx.x;
  if (j >= a.n_edges) return;
  const long long e = a.pose_order[j];
  const long long pos = a.pose_pos[e];
  T jl[R][DL], om[R][R], w_e[DP * DL];
#pragma unroll
  for (int b = 0; b < R; ++b)
#pragma unroll
    for (int s = 0; s < DL; ++s) jl[b][s] = a.jl[(e * R + b) * DL + s];
  weighted_info<T, R>(a.rho1[e], a.info + e * R * R, om);
  w_block<T, R, DP, DL>(a.jp + e * R * DP, om, jl, w_e);
#pragma unroll
  for (int k = 0; k < DP * DL; ++k) a.w_pose[k * a.ld_pose + pos] = w_e[k];
}

// -- launchers ---------------------------------------------------------------

template <typename T, int R, int DP, int DL>
int launch_edge(const SchurEdgeArgs<T>& a, cudaStream_t stream) {
  const int tiles = (a.n_edges + kEdgeTile - 1) / kEdgeTile;
  schur_tile_kernel<T, R, DP, DL><<<tiles, kEdgeTile, 0, stream>>>(a);
  if (a.w_pose != nullptr)
    schur_dest_kernel<T, R, DP, DL><<<grid_for(a.n_edges), kThreads, 0,
                                      stream>>>(a);
  return launch_status();
}

// residual widths 1 .. kMaxR; at (9, 3) kMaxR = 2 (kernels/schur_general.py
// MAX_RESIDUAL_AT): a float64 tile of R = 3 edges stages 49 values an edge,
// 50,176 bytes, over the 48 KB of a static array, and no built-in type has
// a 3-wide residual on the BAL camera
template <typename T, int DP, int DL, int kMaxR = 3>
int edge_dims(int R, const SchurEdgeArgs<T>& a, cudaStream_t stream) {
  switch (R) {
    case 1: return launch_edge<T, 1, DP, DL>(a, stream);
    case 2: return launch_edge<T, 2, DP, DL>(a, stream);
    case 3:
      if constexpr (kMaxR >= 3) return launch_edge<T, 3, DP, DL>(a, stream);
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_schur_edge(const SchurEdgeArgs<T>& a, int R, int DP, int DL,
                      int tile, cudaStream_t stream) {
  if (tile != kEdgeTile) return static_cast<int>(cudaErrorInvalidValue);
  if (a.n_edges <= 0) return 0;
  if (DP == 6 && DL == 3) return edge_dims<T, 6, 3>(R, a, stream);
  if (DP == 4 && DL == 3) return edge_dims<T, 4, 3>(R, a, stream);
  if (DP == 3 && DL == 2) return edge_dims<T, 3, 2>(R, a, stream);
  if (DP == 9 && DL == 3) return edge_dims<T, 9, 3, 2>(R, a, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace g2o_torch

extern "C" {

#define G2O_SCHUR_GENERAL_ENTRY(SUFFIX, T)                                     \
  int g2o_schur_edge_##SUFFIX(                                                 \
      const T* resid, const T* jl, const T* jp, const T* rho1, const T* info,  \
      int n_edges, long long off, long long ld, int R, int DP, int DL, T* hll, \
      T* bl, const int* lm_pos, const int* lm_order, long long ld_lm,          \
      T* w_lm, const int* pose_pos, const int* pose_order, long long ld_pose,  \
      T* w_pose, int tile, void* stream) {                                     \
    const g2o_torch::SchurEdgeArgs<T> a{                                       \
        resid, jl, jp, rho1, info, n_edges, off, ld, hll, bl, lm_pos,          \
        lm_order, ld_lm, w_lm, pose_pos, pose_order, ld_pose, w_pose};         \
    return g2o_torch::launch_schur_edge<T>(a, R, DP, DL, tile,                 \
                                           static_cast<cudaStream_t>(stream)); \
  }

G2O_SCHUR_GENERAL_ENTRY(f32, float)
G2O_SCHUR_GENERAL_ENTRY(f64, double)

#undef G2O_SCHUR_GENERAL_ENTRY

}  // extern "C"
