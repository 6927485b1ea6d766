// Helpers shared by the Schur bundle-adjustment kernels (K10-K13):
// ba_edge_blocks.cu, ba_inv.cu, ba_coupling.cu and ba_schur.cu.
//
// Layouts (kernels/ba_edge.py): the landmark half of the per-edge blocks
// is lane-major [rows, E] (edge on the fastest axis), every owner table
// [rows, N]; a DxD block is stored row-major in D*D rows (entry D a + b of
// column n). The camera half of each observation is one contiguous record
// (CamRecord) at the observation's place in its camera's CSR list, so that
// the camera sums read a camera's records in order. The
// observation-to-landmark coupling W (Dp x dl per observation) lives twice
// after the sums: landmark-major [Dp*dl, K, L] (slot k of landmark l at
// column k L + l) and camera-major [Dp*dl, E] in the CSR order of the
// camera lists.
#pragma once

#include "common.cuh"

namespace g2o_torch {

// One observation's camera record: Hcc_e (DP*DP, row-major), b_p,e (DP),
// W_e (DP*DL, row-major), zeros up to a multiple of 8 values, so that a
// record fills whole 32-byte sectors (64 values at (6, 3), 24 at (3, 2)).
template <int DP, int DL>
struct CamRecord {
  static constexpr int kHcc = 0, kBp = DP * DP, kW = DP * DP + DP;
  static constexpr int kSum = DP * DP + DP;             // values summed
  static constexpr int kUsed = kSum + DP * DL;
  static constexpr int kSize = (kUsed + 7) / 8 * 8;
};

// The per-edge products of openslam_g2o_tpu/core/ba_ell.py:565-576 for one
// edge with residual r [R], masked Jacobians Jl [R][DL] and Jc [R][DP],
// robust weight w and information Omega (row-major R x R), in the JAX
// order of operations:
//   Jl_w = Jl^T (w Omega),  Jc_w = Jc^T (w Omega)
//   Hll_e = Jl_w Jl,  b_l,e = -Jl_w r,  W_e = Jc_w Jl,
//   Hcc_e = Jc_w Jc,  b_p,e = -Jc_w r
// Hll_e, b_l,e and W_e go to column e of the lane-major streams of row
// stride `ld`; Hcc_e, b_p,e and W_e also to the record `rec` (unit stride:
// the edge's row of a shared-memory stage).
template <typename T, int R, int DP, int DL>
__device__ __forceinline__ void ba_edge_products(
    const T (&r)[R], const T (&jl)[R][DL], const T (&jc)[R][DP], T w,
    const T* __restrict__ info, long long e, long long ld,
    T* __restrict__ hll, T* __restrict__ bl, T* __restrict__ rec,
    T* __restrict__ w_lane) {
  using Rec = CamRecord<DP, DL>;
  T om[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int b = 0; b < R; ++b) om[a][b] = w * info[a * R + b];
  T jlw[DL][R];
#pragma unroll
  for (int s = 0; s < DL; ++s)
#pragma unroll
    for (int b = 0; b < R; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < R; ++a) acc += jl[a][s] * om[a][b];
      jlw[s][b] = acc;
    }
#pragma unroll
  for (int s = 0; s < DL; ++s) {
    T g = T(0);
#pragma unroll
    for (int b = 0; b < R; ++b) g += jlw[s][b] * r[b];
    bl[s * ld + e] = -g;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jlw[s][b] * jl[b][t];
      hll[(s * DL + t) * ld + e] = acc;
    }
  }
  // one row of Jc_w at a time: its W, Hcc and b_p rows
#pragma unroll
  for (int s = 0; s < DP; ++s) {
    T jcw[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < R; ++a) acc += jc[a][s] * om[a][b];
      jcw[b] = acc;
    }
    T g = T(0);
#pragma unroll
    for (int b = 0; b < R; ++b) g += jcw[b] * r[b];
    rec[Rec::kBp + s] = -g;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jcw[b] * jl[b][t];
      rec[Rec::kW + s * DL + t] = acc;
      w_lane[(s * DL + t) * ld + e] = acc;
    }
#pragma unroll
    for (int t = 0; t < DP; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jcw[b] * jc[b][t];
      rec[Rec::kHcc + s * DP + t] = acc;
    }
  }
#pragma unroll
  for (int q = Rec::kUsed; q < Rec::kSize; ++q) rec[q] = T(0);
}

// The records of one warp's edges, staged in `stage` (the row of lane i at
// i * (RS + 1)), written to their places: edge e0 + i goes to record
// cam_pos[off + e0 + i] of `rec` ([E, RS]). One record at a time, all lanes
// along it, so every store covers whole sectors in a scattered order and
// none strides. `count` (<= 32, the same in every lane) records are live.
template <typename T, int RS>
__device__ __forceinline__ void warp_store_records(
    const T* stage, long long e0, int count, long long off,
    const int* __restrict__ cam_pos, T* __restrict__ rec) {
  const int lane = threadIdx.x & 31;
  const long long mine = lane < count ? cam_pos[off + e0 + lane] : 0;
  for (int i = 0; i < count; ++i) {
    const long long pos = __shfl_sync(0xffffffffu, mine, i);
    const T* src = stage + i * (RS + 1);
    T* dst = rec + pos * RS;
#pragma unroll
    for (int q = lane; q < RS; q += 32) dst[q] = src[q];
  }
}

// Fixed-order reduction of NV per-thread accumulators over one block
// (blockDim.x a multiple of 32, at most kMaxWarps warps): a shuffle tree
// inside each warp, then thread v < NV adds the warps' totals of value v in
// warp order. The order depends on the thread layout alone, so a run
// repeats bit for bit. Returns, in thread v < NV, the total of value v.
constexpr int kMaxWarps = 8;

template <typename T, int NV>
__device__ __forceinline__ T block_reduce_values(T (&acc)[NV],
                                                 T (*smem)[NV]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    T x = acc[v];
    for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
    if (lane == 0) smem[warp][v] = x;
  }
  __syncthreads();
  T total = T(0);
  if (threadIdx.x < NV) {
    const int nw = static_cast<int>(blockDim.x >> 5);
    total = smem[0][threadIdx.x];
    for (int w = 1; w < nw; ++w) total += smem[w][threadIdx.x];
  }
  return total;
}

// The same inside one warp: lane 0 ends with every total.
template <typename T, int NV>
__device__ __forceinline__ void warp_reduce_values(T (&acc)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v)
    for (int o = 16; o > 0; o >>= 1)
      acc[v] += __shfl_down_sync(0xffffffffu, acc[v], o);
}

}  // namespace g2o_torch
