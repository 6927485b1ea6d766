// The tile loader of the thread-per-edge kernels over K17's functors:
// K17's closed-form linearizer (edge_lin.cu `edge_lin_analytic_kernel`) and
// K7's trial chi2 (trial.cu `trial_edge_chi2_kernel`). A block takes a tile
// of consecutive edges, a thread an edge, and
//  1. starts the tile's contiguous runs -- the measurement [E, kMeas],
//     Omega [E, D, D], delta [E] and the parameter data [E, kPdata] and
//     [E, kPdata2] -- as asynchronous copies into shared memory (cp.async in
//     16-byte pieces wherever the run's start allows, so that each warp's
//     copy reads whole 128-byte lines, and no register waits on them);
//  2. gathers the slots' parameters (K17 also their free flags) into
//     registers while those copies are in flight; each slot's vertex index,
//     the head of that dependent chain, is loaded just before the copies
//     are issued;
//  3. waits once (cp.async.wait_group, a barrier); each thread then reads its
//     edge's records from shared memory and computes.
// The staged runs keep global memory's layout, edge-major, each starting
// 16-byte aligned. A thread reads its record of W values in 16- or 8-byte
// pieces where W values fill them (`tile_record`), which keeps a warp's
// reads to few bank conflicts: Omega of D = 6 in float32 is nine 16-byte
// pieces at an odd stride of pieces, conflict-free.
// A thread that loads its own edge's inputs reads them by strided loads
// behind the dependent index -> vertex gathers, and issues loads its
// registers cannot hold beside the error (Omega of D = 6) only after it.
#pragma once

#include <stdint.h>

#include "edge_functors.cuh"

namespace g2o_torch {

// The dynamic shared memory of a tile kernel
extern __shared__ __align__(16) unsigned char g2o_tile_smem[];

template <typename T>
__host__ __device__ constexpr int pad16(int n) {   // values, to 16 bytes
  return (n * static_cast<int>(sizeof(T)) + 15) / 16 * 16
         / static_cast<int>(sizeof(T));
}

// Issue the copy of the run src[0..count) into shared memory at dst (16-byte
// aligned) by the NT threads of the block: 16-byte pieces when src is
// 16-byte aligned, value by value otherwise and for the run's tail;
// consecutive threads on consecutive pieces, so that a warp reads whole
// lines.
template <int NT, typename T>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src,
                                            int count) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int pieces = count / kPer;
    for (int p = threadIdx.x; p < pieces; p += NT)
      cp_async16(dst + p * kPer, src + p * kPer);
    done = pieces * kPer;
  }
  for (int k = done + static_cast<int>(threadIdx.x); k < count; k += NT)
    cp_async_value(dst + k, src + k);
}

// The record rec[0..W) of one edge in shared memory -> out, in pieces of 16
// or 8 bytes where W values fill them (the record starts aligned to its
// piece: every run starts 16-byte aligned and records are W values apart)
template <int W, typename T>
__device__ __forceinline__ void tile_record(const T* rec, T* out) {
  constexpr int kBytes = W * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int p = 0; p < W / kPer; ++p) {
      Piece16<T> u;
      u.v = reinterpret_cast<const float4*>(rec)[p];
#pragma unroll
      for (int k = 0; k < kPer; ++k) out[p * kPer + k] = u.t[k];
    }
  } else if constexpr (kBytes % 8 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int p = 0; p < W / 2; ++p) {
      const float2 u = reinterpret_cast<const float2*>(rec)[p];
      out[2 * p] = u.x;
      out[2 * p + 1] = u.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) out[k] = rec[k];
  }
}

// in[0..W) -> the record rec[0..W) of one edge in shared memory, in the
// pieces tile_record reads
template <int W, typename T>
__device__ __forceinline__ void tile_put(T* rec, const T* in) {
  constexpr int kBytes = W * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int p = 0; p < W / kPer; ++p) {
      Piece16<T> u;
#pragma unroll
      for (int k = 0; k < kPer; ++k) u.t[k] = in[p * kPer + k];
      reinterpret_cast<float4*>(rec)[p] = u.v;
    }
  } else if constexpr (kBytes % 8 == 0 && sizeof(T) == 4) {
#pragma unroll
    for (int p = 0; p < W / 2; ++p)
      reinterpret_cast<float2*>(rec)[p] =
          make_float2(in[2 * p], in[2 * p + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) rec[k] = in[k];
  }
}

// The run src[0..count) in shared memory (16-byte aligned) -> dst in global
// memory, by the NT threads of the block: 16-byte pieces when dst is
// 16-byte aligned, value by value otherwise and for the tail; consecutive
// threads on consecutive pieces, so that a warp writes whole lines.
template <int NT, typename T>
__device__ __forceinline__ void store_tile_run(T* __restrict__ dst,
                                               const T* src, int count) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int pieces = count / kPer;
    for (int p = threadIdx.x; p < pieces; p += NT)
      reinterpret_cast<float4*>(dst)[p] =
          reinterpret_cast<const float4*>(src)[p];
    done = pieces * kPer;
  }
  for (int k = done + static_cast<int>(threadIdx.x); k < count; k += NT)
    dst[k] = src[k];
}

// e^T Omega e of one edge, in the order every kernel over K17's functors
// sums it (row by row, column by column)
template <int D, typename T>
__device__ __forceinline__ T quad_form(const T* err, const T* om) {
  T e2 = T(0);
#pragma unroll
  for (int r = 0; r < D; ++r)
#pragma unroll
    for (int c = 0; c < D; ++c) e2 += err[r] * om[r * D + c] * err[c];
  return e2;
}

// The staged inputs of a tile of kTile edges of functor F (a block of kTile
// threads): offsets (in values of T) of its runs in the dynamic shared
// memory, each 16-byte aligned. The measurement, Omega and delta are always
// staged; the parameter data only while the tile stays within kBudget
// bytes (a run left out is read from global memory by its thread after the
// wait, as load_edge reads it).
template <class F, typename T, int kTile, int kBudget>
struct EdgeTile {
  static constexpr int kMeasAt = 0;
  static constexpr int kInfoAt = kMeasAt + pad16<T>(kTile * F::kMeas);
  static constexpr int kDeltaAt = kInfoAt + pad16<T>(kTile * F::kD * F::kD);
  static constexpr int kPdAt = kDeltaAt + pad16<T>(kTile);
  static constexpr int kPdEnd = kPdAt + pad16<T>(kTile * F::kPdata);
  static constexpr bool kStagePd =
      kPdEnd * static_cast<int>(sizeof(T)) <= kBudget;
  static constexpr int kPd2At = kStagePd ? kPdEnd : kPdAt;
  static constexpr int kPd2End = kPd2At + pad16<T>(kTile * F::kPdata2);
  static constexpr bool kStagePd2 =
      kStagePd && kPd2End * static_cast<int>(sizeof(T)) <= kBudget;
  static constexpr int kValues = kStagePd2 ? kPd2End : kPd2At;
  static_assert(kValues * static_cast<int>(sizeof(T)) <= kBudget,
                "the measurement, Omega and delta exceed the tile's budget");

  // Step 1: issue the tile's runs (edges e0 .. e0 + n) and close the group
  template <class Args>
  __device__ __forceinline__ static void stage(const Args& a, T* t,
                                               long long e0, int n) {
    constexpr int D2 = F::kD * F::kD;
    stage_async<kTile>(t + kMeasAt, a.meas + e0 * F::kMeas, n * F::kMeas);
    stage_async<kTile>(t + kInfoAt, a.info + e0 * D2, n * D2);
    stage_async<kTile>(t + kDeltaAt, a.delta + e0, n);
    if constexpr (kStagePd && F::kPdata > 0)
      stage_async<kTile>(t + kPdAt, a.pdata[0] + e0 * F::kPdata,
                         n * F::kPdata);
    if constexpr (kStagePd2 && F::kPdata2 > 0)
      stage_async<kTile>(t + kPd2At, a.pdata[1] + e0 * F::kPdata2,
                         n * F::kPdata2);
    cp_async_commit();
  }

  // Step 3: wait for every copy of the block
  __device__ __forceinline__ static void wait() {
    cp_async_wait<0>();
    __syncthreads();
  }

  // Edge i of the tile (edge e of the group): its measurement and parameter
  // data
  template <class Args>
  __device__ __forceinline__ static void inputs(const Args& a, const T* t,
                                                long long e, int i, T* meas,
                                                T* pd) {
    tile_record<F::kMeas>(t + kMeasAt + i * F::kMeas, meas);
    if constexpr (F::kPdata > 0) {
      if constexpr (kStagePd)
        tile_record<F::kPdata>(t + kPdAt + i * F::kPdata, pd);
      else
#pragma unroll
        for (int k = 0; k < F::kPdata; ++k)
          pd[k] = a.pdata[0][e * F::kPdata + k];
    }
    if constexpr (F::kPdata2 > 0) {
      if constexpr (kStagePd2)
        tile_record<F::kPdata2>(t + kPd2At + i * F::kPdata2, pd + F::kPdata);
      else
#pragma unroll
        for (int k = 0; k < F::kPdata2; ++k)
          pd[F::kPdata + k] = a.pdata[1][e * F::kPdata2 + k];
    }
  }

  // e^T Omega e of edge i of the tile
  __device__ __forceinline__ static T chi2(const T* t, int i, const T* err) {
    constexpr int D2 = F::kD * F::kD;
    T om[D2];
    tile_record<D2>(t + kInfoAt + i * D2, om);
    return quad_form<F::kD>(err, om);
  }

  __device__ __forceinline__ static T delta(const T* t, int i) {
    return t[kDeltaAt + i];
  }
};

// Every slot's vertex index of edge e: the head of the dependent chain,
// loaded before the tile's copies are issued
template <class F, class Args>
__device__ __forceinline__ void load_indices(const Args& a, long long e,
                                             long long (&v)[kMaxSlots]) {
#pragma unroll
  for (int s = 0; s < F::kSlots; ++s) v[s] = a.idx[s][e];
}

// Step 2: the slots' parameters at the indices v, gathered into registers
// while the tile's copies are in flight
template <class F, typename T, class Args>
__device__ __forceinline__ void gather_slots(const Args& a,
                                             const long long (&v)[kMaxSlots],
                                             T (&x)[kMaxSlots][kMaxUsed]) {
#pragma unroll
  for (int s = 0; s < F::kSlots; ++s)
#pragma unroll
    for (int k = 0; k < F::used(s); ++k)
      x[s][k] = a.params[s][v[s] * F::stride(s) + k];
}

// Allow a tile kernel `bytes` of dynamic shared memory on the current
// device (its static and dynamic shared memory above 48 KB in all must opt
// in), once per device; `done` is the caller's per-kernel set of devices
// already allowed. Returns 0 or the CUDA error.
template <typename Kernel>
inline int allow_tile_smem(Kernel kernel, int bytes,
                           unsigned long long& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && (done >> dev & 1ull)) return 0;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done |= 1ull << dev;
  return static_cast<int>(err);
}

}  // namespace g2o_torch
