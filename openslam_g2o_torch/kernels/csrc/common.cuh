// Shared helpers of the openslam_g2o_torch CUDA kernels.
//
// Every kernel is templated on float/double, launches on the stream the
// Python wrapper passes (PyTorch's current stream), allocates nothing and
// returns cudaGetLastError() as an int, which the wrapper turns into an
// exception. Built without -use_fast_math (kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace g2o_torch {

constexpr int kThreads = 256;

inline int grid_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}

// What a launcher returns right after its launches: 0 or the CUDA error.
inline int launch_status() { return static_cast<int>(cudaGetLastError()); }

// Explicit float/double overloads, so the float instantiation never
// promotes to double math.
__device__ __forceinline__ float dsin(float v) { return sinf(v); }
__device__ __forceinline__ double dsin(double v) { return sin(v); }
__device__ __forceinline__ float dcos(float v) { return cosf(v); }
__device__ __forceinline__ double dcos(double v) { return cos(v); }
__device__ __forceinline__ float dfloor(float v) { return floorf(v); }
__device__ __forceinline__ double dfloor(double v) { return floor(v); }
__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dlog(float v) { return logf(v); }
__device__ __forceinline__ double dlog(double v) { return log(v); }

// normalize_angle of openslam_g2o_tpu/ops/lie.py:60 (floor formula):
// theta - 2 pi floor((theta + pi) / (2 pi)).
template <typename T>
__device__ __forceinline__ T wrap_angle(T theta) {
  const T two_pi = static_cast<T>(6.283185307179586);
  const T pi = static_cast<T>(3.141592653589793);
  return theta - two_pi * dfloor((theta + pi) / two_pi);
}

// Deterministic block-wide reductions (blockDim.x a multiple of 32, at most
// 1024; `smem` holds 32 values). Every thread gets the result. The order
// of the operations is fixed by the thread layout alone, so two blocks that
// reduce the same values get the same bits, and so do two runs.
template <typename T>
__device__ __forceinline__ T block_sum(T v, T* smem) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                       // smem may still be read from before
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = smem[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w) total += smem[w];
  return total;
}

// max that keeps a NaN operand, as jnp.maximum and torch.maximum do
// (fmax would drop it).
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__device__ __forceinline__ T block_max(T v, T* smem) {
  for (int o = 16; o > 0; o >>= 1)
    v = nan_max(v, __shfl_down_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = v;
  __syncthreads();
  T total = smem[0];
  for (int w = 1; w < static_cast<int>(blockDim.x >> 5); ++w)
    total = nan_max(total, smem[w]);
  return total;
}

// Second pass of a two-pass sum: every thread of the block gets the sum of
// partials[0..count) in an order that depends on blockDim alone, so every
// block of every kernel that re-reduces the same partials sees one value.
template <typename T>
__device__ __forceinline__ T sum_partials(const T* __restrict__ partials,
                                          int count, T* smem) {
  T v = T(0);
  for (int i = threadIdx.x; i < count; i += blockDim.x) v += partials[i];
  return block_sum(v, smem);
}

// The vector kernels (CG updates, dots, Chebyshev) give each block kChunk
// consecutive elements: kVec per thread, strided by the block width so a
// warp's loads stay coalesced.
constexpr int kVec = 4;
constexpr int kChunk = kThreads * kVec;

inline int chunks_for(long long n) {
  return static_cast<int>(n <= 0 ? 1 : (n + kChunk - 1) / kChunk);
}

}  // namespace g2o_torch
