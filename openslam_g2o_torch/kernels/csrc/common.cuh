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

// Asynchronous copies from global to shared memory (cp.async, sm_80 on):
// the copy is issued and the thread goes on; cp_async_commit closes a
// group of them and cp_async_wait<N> waits until at most N of the issuing
// thread's groups are still in flight. Other threads see the data after a
// barrier that follows the wait; the issuing thread itself reads them
// after the wait. Every one is a compiler barrier ("memory"), so no read
// of a buffer moves past a copy into it, or a wait. `cp_async16` needs both
// addresses 16-byte aligned and reads through L2 only (.cg);
// `cp_async_value` copies one 4- or 8-byte value.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

template <typename V>
__device__ __forceinline__ void cp_async_value(V* smem, const V* gmem) {
  static_assert(sizeof(V) == 4 || sizeof(V) == 8, "4 or 8 bytes");
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (sizeof(V) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes seen as float4 or as the values of type T they hold
template <typename T>
union Piece16 {
  float4 v;
  T t[16 / sizeof(T)];
};

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

// rho'(e2) of every kernel in openslam_g2o_tpu/core/robust.py:83-99, by id.
template <typename T>
__device__ __forceinline__ T robust_rho1(int kernel_id, T e2, T delta) {
  const bool scaled = kernel_id >= 6;     // ScaleDelta:<inner>
  const int inner = scaled ? kernel_id - 5 : kernel_id;
  if (scaled) {
    e2 = e2 / (delta * delta);
    delta = T(1);
  }
  const T dsqr = delta * delta;
  switch (inner) {
    case 1: {  // Huber
      const T sqrte = dsqrt(e2 < T(1e-30) ? T(1e-30) : e2);  // NaN stays NaN
      return e2 <= dsqr ? T(1) : delta / sqrte;
    }
    case 2: {  // PseudoHuber
      const T aux1 = (T(1) / dsqr) * e2 + T(1);
      return T(1) / dsqrt(aux1);
    }
    case 3: {  // Cauchy
      const T aux = (T(1) / dsqr) * e2 + T(1);
      return T(1) / aux;
    }
    case 4:    // Saturated
      return e2 <= dsqr ? T(1) : T(0);
    case 5: {  // DCS
      T scale = (T(2) * delta) / (delta + e2);
      scale = scale > T(1) ? T(1) : scale;  // NaN stays NaN
      return scale * scale;
    }
    default:   // None
      return T(1);
  }
}

// rho(e2) of the same kernels (robust.py:21-99). The clamps keep a NaN, as
// torch.clamp_min / clamp_max do, so a non-finite e2 arrives as a
// non-finite rho wherever the kernel's formula passes it on (Saturated
// does not: its outlier branch is the constant delta^2).
template <typename T>
__device__ __forceinline__ T robust_rho0(int kernel_id, T e2, T delta) {
  const bool scaled = kernel_id >= 6;     // ScaleDelta:<inner>
  const int inner = scaled ? kernel_id - 5 : kernel_id;
  const T outer = delta * delta;
  if (scaled) {
    e2 = e2 / outer;
    delta = T(1);
  }
  const T dsqr = delta * delta;
  T rho;
  switch (inner) {
    case 1: {  // Huber
      const T sqrte = dsqrt(e2 < T(1e-30) ? T(1e-30) : e2);
      rho = e2 <= dsqr ? e2 : T(2) * sqrte * delta - dsqr;
      break;
    }
    case 2: {  // PseudoHuber
      const T aux1 = (T(1) / dsqr) * e2 + T(1);
      rho = T(2) * dsqr * (dsqrt(aux1) - T(1));
      break;
    }
    case 3: {  // Cauchy
      const T aux = (T(1) / dsqr) * e2 + T(1);
      rho = dsqr * dlog(aux);
      break;
    }
    case 4:    // Saturated
      rho = e2 <= dsqr ? e2 : dsqr;
      break;
    case 5: {  // DCS
      T scale = (T(2) * delta) / (delta + e2);
      scale = scale > T(1) ? T(1) : scale;
      rho = scale * e2 * scale;
      break;
    }
    default:   // None
      rho = e2;
  }
  return scaled ? rho * outer : rho;
}

}  // namespace g2o_torch
