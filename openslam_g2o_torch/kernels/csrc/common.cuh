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

}  // namespace g2o_torch
