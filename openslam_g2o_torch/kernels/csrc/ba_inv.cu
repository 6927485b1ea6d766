// K11: the damped small-block inverses of the Schur solve.
//
// Replaces `_inv_lane` (openslam_g2o_tpu/core/ba_ell.py:376-417) with the
// damping of `_solve` folded in (:686-688, :694-702). One thread per block
// of a lane-major [D*D, N] table, D in {2, 3, 4, 6, 9} (4: the intrinsics
// blocks of the general Schur path's preconditioner, core/ba.py; 9: the
// BAL camera, models/bal.py):
//
//   mode 0  inv = A^-1                         (the preconditioner blocks)
//   mode 1  A + I (lam free + (1 - free)), inverted (landmarks: a fixed
//           landmark keeps its block and gets + I), and hib = inv b
//   mode 2  (A + lam I) free + (1 - free) I (cameras: a fixed camera's block
//           becomes I); the damped block is written, its inverse only if
//           asked for
//
// The inverse keeps the JAX formula, operation by operation: the
// closed-form adjugate for D <= 3 and, for D = 6 and 4, the 2x2-block Schur
// inversion with 3x3 or 2x2 quadrants; for D = 9 the same inversion with
// quadrants of 4 and 5, the 4 split 2 + 2 and the 5 split 2 + 3, as
// `_inv_lane` recurses. At D = 9 a thread holds 162 values of A and X
// beside the recursion's quadrants: in float64 they spill to local memory.
// Only the implicit route's preconditioner inverts 9-wide blocks, one per
// camera (900 at the 400,000-observation shape), so the spill costs little
// beside that route's CG; its camera damping (mode 2, no inverse) reads
// and writes each block once. (The general Schur path of the JAX
// package, core/ba.py:262, inverts its D > 3 preconditioner blocks with
// jnp.linalg.inv, an LU: the values agree to rounding.) No Cholesky: an
// indefinite block gives the same finite (or non-finite) values as the JAX
// code, and whether the solve is usable is decided where the JAX package
// decides it, by the dense factorization of S or by PCG. This file is
// built with -fmad=false (kernels/build.py): a product that overflows
// stays inf, so a*d - b*c of two overflowing products is NaN as in the
// plain version, not the finite value an FMA would round it to.
//
// Bound: memory. A D = 6 thread reads 36 values and writes 36 (72 in mode 2
// with the inverse) after ~500 operations.
#include "ba_blocks.cuh"

namespace g2o_torch {

template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[2][2],
                                              T (&X)[2][2]) {
  const T a = A[0][0], b = A[0][1], c = A[1][0], d = A[1][1];
  const T inv_det = T(1) / (a * d - b * c);
  X[0][0] = d * inv_det;
  X[0][1] = -b * inv_det;
  X[1][0] = -c * inv_det;
  X[1][1] = a * inv_det;
}

template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[3][3],
                                              T (&X)[3][3]) {
  const T a = A[0][0], b = A[0][1], c = A[0][2];
  const T d = A[1][0], e = A[1][1], f = A[1][2];
  const T g = A[2][0], h = A[2][1], i = A[2][2];
  const T A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const T A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const T A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const T inv_det = T(1) / (a * A11 + b * A21 + c * A31);
  X[0][0] = A11 * inv_det; X[0][1] = A12 * inv_det; X[0][2] = A13 * inv_det;
  X[1][0] = A21 * inv_det; X[1][1] = A22 * inv_det; X[1][2] = A23 * inv_det;
  X[2][0] = A31 * inv_det; X[2][1] = A32 * inv_det; X[2][2] = A33 * inv_det;
}

template <typename T>
__device__ __forceinline__ void mm3(const T (&A)[3][3], const T (&B)[3][3],
                                    T (&C)[3][3]) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < 3; ++b) acc += A[a][b] * B[b][c];
      C[a][c] = acc;
    }
}

template <typename T>
__device__ __forceinline__ void mm2(const T (&A)[2][2], const T (&B)[2][2],
                                    T (&C)[2][2]) {
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) C[a][c] = A[a][0] * B[0][c] + A[a][1] * B[1][c];
}

// D = 4 (the intrinsics blocks of the general Schur path's preconditioner):
// the formula below with 2x2 quadrants, each inverted by its adjugate, in
// the order of ba_inv.py `inv_lane_plain`
template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[4][4],
                                              T (&X)[4][4]) {
  T P[2][2], Q[2][2], R[2][2], S[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      P[a][b] = A[a][b];
      Q[a][b] = A[a][2 + b];
      R[a][b] = A[2 + a][b];
      S[a][b] = A[2 + a][2 + b];
    }
  T Pi[2][2], PiQ[2][2], RPiQ[2][2];
  block_inverse(P, Pi);
  mm2(Pi, Q, PiQ);
  mm2(R, PiQ, RPiQ);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) S[a][b] = S[a][b] - RPiQ[a][b];
  T Ti[2][2], RPi[2][2], TiRPi[2][2], PQT[2][2];
  block_inverse(S, Ti);
  mm2(R, Pi, RPi);
  mm2(Ti, RPi, TiRPi);
  mm2(PiQ, TiRPi, P);           // P reused: PiQ TiRPi
  mm2(PiQ, Ti, PQT);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      X[a][b] = Pi[a][b] + P[a][b];
      X[a][2 + b] = -PQT[a][b];
      X[2 + a][b] = -TiRPi[a][b];
      X[2 + a][2 + b] = Ti[a][b];
    }
}

// [[P, Q], [R, S]]^-1 = [[Pi + PiQ Ti RPi, -PiQ Ti], [-Ti RPi, Ti]],
// Pi = P^-1, Ti = (S - R Pi Q)^-1 (ba_ell.py:405-417)
template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[6][6],
                                              T (&X)[6][6]) {
  T P[3][3], Q[3][3], R[3][3], S[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      P[a][b] = A[a][b];
      Q[a][b] = A[a][3 + b];
      R[a][b] = A[3 + a][b];
      S[a][b] = A[3 + a][3 + b];
    }
  T Pi[3][3], PiQ[3][3], RPiQ[3][3];
  block_inverse(P, Pi);
  mm3(Pi, Q, PiQ);
  mm3(R, PiQ, RPiQ);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) S[a][b] = S[a][b] - RPiQ[a][b];
  T Ti[3][3], RPi[3][3], TiRPi[3][3], PQT[3][3];
  block_inverse(S, Ti);
  mm3(R, Pi, RPi);
  mm3(Ti, RPi, TiRPi);
  mm3(PiQ, TiRPi, P);           // P reused: PiQ TiRPi
  mm3(PiQ, Ti, PQT);
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      X[a][b] = Pi[a][b] + P[a][b];
      X[a][3 + b] = -PQT[a][b];
      X[3 + a][b] = -TiRPi[a][b];
      X[3 + a][3 + b] = Ti[a][b];
    }
}

// The product of an M x K and a K x N block, C = A B, each entry summed
// over b in order (the quadrant products of the splits below)
template <typename T, int M, int K, int N>
__device__ __forceinline__ void mm(const T (&A)[M][K], const T (&B)[K][N],
                                   T (&C)[M][N]) {
#pragma unroll
  for (int a = 0; a < M; ++a)
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < K; ++b) acc += A[a][b] * B[b][c];
      C[a][c] = acc;
    }
}

template <typename T, int D>
__device__ __forceinline__ void split_inverse(const T (&A)[D][D],
                                              T (&X)[D][D]);

template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[5][5],
                                              T (&X)[5][5]) {
  split_inverse<T, 5>(A, X);
}

template <typename T>
__device__ __forceinline__ void block_inverse(const T (&A)[9][9],
                                              T (&X)[9][9]) {
  split_inverse<T, 9>(A, X);
}

// The formula above for any D with quadrants of K = D / 2 and D - K (not
// square where D is odd): D = 5 as 2 + 3, D = 9 (the BAL camera blocks of
// models/bal.py) as 4 + 5, each quadrant inverted by its own overload,
// in the order of ba_inv.py `inv_lane_plain`
template <typename T, int D>
__device__ __forceinline__ void split_inverse(const T (&A)[D][D],
                                              T (&X)[D][D]) {
  constexpr int K = D / 2, J = D - K;
  T P[K][K], Q[K][J], R[J][K], S[J][J];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int b = 0; b < D; ++b) {
      if (a < K && b < K) P[a][b] = A[a][b];
      else if (a < K) Q[a][b - K] = A[a][b];
      else if (b < K) R[a - K][b] = A[a][b];
      else S[a - K][b - K] = A[a][b];
    }
  T Pi[K][K], PiQ[K][J], RPiQ[J][J];
  block_inverse(P, Pi);
  mm(Pi, Q, PiQ);
  mm(R, PiQ, RPiQ);
#pragma unroll
  for (int a = 0; a < J; ++a)
#pragma unroll
    for (int b = 0; b < J; ++b) S[a][b] = S[a][b] - RPiQ[a][b];
  T Ti[J][J], RPi[J][K], TiRPi[J][K], PTR[K][K], PQT[K][J];
  block_inverse(S, Ti);
  mm(R, Pi, RPi);
  mm(Ti, RPi, TiRPi);
  mm(PiQ, TiRPi, PTR);
  mm(PiQ, Ti, PQT);
#pragma unroll
  for (int a = 0; a < K; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) X[a][b] = Pi[a][b] + PTR[a][b];
#pragma unroll
    for (int b = 0; b < J; ++b) X[a][K + b] = -PQT[a][b];
  }
#pragma unroll
  for (int a = 0; a < J; ++a) {
#pragma unroll
    for (int b = 0; b < K; ++b) X[K + a][b] = -TiRPi[a][b];
#pragma unroll
    for (int b = 0; b < J; ++b) X[K + a][K + b] = Ti[a][b];
  }
}

template <typename T, int D>
__global__ void ba_inv_kernel(const T* __restrict__ A_in,
                              const T* __restrict__ free,
                              const T* __restrict__ lam_ptr,
                              const T* __restrict__ b, int n, int mode,
                              T* __restrict__ damped, T* __restrict__ inv,
                              T* __restrict__ hib) {
  const long long col = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (col >= n) return;
  const long long N = n;
  T A[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) A[a][c] = A_in[(a * D + c) * N + col];
  if (mode == 1) {
    const T f = free[col];
    const T add = *lam_ptr * f + (T(1) - f);
#pragma unroll
    for (int a = 0; a < D; ++a) A[a][a] = A[a][a] + add;
  } else if (mode == 2) {
    const T f = free[col], lam = *lam_ptr;
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const T eye = a == c ? T(1) : T(0);
        A[a][c] = (A[a][c] + lam * eye) * f + (T(1) - f) * eye;
      }
  }
  if (damped != nullptr) {
#pragma unroll
    for (int a = 0; a < D; ++a)
#pragma unroll
      for (int c = 0; c < D; ++c) damped[(a * D + c) * N + col] = A[a][c];
  }
  if (inv == nullptr) return;
  T X[D][D];
  block_inverse(A, X);
#pragma unroll
  for (int a = 0; a < D; ++a)
#pragma unroll
    for (int c = 0; c < D; ++c) inv[(a * D + c) * N + col] = X[a][c];
  if (hib != nullptr) {
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T acc = T(0);
#pragma unroll
      for (int c = 0; c < D; ++c) acc += X[a][c] * b[c * N + col];
      hib[a * N + col] = acc;
    }
  }
}

template <typename T>
int launch_ba_inv(const T* A, const T* free, const T* lam, const T* b, int n,
                  int D, int mode, T* damped, T* inv, T* hib,
                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const int grid = grid_for(n);
  switch (D) {
    case 2:
      ba_inv_kernel<T, 2><<<grid, kThreads, 0, stream>>>(
          A, free, lam, b, n, mode, damped, inv, hib);
      break;
    case 3:
      ba_inv_kernel<T, 3><<<grid, kThreads, 0, stream>>>(
          A, free, lam, b, n, mode, damped, inv, hib);
      break;
    case 4:
      ba_inv_kernel<T, 4><<<grid, kThreads, 0, stream>>>(
          A, free, lam, b, n, mode, damped, inv, hib);
      break;
    case 6:
      ba_inv_kernel<T, 6><<<grid, kThreads, 0, stream>>>(
          A, free, lam, b, n, mode, damped, inv, hib);
      break;
    case 9:
      ba_inv_kernel<T, 9><<<grid, kThreads, 0, stream>>>(
          A, free, lam, b, n, mode, damped, inv, hib);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_BA_INV_ENTRY(SUFFIX, T)                                            \
  int g2o_ba_inv_##SUFFIX(const T* A, const T* free, const T* lam,             \
                          const T* b, int n, int D, int mode, T* damped,       \
                          T* inv, T* hib, void* stream) {                      \
    return g2o_torch::launch_ba_inv<T>(A, free, lam, b, n, D, mode, damped,    \
                                       inv, hib,                               \
                                       static_cast<cudaStream_t>(stream));     \
  }

G2O_BA_INV_ENTRY(f32, float)
G2O_BA_INV_ENTRY(f64, double)

#undef G2O_BA_INV_ENTRY

}  // extern "C"
