// One block row of the DxD block-ELL product, shared by kernel A
// (block_ell_spmv.cu) and the fused product-with-dot of the CG step
// (cg_step.cu): y[s] = sum_k sum_t V[k, D s + t, row] * x[t, nb[k, row]],
// the K slots summed in slot order and the D products of a block row in
// index order. `block_ell_row_of` takes the gather of a column as a
// functor (the fused CG step gathers beta p + r). D is a template parameter
// (3: SE2 poses, 6: SE3 poses), so the loops unroll and y stays in
// registers; the D = 3 instantiation is the arithmetic the 3x3 kernel
// always had.
#pragma once

#include "common.cuh"

namespace g2o_torch {

// The D values of column `col` of a lane-major [D, N] vector, gathered as
// the product reads them.
template <typename T, int D>
struct ColumnLoad {
  const T* __restrict__ x;
  long long N;
  __device__ __forceinline__ void operator()(long long col,
                                             T (&xg)[D]) const {
#pragma unroll
    for (int t = 0; t < D; ++t) xg[t] = x[t * N + col];
  }
};

template <typename T, int D, typename Column>
__device__ __forceinline__ void block_ell_row_of(const int* __restrict__ nb,
                                                 const T* __restrict__ vals,
                                                 const Column& column,
                                                 long long row, long long N,
                                                 int k_width, T (&y)[D]) {
#pragma unroll
  for (int s = 0; s < D; ++s) y[s] = T(0);
  for (int k = 0; k < k_width; ++k) {
    const long long col = nb[k * N + row];
    const T* v = vals + static_cast<long long>(k) * (D * D) * N + row;
    T xg[D];
    column(col, xg);
#pragma unroll
    for (int s = 0; s < D; ++s) {
      T acc = v[(D * s) * N] * xg[0];
#pragma unroll
      for (int t = 1; t < D; ++t) acc += v[(D * s + t) * N] * xg[t];
      y[s] += acc;
    }
  }
}

template <typename T, int D>
__device__ __forceinline__ void block_ell_row(const int* __restrict__ nb,
                                              const T* __restrict__ vals,
                                              const T* __restrict__ x,
                                              long long row, long long N,
                                              int k_width, T (&y)[D]) {
  block_ell_row_of<T, D>(nb, vals, ColumnLoad<T, D>{x, N}, row, N, k_width,
                         y);
}

// p . y of one block row, the products summed in index order.
template <typename T, int D>
__device__ __forceinline__ T row_dot(const T (&p)[D], const T (&y)[D]) {
  T acc = p[0] * y[0];
#pragma unroll
  for (int s = 1; s < D; ++s) acc += p[s] * y[s];
  return acc;
}

template <typename T, int D>
__device__ __forceinline__ T block_row_dot(const T* __restrict__ p,
                                           long long row, long long N,
                                           const T (&y)[D]) {
  T pr[D];
#pragma unroll
  for (int s = 0; s < D; ++s) pr[s] = p[s * N + row];
  return row_dot<T, D>(pr, y);
}

// Entry points take the block width at run time; a launcher switches over
// the instantiations and answers any other width with this.
inline int bad_block_width() { return static_cast<int>(cudaErrorInvalidValue); }

}  // namespace g2o_torch
