// One block row of the 3x3 block-ELL product, shared by kernel A
// (block_ell_spmv.cu) and the fused product-with-dot of the CG step
// (cg_step.cu): y[s] = sum_k sum_t V[k, 3 s + t, row] * x[t, nb[k, row]],
// the K slots summed in slot order.
#pragma once

#include "common.cuh"

namespace g2o_torch {

template <typename T>
__device__ __forceinline__ void block_ell_row(const int* __restrict__ nb,
                                              const T* __restrict__ vals,
                                              const T* __restrict__ x,
                                              long long row, long long N,
                                              int k_width, T& y0, T& y1,
                                              T& y2) {
  y0 = T(0);
  y1 = T(0);
  y2 = T(0);
  for (int k = 0; k < k_width; ++k) {
    const long long col = nb[k * N + row];
    const T* v = vals + k * 9 * N + row;
    const T x0 = x[col];
    const T x1 = x[N + col];
    const T x2 = x[2 * N + col];
    y0 += v[0] * x0 + v[N] * x1 + v[2 * N] * x2;
    y1 += v[3 * N] * x0 + v[4 * N] * x1 + v[5 * N] * x2;
    y2 += v[6 * N] * x0 + v[7 * N] * x1 + v[8 * N] * x2;
  }
}

}  // namespace g2o_torch
