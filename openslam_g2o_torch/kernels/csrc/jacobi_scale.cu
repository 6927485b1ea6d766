// K4: symmetric block-Jacobi scaling of the damped block-ELL Hessian, and
// the per-row DxD block applications around the CG solve, D in {3, 6}.
//
// `jacobi_scale` replaces `hot_add_diag` + `hot_scale_jacobi`
// (openslam_g2o_tpu/core/sparse.py:1173-1247):
//
//   S[k, :, n] = M_n (B[k, :, n] + [k = 0] extra[n] I) M_{nb[k, n]}^T
//
// with M = L^-1 of the damped diagonal blocks, entries [D*D, N] (K3). The
// damping is folded in while the diagonal slot is read, so no damped copy
// of the values is made, and the neighbour's factor is gathered inside the
// kernel. The TPU code's DIA shift stack, its hoisted transposed index
// tables and the two-tier split after the scaling were layout decisions
// for lane gathers; here one thread owns one block row and loops over its
// K slots in order.
//
// An off-diagonal slot whose D*D entries are all zero (every padding
// slot: column 0, zero values) is written as exact zeros without touching
// the factors, so a NaN factor of row 0 or of the row itself does not leak
// into the padding: 0 * NaN would turn every padded row into NaN.
//
// `lane_block_mv` replaces `lane_block_mv` (core/sparse.py:871-880) for
// the unscale dx = M^T xhat and the warm start xhat0 = L^T dx0 of LM-PCG
// (D = 3, 6, and 2: the point_xy group of LM-PCG over several vertex
// groups), the widths it is built at.
//
// `lane_block_mv_dot` (K4) is the block-Jacobi step of the preconditioned
// CG of the Schur routes (D = 2, 3, 4, 6, 9), z = M r per row, with the partial sums of r . z that the CG step
// needs next, in one launch where `lane_block_mv` and then `dot_partials`
// (cg_step.cu) took two: the preconditioner step of `pcg_solve`
// (openslam_g2o_tpu/core/solvers.py:246-251 and the loop body after it).
// It gives a thread one output value (a, n), flat index i = a N + n, a
// block the kChunk values of one of dot_partials' partials. Each value is
// summed as lane_block_mv sums it; z and r go through shared memory to the
// threads that add each partial's products in dot_partials' order (kVec a
// thread, strided by kThreads) and reduce them as block_sum does; so z and
// the partials carry the bits of dot_partials(r, lane_block_mv(M, r)).
// Neighbouring threads read neighbouring addresses of M and r, and each
// thread has its value's 2 D loads in flight at once, where a row per
// thread issues D^2 + D: at the BAL camera's N = 900, D = 9, 8100 threads
// where a row per thread gives 900. On an H100 (kernel_times.py --only
// precond) this takes 3.0-3.1 / 3.4 us there (float32 / float64), below
// torch.bmm's 3.2-3.3 / 3.8 for z alone; kVec values a thread, as
// dot_partials lays them, took 3.95 / 4.89 (their loads not all in
// flight).
// `lane_block_mv` alone keeps its row per thread: a value per thread reads
// each r value D times, and on an H100 that measured slower at D = 2, 3
// and 6, the widths the paths run it at (PERF.md section 6).
//
// Bound of lane_block_mv_dot: memory, D*D + 2 D values per row (and the
// partials); at N = 900 that is under a microsecond, so launch latency is
// what remains, and the launch it removes is the lever.
//
// Registers: the thread holds M_i for all its slots and, per slot, B and
// M_j; the product is staged row by row (one row of C = M_i B, then that
// row of S), so at D = 6 three 36-value operands are live, not five.
//
// Bound: memory. jacobi_scale reads and writes the values once (D*D K N
// each) plus K indices and D*D K gathered factor entries per row; the
// factor table (D*D N values) stays in L2 at pose-graph sizes.
#include "common.cuh"

namespace g2o_torch {

template <typename T, int D>
__global__ void jacobi_scale_kernel(const int* __restrict__ nb,
                                    const T* __restrict__ vals,
                                    const T* __restrict__ linv,
                                    const T* __restrict__ extra,
                                    T* __restrict__ out, int n, int k_width) {
  constexpr int DD = D * D;
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T Mi[DD];
#pragma unroll
  for (int q = 0; q < DD; ++q) Mi[q] = linv[q * N + row];
  const T e = extra[row];
  for (int k = 0; k < k_width; ++k) {
    const T* v = vals + static_cast<long long>(k) * DD * N + row;
    T* o = out + static_cast<long long>(k) * DD * N + row;
    T B[DD];
    bool all_zero = true;
#pragma unroll
    for (int q = 0; q < DD; ++q) {
      B[q] = v[q * N];
      all_zero = all_zero && (B[q] == T(0));
    }
    if (k == 0) {
#pragma unroll
      for (int a = 0; a < D; ++a) B[(D + 1) * a] += e;
    } else if (all_zero) {
#pragma unroll
      for (int q = 0; q < DD; ++q) o[q * N] = T(0);
      continue;
    }
    const long long col = nb[k * N + row];
    T Mj[DD];
#pragma unroll
    for (int q = 0; q < DD; ++q) Mj[q] = linv[q * N + col];
    // row a of C = M_i B, then row a of S = C M_j^T; full products in
    // index order, as the plain version sums them
#pragma unroll
    for (int a = 0; a < D; ++a) {
      T C[D];
#pragma unroll
      for (int c = 0; c < D; ++c) {
        T acc = Mi[D * a] * B[c];
#pragma unroll
        for (int b = 1; b < D; ++b) acc += Mi[D * a + b] * B[D * b + c];
        C[c] = acc;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        T acc = C[0] * Mj[D * d];
#pragma unroll
        for (int c = 1; c < D; ++c) acc += C[c] * Mj[D * d + c];
        o[(D * a + d) * N] = acc;
      }
    }
  }
}

// y[a, n] = sum_b M[a, b, n] x[b, n]; transpose: sum_b M[b, a, n] x[b, n].
template <typename T, int D>
__global__ void lane_block_mv_kernel(const T* __restrict__ mats,
                                     const T* __restrict__ x,
                                     T* __restrict__ y, int n, int transpose) {
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  if (row >= n) return;
  const long long N = n;
  T xv[D];
#pragma unroll
  for (int b = 0; b < D; ++b) xv[b] = x[b * N + row];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    const int q0 = transpose ? a : D * a;
    const int step = transpose ? D : 1;
    T acc = mats[q0 * N + row] * xv[0];
#pragma unroll
    for (int b = 1; b < D; ++b) acc += mats[(q0 + b * step) * N + row] * xv[b];
    y[a * N + row] = acc;
  }
}

// z[i] = sum_b M[a, b, n] r[b, n] at i = a N + n: lane_block_mv_kernel's
// sum, term by term.
template <typename T, int D>
__device__ __forceinline__ T block_mv_value(const T* __restrict__ mats,
                                            const T* __restrict__ x,
                                            unsigned i, unsigned N) {
  const unsigned a = i / N;
  const unsigned row = i - a * N;
  const unsigned q0 = D * a;
  T acc = mats[q0 * N + row] * x[row];
#pragma unroll
  for (int b = 1; b < D; ++b)
    acc += mats[(q0 + b) * N + row] * x[b * N + row];
  return acc;
}

// z = M r and per block the partial sum of r[i] z[i] over its kChunk
// values in dot_partials' layout and order: a thread per value computes
// z[i] and leaves z[i] and r[i] in shared memory; then the first kThreads
// threads each add the kVec products that dot_partials' thread of the
// same index adds, in its order, and reduce as block_sum does over
// kThreads threads.
template <typename T, int D>
__global__ void __launch_bounds__(kChunk) lane_block_mv_dot_kernel(
    const T* __restrict__ mats, const T* __restrict__ x, T* __restrict__ y,
    T* __restrict__ partials, int n) {
  __shared__ T zs[kChunk];
  __shared__ T rs[kChunk];
  __shared__ T red[kThreads / 32];
  const unsigned N = static_cast<unsigned>(n);
  const unsigned total = D * N;
  const unsigned i0 = blockIdx.x * static_cast<unsigned>(kChunk);
  const unsigned t = threadIdx.x;
  if (i0 + t < total) {
    const T acc = block_mv_value<T, D>(mats, x, i0 + t, N);
    y[i0 + t] = acc;
    zs[t] = acc;
    rs[t] = x[i0 + t];
  }
  __syncthreads();
  if (t < kThreads) {
    T local = T(0);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      const unsigned u = t + v * kThreads;
      if (i0 + u < total) local += rs[u] * zs[u];   // dot_partials' term
    }
    for (int o = 16; o > 0; o >>= 1)
      local += __shfl_down_sync(0xffffffffu, local, o);
    if ((t & 31) == 0) red[t >> 5] = local;
  }
  __syncthreads();
  if (t == 0) {
    T sum = red[0];
    for (int w = 1; w < kThreads / 32; ++w) sum += red[w];
    partials[blockIdx.x] = sum;
  }
}

template <typename T, int D>
int run_jacobi_scale(const int* nb, const T* vals, const T* linv,
                     const T* extra, T* out, int n, int k_width,
                     cudaStream_t stream) {
  jacobi_scale_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, linv, extra, out, n, k_width);
  return launch_status();
}

template <typename T>
int launch_jacobi_scale(const int* nb, const T* vals, const T* linv,
                        const T* extra, T* out, int n, int k_width, int d,
                        cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 3:
      return run_jacobi_scale<T, 3>(nb, vals, linv, extra, out, n, k_width,
                                    stream);
    case 6:
      return run_jacobi_scale<T, 6>(nb, vals, linv, extra, out, n, k_width,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int run_lane_block_mv(const T* mats, const T* x, T* y, int n, int transpose,
                      cudaStream_t stream) {
  lane_block_mv_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      mats, x, y, n, transpose);
  return launch_status();
}

template <typename T>
int launch_lane_block_mv(const T* mats, const T* x, T* y, int n,
                         int transpose, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 2: return run_lane_block_mv<T, 2>(mats, x, y, n, transpose, stream);
    case 3: return run_lane_block_mv<T, 3>(mats, x, y, n, transpose, stream);
    case 6: return run_lane_block_mv<T, 6>(mats, x, y, n, transpose, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int D>
int run_lane_block_mv_dot(const T* mats, const T* x, T* y, T* partials,
                          int n, cudaStream_t stream) {
  lane_block_mv_dot_kernel<T, D>
      <<<chunks_for(static_cast<long long>(D) * n), kChunk, 0, stream>>>(
          mats, x, y, partials, n);
  return launch_status();
}

// n rows of width d; the table's index D D n must fit 32 bits (the wrapper
// checks it)
template <typename T>
int launch_lane_block_mv_dot(const T* mats, const T* x, T* y, T* partials,
                             int n, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  if (static_cast<long long>(d) * d * n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (d) {
    case 2: return run_lane_block_mv_dot<T, 2>(mats, x, y, partials, n,
                                               stream);
    case 3: return run_lane_block_mv_dot<T, 3>(mats, x, y, partials, n,
                                               stream);
    case 4: return run_lane_block_mv_dot<T, 4>(mats, x, y, partials, n,
                                               stream);
    case 6: return run_lane_block_mv_dot<T, 6>(mats, x, y, partials, n,
                                               stream);
    case 9: return run_lane_block_mv_dot<T, 9>(mats, x, y, partials, n,
                                               stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace g2o_torch

extern "C" {

int g2o_jacobi_scale_f32(const int* nb, const float* vals, const float* linv,
                         const float* extra, float* out, int n, int k_width,
                         int d, void* stream) {
  return g2o_torch::launch_jacobi_scale<float>(
      nb, vals, linv, extra, out, n, k_width, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_jacobi_scale_f64(const int* nb, const double* vals,
                         const double* linv, const double* extra, double* out,
                         int n, int k_width, int d, void* stream) {
  return g2o_torch::launch_jacobi_scale<double>(
      nb, vals, linv, extra, out, n, k_width, d,
      static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f32(const float* mats, const float* x, float* y, int n,
                          int transpose, int d, void* stream) {
  return g2o_torch::launch_lane_block_mv<float>(
      mats, x, y, n, transpose, d, static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_f64(const double* mats, const double* x, double* y,
                          int n, int transpose, int d, void* stream) {
  return g2o_torch::launch_lane_block_mv<double>(
      mats, x, y, n, transpose, d, static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_dot_f32(const float* mats, const float* x, float* y,
                              float* partials, int n, int d, void* stream) {
  return g2o_torch::launch_lane_block_mv_dot<float>(
      mats, x, y, partials, n, d, static_cast<cudaStream_t>(stream));
}

int g2o_lane_block_mv_dot_f64(const double* mats, const double* x,
                              double* y, double* partials, int n, int d,
                              void* stream) {
  return g2o_torch::launch_lane_block_mv_dot<double>(
      mats, x, y, partials, n, d, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
