// K15: deterministic assembly of the dense normal equations.
//
// Replaces `build_dense_system` (openslam_g2o_tpu/core/problem.py:415-458):
// per edge group and slot pair (s, t >= s) the batched products
//   W    = rho' Omega                      [D, D]
//   H_st = J_s^T W J_t                     [Ds, Dt]
//   b_s  = -J_s^T W e                      [Ds]
// scatter-added into the dense H [T, T] (the block and, off the diagonal,
// its transpose) and b [T], then raw_diag = diag(H) and the unit diagonal of
// fixed slots. XLA's scatter-add sums in one order; atomics on this card
// would not, so nothing here is atomic:
//
//   zero_fill       H and b, 16-byte stores (T^2 values: the largest traffic)
//   dense_pair      two launches per edge group and slot pair. The
//                   contributors of every destination block (p, q) form a
//                   CSR list built on the host once per topology
//                   (kernels/dense_assemble.py), cut into chunks of at most
//                   DENSE_CHUNK = 64 consecutive contributions. Pass 1: one
//                   thread per chunk forms the products of its contributions
//                   in table order and writes their sum to a scratch table.
//                   Pass 2: one thread per destination reads the block as
//                   the earlier launches left it, adds its chunks' sums in
//                   order, and writes the block and its mirror at (q, p).
//                   The (s, s) launch also owns b_s: the contributors of the
//                   diagonal block of a vertex are the contributors of its
//                   gradient. (One thread per whole list left the card idle
//                   on a hub: the intrinsics vertex that every observation
//                   of the general Schur path's P2MC_INTRINSICS scene sees
//                   took 53 ms in one thread.)
//   dense_finalize  raw_diag[t] = H[t, t]; H[t, t] += fixed[t]
//
// Launches run in stream order and a destination has one owner per pass,
// so every entry of H is summed in a fixed order and a run repeats bit for
// bit. A contribution's flag says how its block meets the destination:
// 0 as it is, 1 transposed (the edge runs the other way round than the
// destination's first contributor; only between slots of one width),
// 2 block plus transpose (both slots on the same vertex).
//
// Block widths are runtime arguments; the loops are unrolled to the template
// parameter kMaxD with the tail predicated off. The launcher picks kMaxD = 3
// when D, Ds and Dt are all at most G2O_DENSE_NARROW_WIDTH = 3 (every 2D
// type: the operands stay in registers) and kMaxD = 6 otherwise (the 6-wide
// SE3 blocks; six 36-value operands do not fit the register file in float64,
// so that instantiation spills to local memory: correct first). Compiled with
// -DG2O_DENSE_NARROW_WIDTH=0 every launch takes the kMaxD = 6 kernels, which
// is how chip_smoke.py measures what the narrow instantiation saves the 2D
// types.
//
// Bound: memory, by the zero fill. T = 12,000 in float64 is 1.15 GB of
// zeros against some 10 MB of Jacobians and tables.
#include "common.cuh"

#ifndef G2O_DENSE_NARROW_WIDTH
#define G2O_DENSE_NARROW_WIDTH 3
#endif

namespace g2o_torch {

template <typename T>
__global__ void zero_fill_kernel(T* __restrict__ out, long long n) {
  constexpr int kPer = 16 / sizeof(T);
  const long long nvec = n / kPer;
  const long long stride = gridDim.x * static_cast<long long>(blockDim.x);
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x)
                          + threadIdx.x;
  float4* out4 = reinterpret_cast<float4*>(out);       // all-zero bits are 0.0
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (long long i = first; i < nvec; i += stride) out4[i] = zero;
  for (long long i = nvec * kPer + first; i < n; i += stride) out[i] = T(0);
}

// pass 1: one thread per chunk of at most DENSE_CHUNK consecutive
// contributions of one destination, summed in table order into the scratch
// `part` ([kMaxD * kMaxD + kMaxD, n_chunks]: the block, then b_s)
template <typename T, int kMaxD>
__global__ void dense_pair_part_kernel(
    const T* __restrict__ jac_s, const T* __restrict__ jac_t,
    const T* __restrict__ rho1, const T* __restrict__ info,
    const T* __restrict__ resid, const int* __restrict__ chunk_ptr,
    const int* __restrict__ edge, const int* __restrict__ flag, int n_chunks,
    int D, int DS, int DT, int with_b, T* __restrict__ part) {
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= n_chunks) return;
  T acc[kMaxD][kMaxD], bacc[kMaxD];
#pragma unroll
  for (int a = 0; a < kMaxD; ++a) {
    bacc[a] = T(0);
#pragma unroll
    for (int c = 0; c < kMaxD; ++c) acc[a][c] = T(0);
  }
  const int m_end = chunk_ptr[ch + 1];
  for (int m = chunk_ptr[ch]; m < m_end; ++m) {
    const long long e = edge[m];
    const int f = flag[m];
    const T w = rho1[e];
    T js[kMaxD][kMaxD], jt[kMaxD][kMaxD], om[kMaxD][kMaxD], r[kMaxD];
#pragma unroll
    for (int a = 0; a < kMaxD; ++a) {
      r[a] = (with_b && a < D) ? resid[e * D + a] : T(0);
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) {
        js[a][c] = (a < D && c < DS) ? jac_s[(e * D + a) * DS + c] : T(0);
        jt[a][c] = (a < D && c < DT) ? jac_t[(e * D + a) * DT + c] : T(0);
        om[a][c] = (a < D && c < D) ? w * info[(e * D + a) * D + c] : T(0);
      }
    }
    T jw[kMaxD][kMaxD];                       // J_s^T (rho' Omega)
#pragma unroll
    for (int s = 0; s < kMaxD; ++s)
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) {
        T sum = T(0);
#pragma unroll
        for (int a = 0; a < kMaxD; ++a) sum += js[a][s] * om[a][c];
        jw[s][c] = sum;
      }
    T blk[kMaxD][kMaxD];                      // J_s^T W J_t
#pragma unroll
    for (int s = 0; s < kMaxD; ++s) {
      T g = T(0);
#pragma unroll
      for (int c = 0; c < kMaxD; ++c) g += jw[s][c] * r[c];
      bacc[s] += -g;
#pragma unroll
      for (int t = 0; t < kMaxD; ++t) {
        T sum = T(0);
#pragma unroll
        for (int c = 0; c < kMaxD; ++c) sum += jw[s][c] * jt[c][t];
        blk[s][t] = sum;
      }
    }
#pragma unroll
    for (int s = 0; s < kMaxD; ++s)
#pragma unroll
      for (int t = 0; t < kMaxD; ++t)
        acc[s][t] += f == 0 ? blk[s][t]
                     : f == 1 ? blk[t][s] : blk[s][t] + blk[t][s];
  }
  const long long NC = n_chunks;
#pragma unroll
  for (int a = 0; a < kMaxD; ++a) {
    if (with_b && a < DS) part[(kMaxD * kMaxD + a) * NC + ch] = bacc[a];
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (a < DS && c < DT) part[(a * kMaxD + c) * NC + ch] = acc[a][c];
  }
}

// pass 2: one thread per destination block (p, q): the block as the earlier
// launches left it, plus its chunks' sums in order; the block and its mirror
// at (q, p) written back (the (s, s) launch also owns b_s)
template <typename T, int kMaxD>
__global__ void dense_pair_finish_kernel(
    const T* __restrict__ part, const int* __restrict__ dest_chunk,
    const int* __restrict__ dest_p, const int* __restrict__ dest_q,
    T* __restrict__ H, T* __restrict__ b, long long ld, int n_dest,
    int n_chunks, int DS, int DT, int with_b) {
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= n_dest) return;
  const long long p = dest_p[d], q = dest_q[d], NC = n_chunks;
  const int c0 = dest_chunk[d], c1 = dest_chunk[d + 1];
#pragma unroll
  for (int a = 0; a < kMaxD; ++a) {
    if (with_b && a < DS) {
      T acc = b[p + a];
      for (int ch = c0; ch < c1; ++ch)
        acc += part[(kMaxD * kMaxD + a) * NC + ch];
      b[p + a] = acc;
    }
#pragma unroll
    for (int c = 0; c < kMaxD; ++c)
      if (a < DS && c < DT) {
        T acc = H[(p + a) * ld + q + c];
        for (int ch = c0; ch < c1; ++ch) acc += part[(a * kMaxD + c) * NC + ch];
        H[(p + a) * ld + q + c] = acc;
        if (p != q) H[(q + c) * ld + p + a] = acc;
      }
  }
}

template <typename T>
__global__ void dense_finalize_kernel(T* __restrict__ H,
                                      const T* __restrict__ fixed_t,
                                      T* __restrict__ raw_diag, int n,
                                      int add_fixed) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (t >= n) return;
  const long long at = t * (static_cast<long long>(n) + 1);
  const T raw = H[at];
  raw_diag[t] = raw;
  if (add_fixed) H[at] = raw + fixed_t[t];
}

template <typename T>
int launch_zero_fill(T* out, long long n, cudaStream_t stream) {
  if (n <= 0) return 0;
  const long long want = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(want < 132 * 8 ? want : 132 * 8);
  zero_fill_kernel<T><<<blocks, kThreads, 0, stream>>>(out, n);
  return launch_status();
}

template <typename T, int kMaxD>
void dense_pair_passes(const T* jac_s, const T* jac_t, const T* rho1,
                       const T* info, const T* resid, const int* chunk_ptr,
                       const int* dest_chunk, const int* dest_p,
                       const int* dest_q, const int* edge, const int* flag,
                       T* part, T* H, T* b, int total_dim, int n_dest,
                       int n_chunks, int D, int DS, int DT, int with_b,
                       cudaStream_t stream) {
  if (n_chunks > 0)
    dense_pair_part_kernel<T, kMaxD>
        <<<grid_for(n_chunks), kThreads, 0, stream>>>(
            jac_s, jac_t, rho1, info, resid, chunk_ptr, edge, flag, n_chunks,
            D, DS, DT, with_b, part);
  dense_pair_finish_kernel<T, kMaxD><<<grid_for(n_dest), kThreads, 0,
                                       stream>>>(
      part, dest_chunk, dest_p, dest_q, H, b, total_dim, n_dest, n_chunks, DS,
      DT, with_b);
}

template <typename T>
int launch_dense_pair(const T* jac_s, const T* jac_t, const T* rho1,
                      const T* info, const T* resid, const int* chunk_ptr,
                      const int* dest_chunk, const int* dest_p,
                      const int* dest_q, const int* edge, const int* flag,
                      T* part, T* H, T* b, int total_dim, int n_dest,
                      int n_chunks, int D, int DS, int DT, int with_b,
                      cudaStream_t stream) {
  if (n_dest <= 0) return 0;
  const int widest = D > DS ? (D > DT ? D : DT) : (DS > DT ? DS : DT);
  if (D < 1 || DS < 1 || DT < 1 || widest > 6)
    return static_cast<int>(cudaErrorInvalidValue);
  if (widest <= G2O_DENSE_NARROW_WIDTH)
    dense_pair_passes<T, 3>(jac_s, jac_t, rho1, info, resid, chunk_ptr,
                            dest_chunk, dest_p, dest_q, edge, flag, part, H, b,
                            total_dim, n_dest, n_chunks, D, DS, DT, with_b,
                            stream);
  else
    dense_pair_passes<T, 6>(jac_s, jac_t, rho1, info, resid, chunk_ptr,
                            dest_chunk, dest_p, dest_q, edge, flag, part, H, b,
                            total_dim, n_dest, n_chunks, D, DS, DT, with_b,
                            stream);
  return launch_status();
}

template <typename T>
int launch_dense_finalize(T* H, const T* fixed_t, T* raw_diag, int n,
                          int add_fixed, cudaStream_t stream) {
  if (n <= 0) return 0;
  dense_finalize_kernel<T><<<grid_for(n), kThreads, 0, stream>>>(
      H, fixed_t, raw_diag, n, add_fixed);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_DENSE_ENTRY(SUFFIX, T)                                             \
  int g2o_dense_zero_##SUFFIX(T* out, long long n, void* stream) {             \
    return g2o_torch::launch_zero_fill<T>(                                     \
        out, n, static_cast<cudaStream_t>(stream));                            \
  }                                                                            \
  int g2o_dense_pair_##SUFFIX(                                                 \
      const T* jac_s, const T* jac_t, const T* rho1, const T* info,            \
      const T* resid, const int* chunk_ptr, const int* dest_chunk,             \
      const int* dest_p, const int* dest_q, const int* edge, const int* flag,  \
      T* part, T* H, T* b, int total_dim, int n_dest, int n_chunks, int D,     \
      int DS, int DT, int with_b, void* stream) {                              \
    return g2o_torch::launch_dense_pair<T>(                                    \
        jac_s, jac_t, rho1, info, resid, chunk_ptr, dest_chunk, dest_p,        \
        dest_q, edge, flag, part, H, b, total_dim, n_dest, n_chunks, D, DS,    \
        DT, with_b, static_cast<cudaStream_t>(stream));                        \
  }                                                                            \
  int g2o_dense_finalize_##SUFFIX(T* H, const T* fixed_t, T* raw_diag, int n,  \
                                  int add_fixed, void* stream) {               \
    return g2o_torch::launch_dense_finalize<T>(                                \
        H, fixed_t, raw_diag, n, add_fixed,                                    \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_DENSE_ENTRY(f32, float)
G2O_DENSE_ENTRY(f64, double)

#undef G2O_DENSE_ENTRY

}  // extern "C"
