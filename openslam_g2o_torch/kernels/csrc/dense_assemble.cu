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
// would not, so no value is summed atomically:
//
//   zero_fill       H and b, 16-byte stores (T^2 values: the largest traffic)
//   dense_pair      one launch per edge group and slot pair. The
//                   contributors of every destination block (p, q) form a
//                   CSR list built on the host once per topology
//                   (kernels/dense_assemble.py), cut into chunks of at most
//                   DENSE_CHUNK = 64 consecutive contributions. A group of
//                   threads per chunk (16 lanes for kMaxD = 3, 64 for
//                   kMaxD = 6, 96 for kMaxD = 9) has a lane per entry of
//                   the destination:
//                   Ds Dt entries of the block, plus Ds of b_s in the
//                   (s, s) launch, which owns b_s (the contributors of the
//                   diagonal block of a vertex are the contributors of its
//                   gradient). The group stages a round of its chunk's
//                   records (J_s, J_t, Omega, e, rho', flag) in shared
//                   memory, every copy in flight at once (cp.async, 16-byte
//                   pieces where a record is a multiple of 16 bytes and
//                   aligned), forms J_s^T (rho' Omega) of each staged
//                   contribution a row entry a thread, and each entry lane
//                   adds its entry of every contribution in table order. A
//                   destination of one chunk is finished by that group: the
//                   block as the earlier launches left it plus the chunk's
//                   sum, written with its mirror at (q, p). Of several: each
//                   group writes its sums to a scratch row, fences them and
//                   counts its arrival on the destination's counter (the
//                   only atomic); the last to arrive adds the chunks' rows
//                   to the block in chunk order, staged through shared
//                   memory two buffers at a time, writes the block and its
//                   mirror and resets the counter.
//   dense_finalize  raw_diag[t] = H[t, t]; H[t, t] += fixed[t]
//
// Launches run in stream order and a destination has one owner per launch,
// so every entry of H is summed in a fixed order and a run repeats bit for
// bit. That order, and every product's, is the one of the two-pass form
// this replaced (a thread per chunk, then a thread per destination): each
// entry sums its chunk's contributions in table order, each contribution
// formed by the same operations in the same order, and the chunk sums are
// added to the prior value in chunk order, so the results keep its bits.
// A contribution's flag says how its block meets the destination: 0 as it
// is, 1 transposed (the edge runs the other way round than the
// destination's first contributor; only between slots of one width), 2
// block plus transpose (both slots on the same vertex).
//
// The residual width D is a template parameter (1 to kMaxD), the slot
// widths Ds, Dt are runtime arguments. The launcher picks kMaxD = 3 when
// D, Ds and Dt are all at most G2O_DENSE_NARROW_WIDTH = 3 (every 2D type:
// groups of 16 lanes, eight a block), kMaxD = 6 when they are at most 6
// (the 6-wide SE3 blocks: a block of 64 threads a chunk) and kMaxD = 9
// only above that (the 9-wide BAL camera of models/bal.py: a block of 96
// threads a chunk, for its 81 + 9 entries; a round of its stage holds
// some 40-50 float64 contributions, so a 64-contribution chunk takes two
// rounds), so every narrower launch keeps its kernel and its bits. A
// slot pair of two widths (the BAL point's 3 against the camera's 9) is a
// rectangular block, always of flag 0: its slots name vertices of two
// groups. The two-pass form unrolled
// its loops to kMaxD over zero-padded operands; the padded terms that can
// change a bit are kept (see dense_pair_kernel). Compiled with
// -DG2O_DENSE_NARROW_WIDTH=0 every launch up to width 6 takes a kMaxD = 6
// kernel, which is how chip_smoke.py measures what the narrow
// instantiation saves the 2D types.
//
// Bound: memory, by the zero fill on the dense routes (T = 12,000 in
// float64 is 1.15 GB of zeros against some 10 MB of Jacobians and
// tables). On the general Schur path's pose slots the pair launches read
// the Jacobians, Omega, the residuals and the tables once (some 4 us at
// 80,000 observations in float32). The two-pass form ran one thread per
// chunk (6 blocks of 256 on 132 SMs at 80,000 observations, each thread
// walking 64 contributions in registers, spilling at kMaxD = 6 in float64)
// and one thread per destination, which walked all of a hub's chunks once
// per entry (178 us on an H100 for the shared-intrinsics vertex of 80,000
// contributions).
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

// A group of kGroup threads per chunk, kPerBlock groups a block; each group
// stages its records in kBytes of shared memory.
constexpr int kDenseStageBytes = 16384;

template <int kMaxD>
struct DenseGroup {
  static constexpr int kGroup = kMaxD <= 3 ? 16 : kMaxD <= 6 ? 64 : 96;
  static constexpr int kPerBlock = kMaxD <= 3 ? 8 : 1;
  static constexpr int kBlock = kGroup * kPerBlock;
  static constexpr int kBytes = kDenseStageBytes / kPerBlock;
  static_assert(kGroup >= kMaxD * kMaxD + kMaxD, "a lane per entry");
  static_assert(kGroup < 32 || kPerBlock == 1, "a wide group is a block");
};

// a barrier over the group: half a warp, or the block
template <int kGroup>
__device__ __forceinline__ void group_sync() {
  if constexpr (kGroup >= 32) {
    __syncthreads();
  } else {
    const unsigned lane = threadIdx.x & 31u;
    __syncwarp(((1u << kGroup) - 1u) << (lane / kGroup * kGroup));
  }
}

// Issue the copies of `len` values per contribution, contributions m0 ..
// m0 + n - 1 of the table, from src + edge * len to dst + j * stride:
// 16-byte pieces when `vec` (len a multiple of 16 bytes, src aligned),
// else one value a copy. The group's lanes share the copies.
template <typename T, int kGroup>
__device__ __forceinline__ void stage_rows(T* dst, int stride,
                                           const T* __restrict__ src,
                                           int len, bool vec,
                                           const int* __restrict__ edge,
                                           int m0, int n, int lane) {
  if (vec) {
    constexpr int kV = 16 / sizeof(T);
    const int pieces = len / kV;
    for (int i = lane; i < n * pieces; i += kGroup) {
      const int j = i / pieces, k = i - j * pieces;
      const long long e = edge[m0 + j];
      cp_async16(dst + j * stride + k * kV, src + e * len + k * kV);
    }
  } else {
    for (int i = lane; i < n * len; i += kGroup) {
      const int j = i / len, k = i - j * len;
      const long long e = edge[m0 + j];
      cp_async_value(dst + j * stride + k, src + e * len + k);
    }
  }
}

// Rounded float/double operations that the compiler neither contracts nor
// folds: the products and sums below repeat the two-pass form's, which
// nvcc contracted to these fused multiply-adds.
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

// One launch per slot pair: a group per chunk (see the header), residual
// width D. `vec` bit 0/1/2/3: J_s / J_t / Omega / e copy in 16-byte
// pieces. `part` holds a row of `stride` values per chunk (the entries'
// sums) for the destinations of several chunks, `arrivals` a zero counter
// per destination.
//
// The two-pass form ran its loops to kMaxD over zero-padded operands. Its
// padded terms are kept here, each in the one operation it amounts to:
// J_s^T (rho' Omega) [s, c] for c < D gets fma(0, 0, sum) for every a >= D,
// which is sum + 0 (a -0 becomes +0, nothing else changes, and more of
// them change nothing more); its columns c >= D all hold one value, `pad`
// (sum over a of J_s[a, s] * 0: +-0, or NaN where the column holds an inf
// or a NaN); and each sum over c of the products then gets
// fma(pad, 0, sum) for every c >= D, again one operation.
template <typename T, int kMaxD, int D>
__global__ void __launch_bounds__(DenseGroup<kMaxD>::kBlock) dense_pair_kernel(
    const T* __restrict__ jac_s, const T* __restrict__ jac_t,
    const T* __restrict__ rho1, const T* __restrict__ info,
    const T* __restrict__ resid, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_dest, const int* __restrict__ dest_chunk,
    const int* __restrict__ dest_p, const int* __restrict__ dest_q,
    const int* __restrict__ edge, const int* __restrict__ flag,
    int* __restrict__ arrivals, T* __restrict__ part, T* __restrict__ H,
    T* __restrict__ b, long long ld, int n_chunks, int DS, int DT,
    int with_b, int vec) {
  using G = DenseGroup<kMaxD>;
  constexpr int kV = 16 / sizeof(T);
  constexpr bool kPadded = D < kMaxD;
  constexpr int kRow = D + 1;                 // a row of J_s^T W, then pad
  __shared__ __align__(16) unsigned char stage_all[kDenseStageBytes];
  __shared__ int last_all[G::kPerBlock];
  const int gi = threadIdx.x / G::kGroup, lane = threadIdx.x % G::kGroup;
  const int ch = blockIdx.x * G::kPerBlock + gi;
  if (ch >= n_chunks) return;                  // whole groups leave together
  unsigned char* stage = stage_all + gi * G::kBytes;
  const int d = chunk_dest[ch];
  const int c0 = dest_chunk[d], c1 = dest_chunk[d + 1];
  const long long p = dest_p[d], q = dest_q[d];
  // this lane's entry: (es, et) of the block, or es of b
  const int n_entries = DS * DT + (with_b ? DS : 0);
  const bool is_blk = lane < DS * DT;
  const bool owns = lane < n_entries;
  const int es = is_blk ? lane / DT : lane - DS * DT;
  const int et = is_blk ? lane - es * DT : 0;
  T* const out = is_blk ? H : b;
  const long long at = is_blk ? (p + es) * ld + q + et : p + es;
  const bool single = c1 - c0 == 1;
  T prior = T(0);
  if (single && owns) prior = out[at];        // in flight while staging
  // a round's layout in the group's shared memory, strides rounded up to
  // 16 bytes; a diagonal pair's J_t is its J_s
  const bool same = jac_s == jac_t && DS == DT;
  const int s_js = (D * DS + kV - 1) / kV * kV;
  const int s_jt = same ? 0 : (D * DT + kV - 1) / kV * kV;
  constexpr int s_info = (D * D + kV - 1) / kV * kV;
  const int s_r = with_b ? (D + kV - 1) / kV * kV : 0;
  const int n_jw = DS * kRow;
  const int R = G::kBytes / (static_cast<int>(sizeof(T))
                             * (s_js + s_jt + s_info + s_r + n_jw + 1) + 4);
  T* const sjs = reinterpret_cast<T*>(stage);
  T* const sjt = same ? sjs : sjs + R * s_js;
  const int t_stride = same ? s_js : s_jt;
  T* const sinfo = sjs + R * (s_js + s_jt);
  T* const sr = sinfo + R * s_info;
  T* const sjw = sr + R * s_r;
  T* const sw = sjw + R * n_jw;
  int* const sf = reinterpret_cast<int*>(sw + R);

  T acc = T(0);
  const int m_end = chunk_ptr[ch + 1];
  for (int m0 = chunk_ptr[ch]; m0 < m_end; m0 += R) {
    const int n = m_end - m0 < R ? m_end - m0 : R;
    stage_rows<T, G::kGroup>(sjs, s_js, jac_s, D * DS, vec & 1, edge, m0, n,
                             lane);
    if (!same)
      stage_rows<T, G::kGroup>(sjt, s_jt, jac_t, D * DT, vec & 2, edge, m0,
                               n, lane);
    stage_rows<T, G::kGroup>(sinfo, s_info, info, D * D, vec & 4, edge, m0,
                             n, lane);
    if (with_b)
      stage_rows<T, G::kGroup>(sr, s_r, resid, D, vec & 8, edge, m0, n,
                               lane);
    for (int j = lane; j < n; j += G::kGroup) {
      cp_async_value(sw + j, rho1 + edge[m0 + j]);
      cp_async_value(sf + j, flag + m0 + j);
    }
    cp_async_commit();
    cp_async_wait<0>();
    group_sync<G::kGroup>();
    // row s of J_s^T (rho' Omega) of each staged contribution, and its pad,
    // a row a thread
    for (int i = lane; i < n * DS; i += G::kGroup) {
      const int j = i / DS, s = i - j * DS;
      const T w = sw[j];
      const T* js = sjs + j * s_js;
      const T* om = sinfo + j * s_info;
      T jsv[D];
#pragma unroll
      for (int a = 0; a < D; ++a) jsv[a] = js[a * DS + s];
      T* row = sjw + i * kRow;
#pragma unroll
      for (int c = 0; c < D; ++c) {
        T sum = T(0);
#pragma unroll
        for (int a = 0; a < D; ++a)
          sum = fma_rn(jsv[a], mul_rn(w, om[a * D + c]), sum);
        if (kPadded) sum = add_rn(sum, T(0));
        row[c] = sum;
      }
      T pad = T(0);
#pragma unroll
      for (int a = 0; a < D; ++a) pad = fma_rn(jsv[a], T(0), pad);
      if (kPadded) pad = add_rn(pad, T(0));
      row[D] = pad;
    }
    group_sync<G::kGroup>();
    // each entry lane adds its entry of every contribution, in table order:
    // (J_s^T W J_t)[es, et], its transpose's, or both (the flag)
    if (is_blk) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const T* jw = sjw + j * n_jw;
        const T* jt = sjt + j * t_stride;
        const int f = sf[j];
        T st = T(0);
#pragma unroll
        for (int c = 0; c < D; ++c)
          st = fma_rn(jw[es * kRow + c], jt[c * DT + et], st);
        if (kPadded) st = fma_rn(jw[es * kRow + D], T(0), st);
        if (f == 0) {
          acc += st;
        } else {                                 // DS == DT
          T ts = T(0);
#pragma unroll
          for (int c = 0; c < D; ++c)
            ts = fma_rn(jw[et * kRow + c], jt[c * DT + es], ts);
          if (kPadded) ts = fma_rn(jw[et * kRow + D], T(0), ts);
          acc += f == 1 ? ts : st + ts;
        }
      }
    } else if (owns) {
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        const T* jw = sjw + j * n_jw + es * kRow;
        const T* r = sr + j * s_r;
        T g = T(0);
#pragma unroll
        for (int c = 0; c < D; ++c) g = fma_rn(jw[c], r[c], g);
        if (kPadded) g = fma_rn(jw[D], T(0), g);
        acc += -g;
      }
    }
    group_sync<G::kGroup>();                   // before the next round
  }

  if (single) {
    if (owns) {
      const T v = prior + acc;
      out[at] = v;
      if (is_blk && p != q) H[(q + et) * ld + p + es] = v;
    }
    return;
  }
  const int stride = (n_entries + kV - 1) / kV * kV;
  if (owns) part[static_cast<long long>(ch) * stride + lane] = acc;
  __threadfence();                             // the row, before the arrival
  group_sync<G::kGroup>();
  if (lane == 0) last_all[gi] = atomicAdd(arrivals + d, 1) == c1 - c0 - 1;
  group_sync<G::kGroup>();
  if (!last_all[gi]) return;
  __threadfence();
  // the last group of the destination: its prior value plus the chunks'
  // rows in chunk order, read through L2 (cp.async.cg), a buffer of `cap`
  // rows at a time, the next buffer in flight while one is summed
  T tot = owns ? out[at] : T(0);
  const int n = c1 - c0;
  const int cap = (G::kBytes / 2) / (stride * static_cast<int>(sizeof(T)));
  T* const buf0 = reinterpret_cast<T*>(stage);
  T* const buf1 = buf0 + cap * stride;
  const T* const rows = part + static_cast<long long>(c0) * stride;
  const int rounds = (n + cap - 1) / cap;
  for (int r = -1; r < rounds; ++r) {
    const int k0 = (r + 1) * cap;
    if (r + 1 < rounds) {
      const int pieces = (n - k0 < cap ? n - k0 : cap) * stride / kV;
      T* dst = (r + 1) & 1 ? buf1 : buf0;
      const T* src = rows + static_cast<long long>(k0) * stride;
      for (int i = lane; i < pieces; i += G::kGroup)
        cp_async16(dst + i * kV, src + i * kV);
    }
    cp_async_commit();
    if (r < 0) continue;
    cp_async_wait<1>();
    group_sync<G::kGroup>();
    if (owns) {
      const T* v = (r & 1 ? buf1 : buf0) + lane;
      const int cnt = n - r * cap < cap ? n - r * cap : cap;
#pragma unroll 8
      for (int k = 0; k < cnt; ++k) tot += v[k * stride];
    }
    group_sync<G::kGroup>();                   // before the buffer refills
  }
  if (owns) {
    out[at] = tot;
    if (is_blk && p != q) H[(q + et) * ld + p + es] = tot;
  }
  if (lane == 0) arrivals[d] = 0;
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

template <typename T, int kMaxD, int D>
void dense_pair_launch(const T* jac_s, const T* jac_t, const T* rho1,
                       const T* info, const T* resid, const int* chunk_ptr,
                       const int* chunk_dest, const int* dest_chunk,
                       const int* dest_p, const int* dest_q, const int* edge,
                       const int* flag, int* arrivals, T* part, T* H, T* b,
                       int total_dim, int n_chunks, int d, int DS, int DT,
                       int with_b, int vec, cudaStream_t stream) {
  if (d != D) {                                // the instantiation of width d
    if constexpr (D < kMaxD)
      dense_pair_launch<T, kMaxD, D + 1>(
          jac_s, jac_t, rho1, info, resid, chunk_ptr, chunk_dest, dest_chunk,
          dest_p, dest_q, edge, flag, arrivals, part, H, b, total_dim,
          n_chunks, d, DS, DT, with_b, vec, stream);
    return;
  }
  using G = DenseGroup<kMaxD>;
  const int grid = (n_chunks + G::kPerBlock - 1) / G::kPerBlock;
  dense_pair_kernel<T, kMaxD, D><<<grid, G::kBlock, 0, stream>>>(
      jac_s, jac_t, rho1, info, resid, chunk_ptr, chunk_dest, dest_chunk,
      dest_p, dest_q, edge, flag, arrivals, part, H, b, total_dim, n_chunks,
      DS, DT, with_b, vec);
}

// a record of `len` values per edge copies in 16-byte pieces when it is a
// multiple of 16 bytes long and its table is 16-byte aligned
template <typename T>
int vec_bit(const T* table, int len, int bit) {
  const bool ok = reinterpret_cast<unsigned long long>(table) % 16 == 0
                  && (len * sizeof(T)) % 16 == 0;
  return ok ? 1 << bit : 0;
}

template <typename T>
int launch_dense_pair(const T* jac_s, const T* jac_t, const T* rho1,
                      const T* info, const T* resid, const int* chunk_ptr,
                      const int* chunk_dest, const int* dest_chunk,
                      const int* dest_p, const int* dest_q, const int* edge,
                      const int* flag, int* arrivals, T* part, T* H, T* b,
                      int total_dim, int n_chunks, int D, int DS, int DT,
                      int with_b, cudaStream_t stream) {
  if (n_chunks <= 0) return 0;
  const int widest = D > DS ? (D > DT ? D : DT) : (DS > DT ? DS : DT);
  if (D < 1 || DS < 1 || DT < 1 || widest > 9 || (with_b && DS != DT))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = vec_bit(jac_s, D * DS, 0) | vec_bit(jac_t, D * DT, 1)
                  | vec_bit(info, D * D, 2) | vec_bit(resid, D, 3);
  if (widest <= G2O_DENSE_NARROW_WIDTH)
    dense_pair_launch<T, 3, 1>(jac_s, jac_t, rho1, info, resid,
                               chunk_ptr, chunk_dest, dest_chunk, dest_p,
                               dest_q, edge, flag, arrivals, part, H, b,
                               total_dim, n_chunks, D, DS, DT, with_b, vec,
                               stream);
  else if (widest <= 6)
    dense_pair_launch<T, 6, 1>(jac_s, jac_t, rho1, info, resid,
                               chunk_ptr, chunk_dest, dest_chunk, dest_p,
                               dest_q, edge, flag, arrivals, part, H, b,
                               total_dim, n_chunks, D, DS, DT, with_b, vec,
                               stream);
  else
    dense_pair_launch<T, 9, 1>(jac_s, jac_t, rho1, info, resid,
                               chunk_ptr, chunk_dest, dest_chunk, dest_p,
                               dest_q, edge, flag, arrivals, part, H, b,
                               total_dim, n_chunks, D, DS, DT, with_b, vec,
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
      const T* resid, const int* chunk_ptr, const int* chunk_dest,             \
      const int* dest_chunk, const int* dest_p, const int* dest_q,             \
      const int* edge, const int* flag, int* arrivals, T* part, T* H, T* b,    \
      int total_dim, int n_chunks, int D, int DS, int DT, int with_b,          \
      void* stream) {                                                          \
    return g2o_torch::launch_dense_pair<T>(                                    \
        jac_s, jac_t, rho1, info, resid, chunk_ptr, chunk_dest, dest_chunk,    \
        dest_p, dest_q, edge, flag, arrivals, part, H, b, total_dim,           \
        n_chunks, D, DS, DT, with_b, static_cast<cudaStream_t>(stream));       \
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
