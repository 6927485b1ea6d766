// K12: the reduced camera system S of the dense-Schur route, formed
// directly from W and Hinv.
//
// Replaces the densified product of `_solve`
// (openslam_g2o_tpu/core/ba_ell.py:727-756): the JAX code densifies W into
// B2 [Tp, dl L] once per linearization (`_build` :647-668, 72 MB at 80,000
// observations) and forms S_corr = B2 Hinv B2^T with one MXU matmul of
// 21.6 GFLOP, almost all of it on zeros. Here S_corr is summed from its
// nonzero terms only: a host-built, destination-major table
// (kernels/ba_schur.py) lists, for every camera pair c1 <= c2 that shares a
// landmark (and every diagonal pair), the contributions (landmark l, slot
// k1 of c1, slot k2 of c2) in a fixed order. One warp owns one destination:
// its lanes take the contributions round-robin, each forming
// W_k1 Hinv_l W_k2^T (Dp x Dp) in registers, and a shuffle tree sums the
// lanes; lane 0 writes
//
//   S[c1, c2] = base - X,  S[c2, c1] = base' - X^T           (c1 < c2)
//   S[c, c]   = base - 0.5 (X + X^T) + Hcc_d[c]              (diagonal)
//
// which is -0.5 (S_corr + S_corr^T) (:748) with the diagonal blocks
// symmetrized as in the JAX code, plus Hcc_d (:749-754) and, where the
// graph has pose-pose edges, the dense Hpp_extra that `base` holds (:756).
// Blocks no pair touches keep what the caller filled S with (zeros, or
// Hpp_extra). No atomics: every block has one owner, so a run repeats bit
// for bit.
//
// The operands are records: W per observation slot ([K L, kW], the slot's
// Dp x dl block row-major, zeros up to a multiple of 16 bytes) and Hinv
// per landmark ([L, kH] likewise), made by `records_kernel` from the
// lane-major W [Dp dl, K L] (once per linearization) and Hinv [dl^2, L]
// (once per trial). A contribution reads 13 16-byte pieces at (6, 3) in
// float32 (23 in float64), all in flight at once, where the lane-major
// tables cost one 32-byte sector for every one of its 45 values; a
// diagonal block's contribution of one slot with itself reads its W record
// once. The operations and their order are those of the lane-major form
// this replaced, which keeps its bits. At (9, 3) (the BAL camera,
// models/bal.py) a lane holds 81 sums and a contribution reads 17 pieces
// in float32 (33 in float64); float64 spills part of them to local memory.
// Measured and dropped (float32 at
// 80,000 observations): the next contribution's records in flight during
// the current one's products, in a second register buffer or in shared
// memory by cp.async (2-4 stages, 1-4 warps a block); a warp copying its
// 32 lanes' records cooperatively (consecutive lanes on consecutive
// pieces); 8 or 16 warps a block. Each was slower than loading one
// contribution's records at a time with 4 warps a block.
//
// Bound: memory at the BAL shapes: W (Dp dl per observation), Hinv, the
// table (three ints per contribution) and S (Tp^2) once each; ~160 FMAs per
// contribution.
#include "ba_blocks.cuh"

namespace g2o_torch {

constexpr int kSchurWarps = 4;

// W per observation slot and Hinv per landmark as records of kW and kH
// values, zero padded to a multiple of 16 bytes (kV values a piece)
template <typename T, int DP, int DL>
struct SchurRecords {
  static constexpr int kV = 16 / sizeof(T);
  static constexpr int kW = (DP * DL + kV - 1) / kV * kV;
  static constexpr int kH = (DL * DL + kV - 1) / kV * kV;
};

// lane-major [ROWS, n] -> records [n, width]: out[i, r] = in[r, i] for
// r < ROWS, 0 up to width (ROWS rounded up to 16 bytes); a thread per
// record, every load in flight before its 16-byte stores
template <typename T, int ROWS>
__global__ void records_kernel(const T* __restrict__ in, long long n,
                               T* __restrict__ out) {
  constexpr int kV = 16 / sizeof(T), kWidth = (ROWS + kV - 1) / kV * kV;
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (i >= n) return;
  Piece16<T> piece[kWidth / kV];
#pragma unroll
  for (int r = 0; r < kWidth; ++r)
    piece[r / kV].t[r % kV] = r < ROWS ? in[r * n + i] : T(0);
  float4* dst = reinterpret_cast<float4*>(out + i * kWidth);
#pragma unroll
  for (int k = 0; k < kWidth / kV; ++k) dst[k] = piece[k].v;
}

template <typename T, int DP, int DL>
__global__ void __launch_bounds__(32 * kSchurWarps) ba_schur_kernel(
    const T* __restrict__ w_rec, const T* __restrict__ hinv_rec,
    const T* __restrict__ hcc_d, const int* __restrict__ ptr,
    const int* __restrict__ dest_c1, const int* __restrict__ dest_c2,
    const int* __restrict__ lm, const int* __restrict__ pos1,
    const int* __restrict__ pos2, int n_dest, int n_cam, int with_base,
    T* __restrict__ S) {
  using Rec = SchurRecords<T, DP, DL>;
  constexpr int DD = DP * DP, kV = Rec::kV, kW = Rec::kW, kH = Rec::kH;
  const int d = blockIdx.x * kSchurWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (d >= n_dest) return;                 // whole warps leave together
  const long long C = n_cam, ld = C * DP;
  T acc[DD];
#pragma unroll
  for (int q = 0; q < DD; ++q) acc[q] = T(0);
  const int m1 = ptr[d + 1];
  for (int m = ptr[d] + lane; m < m1; m += 32) {
    // the contribution's records, every 16-byte load in flight at once (a
    // diagonal block's slot k with itself reads its W record once)
    const long long l = lm[m], p1 = pos1[m], p2 = pos2[m];
    const float4* a = reinterpret_cast<const float4*>(w_rec + p1 * kW);
    const float4* c = reinterpret_cast<const float4*>(w_rec + p2 * kW);
    const float4* h = reinterpret_cast<const float4*>(hinv_rec + l * kH);
    Piece16<T> w1p[kW / kV], w2p[kW / kV], hp[kH / kV];
#pragma unroll
    for (int i = 0; i < kW / kV; ++i) w1p[i].v = __ldg(a + i);
#pragma unroll
    for (int i = 0; i < kW / kV; ++i)
      w2p[i].v = p1 == p2 ? w1p[i].v : __ldg(c + i);
#pragma unroll
    for (int i = 0; i < kH / kV; ++i) hp[i].v = __ldg(h + i);
    // W_k1 Hinv_l W_k2^T, in the operations and order of the lane-major
    // form
    T M[DL][DL], W2[DP][DL];
#pragma unroll
    for (int t = 0; t < DL; ++t)
#pragma unroll
      for (int u = 0; u < DL; ++u)
        M[t][u] = hp[(t * DL + u) / kV].t[(t * DL + u) % kV];
#pragma unroll
    for (int v = 0; v < DP; ++v)
#pragma unroll
      for (int u = 0; u < DL; ++u)
        W2[v][u] = w2p[(v * DL + u) / kV].t[(v * DL + u) % kV];
#pragma unroll
    for (int s = 0; s < DP; ++s) {
      T w1[DL], tmp[DL];
#pragma unroll
      for (int t = 0; t < DL; ++t)
        w1[t] = w1p[(s * DL + t) / kV].t[(s * DL + t) % kV];
#pragma unroll
      for (int u = 0; u < DL; ++u) {
        T acc_u = T(0);
#pragma unroll
        for (int t = 0; t < DL; ++t) acc_u += w1[t] * M[t][u];
        tmp[u] = acc_u;
      }
#pragma unroll
      for (int v = 0; v < DP; ++v) {
        T acc_v = T(0);
#pragma unroll
        for (int u = 0; u < DL; ++u) acc_v += tmp[u] * W2[v][u];
        acc[s * DP + v] += acc_v;
      }
    }
  }
  warp_reduce_values<T, DD>(acc);
  if (lane != 0) return;
  const long long c1 = dest_c1[d], c2 = dest_c2[d];
  const long long r1 = c1 * DP, r2 = c2 * DP;
  if (c1 == c2) {
#pragma unroll
    for (int s = 0; s < DP; ++s)
#pragma unroll
      for (int v = 0; v < DP; ++v) {
        const long long at = (r1 + s) * ld + r1 + v;
        const T sym = T(-0.5) * (acc[s * DP + v] + acc[v * DP + s]);
        const T val = sym + hcc_d[(s * DP + v) * C + c1];
        S[at] = with_base ? S[at] + val : val;
      }
    return;
  }
#pragma unroll
  for (int s = 0; s < DP; ++s)
#pragma unroll
    for (int v = 0; v < DP; ++v) {
      const long long at = (r1 + s) * ld + r2 + v;
      const long long mirror = (r2 + v) * ld + r1 + s;
      const T x = acc[s * DP + v];
      S[at] = with_base ? S[at] - x : -x;
      S[mirror] = with_base ? S[mirror] - x : -x;
    }
}

// rows: W at (6, 3), (3, 2) and (9, 3), Hinv at dl = 3 and 2
template <typename T>
int launch_records(const T* in, long long n, int rows, int width, T* out,
                   cudaStream_t stream) {
  if (n <= 0) return 0;
  constexpr int kV = 16 / sizeof(T);
  if (width != (rows + kV - 1) / kV * kV
      || reinterpret_cast<unsigned long long>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = grid_for(n);
  switch (rows) {
    case 27:
      records_kernel<T, 27><<<grid, kThreads, 0, stream>>>(in, n, out);
      break;
    case 18:
      records_kernel<T, 18><<<grid, kThreads, 0, stream>>>(in, n, out);
      break;
    case 9:
      records_kernel<T, 9><<<grid, kThreads, 0, stream>>>(in, n, out);
      break;
    case 6:
      records_kernel<T, 6><<<grid, kThreads, 0, stream>>>(in, n, out);
      break;
    case 4:
      records_kernel<T, 4><<<grid, kThreads, 0, stream>>>(in, n, out);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

template <typename T>
int launch_schur(const T* w_rec, const T* hinv_rec, const T* hcc_d,
                 const int* ptr, const int* dest_c1, const int* dest_c2,
                 const int* lm, const int* pos1, const int* pos2, int n_dest,
                 int n_cam, int with_base, int DP, int DL, T* S,
                 cudaStream_t stream) {
  if (n_dest <= 0) return 0;
  if (reinterpret_cast<unsigned long long>(w_rec) % 16 != 0
      || reinterpret_cast<unsigned long long>(hinv_rec) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (n_dest + kSchurWarps - 1) / kSchurWarps;
  if (DP == 6 && DL == 3)
    ba_schur_kernel<T, 6, 3><<<grid, 32 * kSchurWarps, 0, stream>>>(
        w_rec, hinv_rec, hcc_d, ptr, dest_c1, dest_c2, lm, pos1, pos2,
        n_dest, n_cam, with_base, S);
  else if (DP == 3 && DL == 2)
    ba_schur_kernel<T, 3, 2><<<grid, 32 * kSchurWarps, 0, stream>>>(
        w_rec, hinv_rec, hcc_d, ptr, dest_c1, dest_c2, lm, pos1, pos2,
        n_dest, n_cam, with_base, S);
  else if (DP == 9 && DL == 3)
    ba_schur_kernel<T, 9, 3><<<grid, 32 * kSchurWarps, 0, stream>>>(
        w_rec, hinv_rec, hcc_d, ptr, dest_c1, dest_c2, lm, pos1, pos2,
        n_dest, n_cam, with_base, S);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_BA_SCHUR_ENTRY(SUFFIX, T)                                          \
  int g2o_ba_records_##SUFFIX(const T* in, long long n, int rows, int width,  \
                              T* out, void* stream) {                         \
    return g2o_torch::launch_records<T>(in, n, rows, width, out,              \
                                        static_cast<cudaStream_t>(stream));   \
  }                                                                            \
  int g2o_ba_schur_##SUFFIX(const T* w_rec, const T* hinv_rec,                \
                            const T* hcc_d, const int* ptr,                    \
                            const int* dest_c1, const int* dest_c2,            \
                            const int* lm, const int* pos1, const int* pos2,   \
                            int n_dest, int n_cam, int with_base, int DP,      \
                            int DL, T* S, void* stream) {                      \
    return g2o_torch::launch_schur<T>(w_rec, hinv_rec, hcc_d, ptr, dest_c1,    \
                                      dest_c2, lm, pos1, pos2, n_dest, n_cam,  \
                                      with_base, DP, DL, S,                    \
                                      static_cast<cudaStream_t>(stream));      \
  }

G2O_BA_SCHUR_ENTRY(f32, float)
G2O_BA_SCHUR_ENTRY(f64, double)

#undef G2O_BA_SCHUR_ENTRY

}  // extern "C"
