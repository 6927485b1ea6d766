// K10: the per-linearization pass of the dual-ELL Schur solver.
//
// Replaces `_build` of openslam_g2o_tpu/core/ba_ell.py:537-619 (the
// per-edge J^T W J products and the owner sums `_reduce_k_lane`:445-461 and
// `_gather_w_lane`:464-479) and, in the fused entry, the linearization of
// EDGE_PROJECT_XYZ2UV (models/sba.py:147-185 and core/problem.py:350-392).
//
//   ba_xyz2uv    one thread per projection edge: pc = T_w2c p, the residual
//                obs - f pc.xy / pc.z - c, the analytic Jacobians (point:
//                de/dpc R(T); camera: [de/dpc (-[pc]x) | de/dpc]), the
//                fixed-vertex column masks, rho' by robust kernel id, then
//                the products of ba_blocks.cuh. Edge-major streams out.
//   ba_generic   the same products from the residual and masked Jacobians
//                `linearize` computed, for any other binary (landmark, pose)
//                edge type: R in {1, 2, 3}, (Dp, dl) in {(6, 3), (3, 2)}.
//   ba_lm_sums   a block per tile of 16 landmarks (4 where K > 8): the
//                tile's slots are staged in shared memory, then one thread
//                per (landmark, row) sums Hll and b_l over the slots in
//                slot order, and W is copied out into the landmark-major
//                [Dp*dl, K, L] layout (zeros on padding), coalesced along
//                k L + l; without W
//                (null w_e and w_lm) for the general Schur path, whose edge
//                kernel writes W itself (schur_general.cu).
//   ba_cam_sums  one block per camera: Hcc and b_p over its CSR list, each
//                thread a strided share, then block_reduce_values (a fixed
//                tree: no atomics, the same bits every run); and W copied
//                into the camera-major CSR layout.
//
// The TPU code reduced the camera side with a [E, C] one-hot matmul on the
// MXU (ba_ell.py:582-601) or with K-chunked lane gathers; the camera degree
// is skewed (55-1768 observations per camera at 400k observations), so a
// block per camera with a strided loop keeps the long lists parallel.
//
// Bound: memory. The edge pass reads ~20 values and writes
// dl^2 + dl + 2 Dp dl + Dp^2 + Dp per edge (72 at Dp = 6), the sums read
// them back once and write W twice.
#include "ba_blocks.cuh"

namespace g2o_torch {

constexpr int kCamThreads = 128;

template <typename T>
__global__ void ba_xyz2uv_kernel(
    const T* __restrict__ pts, const T* __restrict__ cams,
    const int* __restrict__ li, const int* __restrict__ ci,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, const T* __restrict__ camp,
    const T* __restrict__ free_l, const T* __restrict__ free_c,
    int kernel_id, int n_edges, long long off, long long ld, T* hll, T* bl,
    T* wblk, T* hcc, T* bp) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const long long l = li[e], c = ci[e];
  const T p0 = pts[3 * l], p1 = pts[3 * l + 1], p2 = pts[3 * l + 2];
  const T* cam = cams + 7 * c;
  const T t0 = cam[0], t1 = cam[1], t2 = cam[2];
  const T qx = cam[3], qy = cam[4], qz = cam[5], qw = cam[6];
  // pc = t + rotate(q, p): v + 2 (w (u x v) + u x (u x v)), u = q.xyz
  T uv0 = qy * p2 - qz * p1, uv1 = qz * p0 - qx * p2, uv2 = qx * p1 - qy * p0;
  const T x = t0 + (p0 + T(2) * (qw * uv0 + (qy * uv2 - qz * uv1)));
  const T y = t1 + (p1 + T(2) * (qw * uv1 + (qz * uv0 - qx * uv2)));
  const T z = t2 + (p2 + T(2) * (qw * uv2 + (qx * uv1 - qy * uv0)));
  const T f = camp[4 * e], cx = camp[4 * e + 1], cy = camp[4 * e + 2];
  T r[2];
  r[0] = meas[2 * e] - (x / z * f + cx);
  r[1] = meas[2 * e + 1] - (y / z * f + cy);
  const T* om = info + 4 * e;
  T e2 = T(0);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) e2 += r[a] * om[2 * a + b] * r[b];
  const T w = robust_rho1<T>(kernel_id, e2, delta[e]);
  // de/dpc = -f [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
  const T iz = T(1) / z;
  const T fiz = f * iz;
  T de[2][3] = {{-fiz, T(0), -(-fiz * x * iz)},
                {T(0), -fiz, -(-fiz * y * iz)}};
  // R(q): column k = rotate(q, e_k)
  T Rm[3][3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const T v0 = k == 0 ? T(1) : T(0), v1 = k == 1 ? T(1) : T(0),
            v2 = k == 2 ? T(1) : T(0);
    const T a0 = qy * v2 - qz * v1, a1 = qz * v0 - qx * v2,
            a2 = qx * v1 - qy * v0;
    Rm[0][k] = v0 + T(2) * (qw * a0 + (qy * a2 - qz * a1));
    Rm[1][k] = v1 + T(2) * (qw * a1 + (qz * a0 - qx * a2));
    Rm[2][k] = v2 + T(2) * (qw * a2 + (qx * a1 - qy * a0));
  }
  const T gk[3][3] = {{T(0), -z, y}, {z, T(0), -x}, {-y, x, T(0)}};
  const T fl = free_l[l], fc = free_c[c];
  T jl[2][3], jc[2][6];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      T sp = T(0), so = T(0);
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        sp += de[a][m] * Rm[m][k];
        so += de[a][m] * gk[m][k];
      }
      jl[a][k] = sp * fl;
      jc[a][k] = -so * fc;
      jc[a][3 + k] = de[a][k] * fc;
    }
  ba_edge_products<T, 2, 6, 3>(r, jl, jc, w, om, off + e, ld, hll, bl, wblk,
                               hcc, bp);
}

template <typename T, int R, int DP, int DL>
__global__ void ba_generic_kernel(
    const T* __restrict__ resid, const T* __restrict__ jl_in,
    const T* __restrict__ jc_in, const T* __restrict__ rho1,
    const T* __restrict__ info, int n_edges, long long off, long long ld,
    T* hll, T* bl, T* wblk, T* hcc, T* bp) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= n_edges) return;
  T r[R], jl[R][DL], jc[R][DP];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    r[a] = resid[e * R + a];
#pragma unroll
    for (int s = 0; s < DL; ++s) jl[a][s] = jl_in[(e * R + a) * DL + s];
#pragma unroll
    for (int s = 0; s < DP; ++s) jc[a][s] = jc_in[(e * R + a) * DP + s];
  }
  ba_edge_products<T, R, DP, DL>(r, jl, jc, rho1[e], info + e * R * R,
                                 off + e, ld, hll, bl, wblk, hcc, bp);
}

// ba_lm_sums: a block per tile of TL landmarks, their slots in chunks of
// KC = kLmSlots / TL (TL = 16 and KC = 8 at K <= 8, the BAL shapes; 4 and
// 32 for wider slot tables). Per chunk, every thread owns one
// slot (slots fastest within a landmark, so observations numbered
// point-major are read in order whatever the tile) and half or less of the
// rows: it reads the slot's observation id, then issues all its rows'
// loads at once, and parks the values in shared memory. Then one thread
// per (row, landmark) of Hll and b_l adds the chunk's values in slot order
// (padding slots add an exact +0, so the sum has the bits of a loop over
// the valid slots), and W leaves the stage landmark-major along
// pos = k L + l, a thread per (row, slot) with l fastest: shared memory
// transposes observation order into slot-major order. A chunk with no
// valid slot in the tile only writes W's zeros. Correct for any
// observation order and any K.
constexpr int kLmSlots = 128;      // slots of a tile per chunk
constexpr int kLmThreads = 256;
constexpr int kLmBlocksPerSM = 4;  // at most 64 registers a thread

template <typename T, int DP, int DL, bool WITH_W, int TL>
__global__ void __launch_bounds__(kLmThreads, kLmBlocksPerSM)
ba_lm_sums_kernel(
    const T* __restrict__ hll_e, const T* __restrict__ bl_e,
    const T* __restrict__ w_e, const int* __restrict__ lm_edge, int n_lm,
    int k_width, long long ld, T* __restrict__ hll, T* __restrict__ bl,
    T* __restrict__ w_lm) {
  constexpr int DD = DL * DL, NS = DD + DL, DW = DP * DL;
  constexpr int NR = WITH_W ? NS + DW : NS;       // rows staged
  constexpr int KC = kLmSlots / TL, PITCH = KC + 1;
  constexpr int ROW = TL * PITCH;                 // one row of the stage
  constexpr int LANES = kLmThreads / kLmSlots;    // threads per slot
  constexpr int PER = (NR + LANES - 1) / LANES;   // rows per thread
  static_assert(NS * TL <= kLmThreads, "a summing thread per value");
  __shared__ T stage[NR * ROW];                   // [row][l][k], k padded
  const long long L = n_lm, KL = static_cast<long long>(k_width) * L;
  const long long l0 = static_cast<long long>(blockIdx.x) * TL;
  // this thread's slot of the chunk, and its first row
  const int s = threadIdx.x % kLmSlots, q0 = threadIdx.x / kLmSlots;
  const int gl = s / KC, gk = s % KC;
  // and its (row, landmark) of the sums
  const int sq = threadIdx.x / TL, sl = threadIdx.x % TL;
  T acc = T(0);
  for (int k0 = 0; k0 < k_width; k0 += KC) {
    const long long o = (k0 + gk < k_width && l0 + gl < L)
        ? lm_edge[(k0 + gk) * L + l0 + gl] : -1;
    if (__syncthreads_or(o >= 0)) {
      T val[PER];
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int q = q0 + LANES * j;
        const T* src = q < DD ? hll_e + q * ld
                     : q < NS ? bl_e + (q - DD) * ld : w_e + (q - NS) * ld;
        val[j] = (q < NR && o >= 0) ? src[o] : T(0);
      }
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int q = q0 + LANES * j;
        if (q < NR) stage[q * ROW + gl * PITCH + gk] = val[j];
      }
      __syncthreads();
      if (sq < NS) {
        const T* row = stage + sq * ROW + sl * PITCH;
#pragma unroll
        for (int k = 0; k < KC; ++k) acc += row[k];
      }
      if (WITH_W) {
#pragma unroll 3
        for (int i = threadIdx.x; i < DW * kLmSlots; i += kLmThreads) {
          const int q = i / kLmSlots, t = i % kLmSlots;   // t = k TL + l
          const int k = t / TL, l = t % TL;
          if (k0 + k < k_width && l0 + l < L)
            w_lm[q * KL + (k0 + k) * L + l0 + l] =
                stage[(NS + q) * ROW + l * PITCH + k];
        }
      }
      __syncthreads();                            // the stage is reused
    } else if (WITH_W) {                          // padding only: zeros
      for (int i = threadIdx.x; i < DW * kLmSlots; i += kLmThreads) {
        const int q = i / kLmSlots, t = i % kLmSlots;
        const int k = t / TL, l = t % TL;
        if (k0 + k < k_width && l0 + l < L)
          w_lm[q * KL + (k0 + k) * L + l0 + l] = T(0);
      }
    }
  }
  if (sq < NS && l0 + sl < L) {
    if (sq < DD)
      hll[sq * L + l0 + sl] = acc;
    else
      bl[(sq - DD) * L + l0 + sl] = acc;
  }
}

template <typename T, int DP, int DL>
__global__ void ba_cam_sums_kernel(
    const T* __restrict__ hcc_e, const T* __restrict__ bp_e,
    const T* __restrict__ w_e, const int* __restrict__ cam_ptr,
    const int* __restrict__ cam_edge, int n_cam, long long ld,
    T* __restrict__ hcc, T* __restrict__ bp, T* __restrict__ w_cam) {
  constexpr int DD = DP * DP, NV = DD + DP, DW = DP * DL;
  __shared__ T smem[kMaxWarps][NV];
  const int c = blockIdx.x;
  const int j0 = cam_ptr[c], j1 = cam_ptr[c + 1];
  T acc[NV];
#pragma unroll
  for (int q = 0; q < NV; ++q) acc[q] = T(0);
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    const long long o = cam_edge[j];
#pragma unroll
    for (int q = 0; q < DD; ++q) acc[q] += hcc_e[q * ld + o];
#pragma unroll
    for (int q = 0; q < DP; ++q) acc[DD + q] += bp_e[q * ld + o];
    if (w_cam != nullptr) {
#pragma unroll
      for (int q = 0; q < DW; ++q) w_cam[q * ld + j] = w_e[q * ld + o];
    }
  }
  const T total = block_reduce_values<T, NV>(acc, smem);
  if (threadIdx.x < DD)
    hcc[threadIdx.x * static_cast<long long>(n_cam) + c] = total;
  else if (threadIdx.x < NV)
    bp[(threadIdx.x - DD) * static_cast<long long>(n_cam) + c] = total;
}

// -- launchers ---------------------------------------------------------------

template <typename T>
int launch_xyz2uv(const T* pts, const T* cams, const int* li, const int* ci,
                  const T* meas, const T* info, const T* delta, const T* camp,
                  const T* free_l, const T* free_c, int kernel_id, int n_edges,
                  long long off, long long ld, T* hll, T* bl, T* wblk, T* hcc,
                  T* bp, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  ba_xyz2uv_kernel<T><<<grid_for(n_edges), kThreads, 0, stream>>>(
      pts, cams, li, ci, meas, info, delta, camp, free_l, free_c, kernel_id,
      n_edges, off, ld, hll, bl, wblk, hcc, bp);
  return launch_status();
}

template <typename T, int DP, int DL>
int launch_generic_dims(int R, const T* resid, const T* jl, const T* jc,
                        const T* rho1, const T* info, int n_edges,
                        long long off, long long ld, T* hll, T* bl, T* wblk,
                        T* hcc, T* bp, cudaStream_t stream) {
  const int grid = grid_for(n_edges);
  switch (R) {
    case 1:
      ba_generic_kernel<T, 1, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jc, rho1, info, n_edges, off, ld, hll, bl, wblk, hcc, bp);
      break;
    case 2:
      ba_generic_kernel<T, 2, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jc, rho1, info, n_edges, off, ld, hll, bl, wblk, hcc, bp);
      break;
    case 3:
      ba_generic_kernel<T, 3, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jc, rho1, info, n_edges, off, ld, hll, bl, wblk, hcc, bp);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

template <typename T>
int launch_generic(const T* resid, const T* jl, const T* jc, const T* rho1,
                   const T* info, int n_edges, long long off, long long ld,
                   int R, int DP, int DL, T* hll, T* bl, T* wblk, T* hcc,
                   T* bp, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  if (DP == 6 && DL == 3)
    return launch_generic_dims<T, 6, 3>(R, resid, jl, jc, rho1, info, n_edges,
                                        off, ld, hll, bl, wblk, hcc, bp,
                                        stream);
  if (DP == 3 && DL == 2)
    return launch_generic_dims<T, 3, 2>(R, resid, jl, jc, rho1, info, n_edges,
                                        off, ld, hll, bl, wblk, hcc, bp,
                                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int DP, int DL, int TL>
void lm_sums_tile(const T* hll_e, const T* bl_e, const T* w_e,
                  const int* lm_edge, int n_lm, int k_width, long long ld,
                  T* hll, T* bl, T* w_lm, cudaStream_t stream) {
  const int grid = static_cast<int>((n_lm + TL - 1) / TL);
  if (w_lm != nullptr)
    ba_lm_sums_kernel<T, DP, DL, true, TL><<<grid, kLmThreads, 0, stream>>>(
        hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld, hll, bl, w_lm);
  else
    ba_lm_sums_kernel<T, DP, DL, false, TL><<<grid, kLmThreads, 0, stream>>>(
        hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld, hll, bl, w_lm);
}

// the tile: 16 landmarks of 8 slots up to K = 8 (the BAL shapes), else 4
// of 32 (the landmark worlds: K = 51 and 98, most slots padding), so that
// a few thousand landmarks still fill the card
template <typename T, int DP, int DL>
void lm_sums_dims(const T* hll_e, const T* bl_e, const T* w_e,
                  const int* lm_edge, int n_lm, int k_width, long long ld,
                  T* hll, T* bl, T* w_lm, cudaStream_t stream) {
  if (k_width <= kLmSlots / 16)
    lm_sums_tile<T, DP, DL, 16>(hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld,
                                hll, bl, w_lm, stream);
  else
    lm_sums_tile<T, DP, DL, 4>(hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld,
                               hll, bl, w_lm, stream);
}

template <typename T>
int launch_lm_sums(const T* hll_e, const T* bl_e, const T* w_e,
                   const int* lm_edge, int n_lm, int k_width, long long ld,
                   int DP, int DL, T* hll, T* bl, T* w_lm,
                   cudaStream_t stream) {
  if (n_lm <= 0) return 0;
  if (DP == 6 && DL == 3)
    lm_sums_dims<T, 6, 3>(hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld, hll,
                          bl, w_lm, stream);
  else if (DP == 3 && DL == 2)
    lm_sums_dims<T, 3, 2>(hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld, hll,
                          bl, w_lm, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

template <typename T>
int launch_cam_sums(const T* hcc_e, const T* bp_e, const T* w_e,
                    const int* cam_ptr, const int* cam_edge, int n_cam,
                    long long ld, int DP, int DL, T* hcc, T* bp, T* w_cam,
                    cudaStream_t stream) {
  if (n_cam <= 0) return 0;
  if (DP == 6 && DL == 3)
    ba_cam_sums_kernel<T, 6, 3><<<n_cam, kCamThreads, 0, stream>>>(
        hcc_e, bp_e, w_e, cam_ptr, cam_edge, n_cam, ld, hcc, bp, w_cam);
  else if (DP == 3 && DL == 2)
    ba_cam_sums_kernel<T, 3, 2><<<n_cam, kCamThreads, 0, stream>>>(
        hcc_e, bp_e, w_e, cam_ptr, cam_edge, n_cam, ld, hcc, bp, w_cam);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_BA_EDGE_ENTRY(SUFFIX, T)                                           \
  int g2o_ba_xyz2uv_##SUFFIX(                                                  \
      const T* pts, const T* cams, const int* li, const int* ci,               \
      const T* meas, const T* info, const T* delta, const T* camp,             \
      const T* free_l, const T* free_c, int kernel_id, int n_edges,            \
      long long off, long long ld, T* hll, T* bl, T* wblk, T* hcc, T* bp,      \
      void* stream) {                                                          \
    return g2o_torch::launch_xyz2uv<T>(                                        \
        pts, cams, li, ci, meas, info, delta, camp, free_l, free_c,            \
        kernel_id, n_edges, off, ld, hll, bl, wblk, hcc, bp,                   \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_ba_generic_##SUFFIX(                                                 \
      const T* resid, const T* jl, const T* jc, const T* rho1, const T* info,  \
      int n_edges, long long off, long long ld, int R, int DP, int DL, T* hll, \
      T* bl, T* wblk, T* hcc, T* bp, void* stream) {                           \
    return g2o_torch::launch_generic<T>(                                       \
        resid, jl, jc, rho1, info, n_edges, off, ld, R, DP, DL, hll, bl,       \
        wblk, hcc, bp, static_cast<cudaStream_t>(stream));                     \
  }                                                                            \
  int g2o_ba_lm_sums_##SUFFIX(const T* hll_e, const T* bl_e, const T* w_e,     \
                              const int* lm_edge, int n_lm, int k_width,       \
                              long long ld, int DP, int DL, T* hll, T* bl,     \
                              T* w_lm, void* stream) {                         \
    return g2o_torch::launch_lm_sums<T>(hll_e, bl_e, w_e, lm_edge, n_lm,       \
                                        k_width, ld, DP, DL, hll, bl, w_lm,    \
                                        static_cast<cudaStream_t>(stream));    \
  }                                                                            \
  int g2o_ba_cam_sums_##SUFFIX(const T* hcc_e, const T* bp_e, const T* w_e,    \
                               const int* cam_ptr, const int* cam_edge,        \
                               int n_cam, long long ld, int DP, int DL,        \
                               T* hcc, T* bp, T* w_cam, void* stream) {        \
    return g2o_torch::launch_cam_sums<T>(hcc_e, bp_e, w_e, cam_ptr, cam_edge,  \
                                         n_cam, ld, DP, DL, hcc, bp, w_cam,    \
                                         static_cast<cudaStream_t>(stream));   \
  }

G2O_BA_EDGE_ENTRY(f32, float)
G2O_BA_EDGE_ENTRY(f64, double)

#undef G2O_BA_EDGE_ENTRY

}  // extern "C"
