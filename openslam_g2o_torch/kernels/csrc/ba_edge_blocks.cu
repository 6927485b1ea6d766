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
//                the products of ba_blocks.cuh: Hll_e, b_l,e and W_e
//                lane-major at the edge's column, the camera record (Hcc_e,
//                b_p,e, W_e) staged per warp in shared memory and stored
//                whole at the edge's place in its camera's CSR list
//                (cam_pos).
//   ba_generic   the same products from the residual and masked Jacobians
//                `linearize` computed, for any other binary (landmark, pose)
//                edge type: R in {1, 2, 3}, (Dp, dl) in {(6, 3), (3, 2),
//                (9, 3)} ((9, 3): the BAL camera of models/bal.py, whose
//                120-value records halve the warps a block).
//   ba_lm_sums   a block per tile of 16 landmarks (4 where K > 8): the
//                tile's slots are staged in shared memory, then one thread
//                per (landmark, row) sums Hll and b_l over the slots in
//                slot order, and W is copied out into the landmark-major
//                [Dp*dl, K, L] layout (zeros on padding), coalesced along
//                k L + l (W read lane-major at the slot's observation);
//                without W (null w_e and w_lm) for the general Schur path,
//                whose edge kernel writes W itself (schur_general.cu).
//   ba_cam_sums  one block per chunk of at most 256 consecutive records of
//                one camera (K13's PoseRows): the chunk's records are read
//                as contiguous runs into shared memory, Hcc and b_p summed
//                in the order of the one-block-per-camera kernel it
//                replaces (so a camera of one chunk keeps its bits), W_cam
//                written coalesced along the CSR position; a camera of one
//                chunk is finished by its block, else the last of its
//                chunks' blocks to arrive (an arrival counter after
//                __threadfence) sums the chunks' partials in chunk order.
//                No atomics on values: the same bits every run.
//
// The TPU code reduced the camera side with a [E, C] one-hot matmul on the
// MXU (ba_ell.py:582-601) or with K-chunked lane gathers. Here the
// observations are numbered point-major (as BAL numbers them), so the
// camera side of one camera lies ~E / degree apart in observation order:
// read per observation, each 4-byte value costs a 32-byte sector. The edge
// kernels therefore write the camera half where the sums read it in order,
// as whole records (a warp stores one record with all its lanes: full
// sectors in a scattered order, never a 240-byte stride), and the skewed
// degree (55-1768 observations per camera at 400k observations) is cut
// into chunks, so the hub camera does not set the tail.
//
// Bound: memory. The edge pass reads ~20 values and writes dl^2 + dl
// lane-major and one record (64 values at (6, 3)) per edge; the landmark
// sums read the landmark half and W, the camera sums the records, and they
// write W once each.
#include "ba_blocks.cuh"
#include "xyz2uv.cuh"

namespace g2o_torch {

// Warps per block of the edge kernels: each stages 32 records of RS + 1
// values in static shared memory, at most 48 KB a block: 4 warps in float32
// and 2 in float64 up to RS = 64 (33 KB at (6, 3)), half that at (9, 3)
// (RS = 120: 31 KB), where the full count would stage 62 KB.
template <typename T, int RS>
constexpr int kEdgeWarps = (sizeof(T) == 4 ? 4 : 2) / (RS > 64 ? 2 : 1);

// The fused XYZ2UV products of edge e into the lane-major streams and the
// record `mine`.
template <typename T>
__device__ __forceinline__ void xyz2uv_edge(
    const T* __restrict__ pts, const T* __restrict__ cams,
    const int* __restrict__ li, const int* __restrict__ ci,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, const T* __restrict__ camp,
    const T* __restrict__ free_l, const T* __restrict__ free_c,
    int kernel_id, int e, long long off, long long ld, T* hll, T* bl,
    T* mine, T* w_lane) {
  const long long l = li[e], c = ci[e];
  T r[2], jl[2][3], jc[2][6];
  xyz2uv_linearize<T, 2>(pts[3 * l], pts[3 * l + 1], pts[3 * l + 2],
                         cams + 7 * c, camp + 4 * e, meas + 2 * e, free_l[l],
                         free_c[c], r, jl, jc);
  const T* om = info + 4 * e;
  T e2 = T(0);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) e2 += r[a] * om[2 * a + b] * r[b];
  const T w = robust_rho1<T>(kernel_id, e2, delta[e]);
  ba_edge_products<T, 2, 6, 3>(r, jl, jc, w, om, off + e, ld, hll, bl, mine,
                               w_lane);
}

template <typename T, int RS = CamRecord<6, 3>::kSize>
__global__ void __launch_bounds__(32 * kEdgeWarps<T, RS>) ba_xyz2uv_kernel(
    const T* __restrict__ pts, const T* __restrict__ cams,
    const int* __restrict__ li, const int* __restrict__ ci,
    const T* __restrict__ meas, const T* __restrict__ info,
    const T* __restrict__ delta, const T* __restrict__ camp,
    const T* __restrict__ free_l, const T* __restrict__ free_c,
    const int* __restrict__ cam_pos, int kernel_id, int n_edges,
    long long off, long long ld, T* hll, T* bl, T* rec, T* w_lane) {
  __shared__ T stage[kEdgeWarps<T, RS>][32 * (RS + 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e0 = blockIdx.x * static_cast<long long>(blockDim.x)
                       + 32 * warp;
  if (e0 + lane < n_edges)
    xyz2uv_edge<T>(pts, cams, li, ci, meas, info, delta, camp, free_l,
                   free_c, kernel_id, static_cast<int>(e0 + lane), off, ld,
                   hll, bl, stage[warp] + lane * (RS + 1), w_lane);
  __syncwarp();
  const long long live = n_edges - e0;
  warp_store_records<T, RS>(stage[warp], e0,
                            live >= 32 ? 32 : static_cast<int>(live), off,
                            cam_pos, rec);
}

template <typename T, int R, int DP, int DL,
          int RS = CamRecord<DP, DL>::kSize>
__global__ void __launch_bounds__(32 * kEdgeWarps<T, RS>) ba_generic_kernel(
    const T* __restrict__ resid, const T* __restrict__ jl_in,
    const T* __restrict__ jc_in, const T* __restrict__ rho1,
    const T* __restrict__ info, const int* __restrict__ cam_pos,
    int n_edges, long long off, long long ld, T* hll, T* bl, T* rec,
    T* w_lane) {
  __shared__ T stage[kEdgeWarps<T, RS>][32 * (RS + 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long e0 = blockIdx.x * static_cast<long long>(blockDim.x)
                       + 32 * warp;
  const long long e = e0 + lane;
  if (e < n_edges) {
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
                                   off + e, ld, hll, bl,
                                   stage[warp] + lane * (RS + 1), w_lane);
  }
  __syncwarp();
  const long long live = n_edges - e0;
  warp_store_records<T, RS>(stage[warp], e0,
                            live >= 32 ? 32 : static_cast<int>(live), off,
                            cam_pos, rec);
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

// ba_cam_sums: a block of 256 threads per chunk c (positions
// chunk_ptr[c]:chunk_ptr[c+1], at most 256, of camera chunk_row[c]). Its
// sums have the arithmetic of one 128-thread block per camera with a
// strided loop and a shuffle-tree reduction (the kernel this one
// replaces), so a camera of one chunk keeps those bits: thread t of that
// block adds records t and t + 128 to 0, each warp sums its threads by the
// tree of __shfl_down_sync, and the four warp totals are added in warp
// order. Here the two halves of the block split the NV = Dp^2 + Dp values
// (fewer accumulators a thread, more blocks an SM): thread t of half h
// keeps values h H .. h H + H - 1 of t's sum. The chunk's records are
// copied in spans of kCamSpan, as contiguous runs of 16-byte loads, into
// shared memory (pitch RS + 1: a thread reading its own record hits no
// bank twice), and W leaves the stage along the CSR position (a thread per
// (row, record), records fastest). A camera of one chunk (an empty one
// where it has no observation: zeros) is finished by that block; of a
// camera with several chunks, each block writes its partial to part[v, c],
// fences it and counts its arrival on the camera's counter, and the last
// to arrive adds the camera's partials in chunk order (read with __ldcg,
// past this SM's L1) and sets the counter back to 0.
constexpr int kCamThreads = 256;
constexpr int kCamSumThreads = 128;  // one half: t = 0 .. 127
// records staged at a time: 64 where their stage fits in 40 KB (every
// instantiation but (9, 3) in float64, RS = 120), else 32; either divides
// kCamSumThreads, so a span never splits a summing round's records
// between two stagings of one thread
template <typename T, int RS>
constexpr int kCamSpan = 64 * (RS + 1) * sizeof(T) <= 40 * 1024 ? 64 : 32;

template <typename T, int DP, int DL>
__global__ void __launch_bounds__(kCamThreads) ba_cam_sums_kernel(
    const T* __restrict__ rec, const int* __restrict__ chunk_ptr,
    const int* __restrict__ chunk_row, const int* __restrict__ row_chunk,
    int* __restrict__ arrivals, int n_chunks, int n_cam, long long n_obs,
    T* __restrict__ part, T* __restrict__ hcc, T* __restrict__ bp,
    T* __restrict__ w_cam) {
  using Rec = CamRecord<DP, DL>;
  constexpr int RS = Rec::kSize, NV = Rec::kSum, DW = DP * DL;
  constexpr int PITCH = RS + 1, H = (NV + 1) / 2;
  constexpr int VEC = 16 / sizeof(T);              // values per 16 bytes
  constexpr int SPAN = kCamSpan<T, RS>;
  static_assert(RS % VEC == 0, "a 16-byte load stays in one record");
  static_assert(kCamSumThreads % SPAN == 0, "a span within one round");
  static_assert(NV <= kCamThreads && H <= kCamSumThreads,
                "a thread per summed value");
  __shared__ T stage[SPAN * PITCH];
  __shared__ T warp_sum[kCamThreads / 32][H];
  __shared__ int last;
  const int c = blockIdx.x;
  const int j0 = chunk_ptr[c], j1 = chunk_ptr[c + 1];
  const int half = threadIdx.x / kCamSumThreads;
  const int t = threadIdx.x % kCamSumThreads, q0 = half * H;
  T acc[H];
#pragma unroll
  for (int q = 0; q < H; ++q) acc[q] = T(0);
  for (int s0 = j0; s0 < j1; s0 += SPAN) {
    const int m = j1 - s0 < SPAN ? j1 - s0 : SPAN;
    const uint4* src = reinterpret_cast<const uint4*>(
        rec + static_cast<long long>(s0) * RS);
    for (int i = threadIdx.x; i < m * RS / VEC; i += kCamThreads) {
      union { uint4 u; T v[VEC]; } load;
      load.u = src[i];
      T* dst = stage + (i * VEC / RS) * PITCH + i * VEC % RS;
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = load.v[j];
    }
    __syncthreads();
    // t adds chunk record t + 128 r in round r; in this span that is
    // record k of the stage
    const int k = t - (s0 - j0) % kCamSumThreads;
    if (k >= 0 && k < m) {
      const T* mine = stage + k * PITCH + q0;
#pragma unroll
      for (int q = 0; q < H; ++q)
        if (q0 + q < NV) acc[q] += mine[q];
    }
    for (int i = threadIdx.x; i < DW * SPAN; i += kCamThreads) {
      const int q = i / SPAN, kk = i % SPAN;
      if (kk < m)
        w_cam[q * n_obs + s0 + kk] = stage[kk * PITCH + Rec::kW + q];
    }
    __syncthreads();                              // the stage is reused
  }
  warp_reduce_values<T, H>(acc);                  // lane 0: the warp's sums
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int q = 0; q < H; ++q) warp_sum[threadIdx.x >> 5][q] = acc[q];
  }
  __syncthreads();
  // in thread v < NV: its half's four warps, in order
  T total = T(0);
  if (threadIdx.x < NV) {
    const int w0 = (threadIdx.x / H) * (kCamSumThreads / 32);
    const int q = threadIdx.x % H;
    total = warp_sum[w0][q];
#pragma unroll
    for (int w = 1; w < kCamSumThreads / 32; ++w) total += warp_sum[w0 + w][q];
  }
  const int n = chunk_row[c];
  const int c0 = row_chunk[n], c1 = row_chunk[n + 1];
  if (c1 - c0 > 1) {
    const long long NC = n_chunks;
    if (threadIdx.x < NV) part[threadIdx.x * NC + c] = total;
    __threadfence();                 // the partial, before the arrival
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(arrivals + n, 1) == c1 - c0 - 1;
    __syncthreads();
    if (!last) return;
    if (threadIdx.x < NV) {
      total = __ldcg(part + threadIdx.x * NC + c0);
      for (int cc = c0 + 1; cc < c1; ++cc)
        total += __ldcg(part + threadIdx.x * NC + cc);
    }
    if (threadIdx.x == 0) arrivals[n] = 0;
  }
  const long long C = n_cam;
  if (threadIdx.x < DP * DP)
    hcc[threadIdx.x * C + n] = total;
  else if (threadIdx.x < NV)
    bp[(threadIdx.x - DP * DP) * C + n] = total;
}

// -- launchers ---------------------------------------------------------------

template <typename T, int RS>
int edge_grid(long long n_edges) {
  const int threads = 32 * kEdgeWarps<T, RS>;
  return static_cast<int>((n_edges + threads - 1) / threads);
}

template <typename T>
int launch_xyz2uv(const T* pts, const T* cams, const int* li, const int* ci,
                  const T* meas, const T* info, const T* delta, const T* camp,
                  const T* free_l, const T* free_c, const int* cam_pos,
                  int kernel_id, int n_edges, long long off, long long ld,
                  T* hll, T* bl, T* rec, T* w_lane, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  constexpr int RS = CamRecord<6, 3>::kSize;
  ba_xyz2uv_kernel<T><<<edge_grid<T, RS>(n_edges), 32 * kEdgeWarps<T, RS>,
                        0, stream>>>(
      pts, cams, li, ci, meas, info, delta, camp, free_l, free_c, cam_pos,
      kernel_id, n_edges, off, ld, hll, bl, rec, w_lane);
  return launch_status();
}

template <typename T, int DP, int DL>
int launch_generic_dims(int R, const T* resid, const T* jl, const T* jc,
                        const T* rho1, const T* info, const int* cam_pos,
                        int n_edges, long long off, long long ld, T* hll,
                        T* bl, T* rec, T* w_lane, cudaStream_t stream) {
  constexpr int RS = CamRecord<DP, DL>::kSize;
  const int grid = edge_grid<T, RS>(n_edges);
  const int threads = 32 * kEdgeWarps<T, RS>;
  switch (R) {
    case 1:
      ba_generic_kernel<T, 1, DP, DL><<<grid, threads, 0, stream>>>(
          resid, jl, jc, rho1, info, cam_pos, n_edges, off, ld, hll, bl, rec,
          w_lane);
      break;
    case 2:
      ba_generic_kernel<T, 2, DP, DL><<<grid, threads, 0, stream>>>(
          resid, jl, jc, rho1, info, cam_pos, n_edges, off, ld, hll, bl, rec,
          w_lane);
      break;
    case 3:
      ba_generic_kernel<T, 3, DP, DL><<<grid, threads, 0, stream>>>(
          resid, jl, jc, rho1, info, cam_pos, n_edges, off, ld, hll, bl, rec,
          w_lane);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

template <typename T>
int launch_generic(const T* resid, const T* jl, const T* jc, const T* rho1,
                   const T* info, const int* cam_pos, int n_edges,
                   long long off, long long ld, int R, int DP, int DL, T* hll,
                   T* bl, T* rec, T* w_lane, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  if (DP == 6 && DL == 3)
    return launch_generic_dims<T, 6, 3>(R, resid, jl, jc, rho1, info,
                                        cam_pos, n_edges, off, ld, hll, bl,
                                        rec, w_lane, stream);
  if (DP == 3 && DL == 2)
    return launch_generic_dims<T, 3, 2>(R, resid, jl, jc, rho1, info,
                                        cam_pos, n_edges, off, ld, hll, bl,
                                        rec, w_lane, stream);
  if (DP == 9 && DL == 3)
    return launch_generic_dims<T, 9, 3>(R, resid, jl, jc, rho1, info,
                                        cam_pos, n_edges, off, ld, hll, bl,
                                        rec, w_lane, stream);
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
  else if (DP == 9 && DL == 3)
    lm_sums_dims<T, 9, 3>(hll_e, bl_e, w_e, lm_edge, n_lm, k_width, ld, hll,
                          bl, w_lm, stream);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_status();
}

template <typename T, int DP, int DL>
void cam_sums_dims(const T* rec, const int* chunk_ptr, const int* chunk_row,
                   const int* row_chunk, int* arrivals, int n_chunks,
                   int n_cam, long long n_obs, T* part, T* hcc, T* bp,
                   T* w_cam, cudaStream_t stream) {
  ba_cam_sums_kernel<T, DP, DL><<<n_chunks, kCamThreads, 0, stream>>>(
      rec, chunk_ptr, chunk_row, row_chunk, arrivals, n_chunks, n_cam, n_obs,
      part, hcc, bp, w_cam);
}

template <typename T>
int launch_cam_sums(const T* rec, const int* chunk_ptr, const int* chunk_row,
                    const int* row_chunk, int* arrivals, int n_chunks,
                    int n_cam, long long n_obs, int DP, int DL, T* part,
                    T* hcc, T* bp, T* w_cam, cudaStream_t stream) {
  if (n_chunks <= 0) return 0;
  if (DP == 6 && DL == 3)
    cam_sums_dims<T, 6, 3>(rec, chunk_ptr, chunk_row, row_chunk, arrivals,
                           n_chunks, n_cam, n_obs, part, hcc, bp, w_cam,
                           stream);
  else if (DP == 3 && DL == 2)
    cam_sums_dims<T, 3, 2>(rec, chunk_ptr, chunk_row, row_chunk, arrivals,
                           n_chunks, n_cam, n_obs, part, hcc, bp, w_cam,
                           stream);
  else if (DP == 9 && DL == 3)
    cam_sums_dims<T, 9, 3>(rec, chunk_ptr, chunk_row, row_chunk, arrivals,
                           n_chunks, n_cam, n_obs, part, hcc, bp, w_cam,
                           stream);
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
      const T* free_l, const T* free_c, const int* cam_pos, int kernel_id,     \
      int n_edges, long long off, long long ld, T* hll, T* bl, T* rec,         \
      T* w_lane, void* stream) {                                               \
    return g2o_torch::launch_xyz2uv<T>(                                        \
        pts, cams, li, ci, meas, info, delta, camp, free_l, free_c, cam_pos,   \
        kernel_id, n_edges, off, ld, hll, bl, rec, w_lane,                     \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_ba_generic_##SUFFIX(                                                 \
      const T* resid, const T* jl, const T* jc, const T* rho1, const T* info,  \
      const int* cam_pos, int n_edges, long long off, long long ld, int R,     \
      int DP, int DL, T* hll, T* bl, T* rec, T* w_lane, void* stream) {        \
    return g2o_torch::launch_generic<T>(                                       \
        resid, jl, jc, rho1, info, cam_pos, n_edges, off, ld, R, DP, DL, hll,  \
        bl, rec, w_lane, static_cast<cudaStream_t>(stream));                   \
  }                                                                            \
  int g2o_ba_lm_sums_##SUFFIX(const T* hll_e, const T* bl_e, const T* w_e,     \
                              const int* lm_edge, int n_lm, int k_width,       \
                              long long ld, int DP, int DL, T* hll, T* bl,     \
                              T* w_lm, void* stream) {                         \
    return g2o_torch::launch_lm_sums<T>(hll_e, bl_e, w_e, lm_edge, n_lm,       \
                                        k_width, ld, DP, DL, hll, bl, w_lm,    \
                                        static_cast<cudaStream_t>(stream));    \
  }                                                                            \
  int g2o_ba_cam_sums_##SUFFIX(                                                \
      const T* rec, const int* chunk_ptr, const int* chunk_row,                \
      const int* row_chunk, int* arrivals, int n_chunks, int n_cam,            \
      long long n_obs, int DP, int DL, T* part, T* hcc, T* bp, T* w_cam,       \
      void* stream) {                                                          \
    return g2o_torch::launch_cam_sums<T>(                                      \
        rec, chunk_ptr, chunk_row, row_chunk, arrivals, n_chunks, n_cam,       \
        n_obs, DP, DL, part, hcc, bp, w_cam,                                   \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_BA_EDGE_ENTRY(f32, float)
G2O_BA_EDGE_ENTRY(f64, double)

#undef G2O_BA_EDGE_ENTRY

}  // extern "C"
