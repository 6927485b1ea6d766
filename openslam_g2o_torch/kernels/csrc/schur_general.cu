// K14: the general Schur path (core/ba.py): the per-edge landmark blocks of
// an edge of any arity. K13's products (ba_coupling.cu) read the W it
// writes.
//
// Replaces the per-edge products and sorted segment sums of `schur_build`
// (openslam_g2o_tpu/core/ba.py:81-168, `_accumulate_lm`:171 and
// `_accumulate_pose`:177):
//
//   schur_edge      one thread per edge of an edge group with one landmark
//                   slot, for one of its pose slots t: Jl_w = Jl^T (w Omega),
//                   then (first pose slot only) Hll_e = Jl_w Jl and
//                   b_l,e = -Jl_w r into the lane-major landmark streams
//                   (summed per landmark by K10's ba_lm_sums), and
//                   W_e = Jt^T (w Omega) Jl [Dp, dl] written straight into
//                   both layouts the products read: landmark-major
//                   [Dp*dl, K, L] at slot lm_pos[e] and pose-major
//                   [Dp*dl, M] at its CSR position pose_pos[e]. Every
//                   destination has one writer, so nothing is atomic.
//
// The TPU code sorted every (edge group, landmark slot, pose slot) by
// landmark and by pose once on the host and summed with sorted segment
// sums, because random scatters serialize on the TPU (ba.py:157-160). Here
// the host builds the same orderings as destination-major tables (the slot
// table per landmark, the CSR list and its chunks per pose vertex), and the
// sums run in a fixed order: a run repeats bit for bit.
//
// Bound: memory. schur_edge reads (R + R dl + R Dp + 1 + R^2) values per
// edge and writes dl^2 + dl + 2 Dp dl.
#include "ba_blocks.cuh"

namespace g2o_torch {

template <typename T, int R, int DP, int DL>
__global__ void schur_edge_kernel(
    const T* __restrict__ resid, const T* __restrict__ jl_in,
    const T* __restrict__ jp_in, const T* __restrict__ rho1,
    const T* __restrict__ info, int n_edges, long long off, long long ld,
    T* __restrict__ hll, T* __restrict__ bl, const int* __restrict__ lm_pos,
    long long ld_lm, T* __restrict__ w_lm, const int* __restrict__ pose_pos,
    long long ld_pose, T* __restrict__ w_pose) {
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= n_edges) return;
  const T w = rho1[e];
  T r[R], jl[R][DL], om[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a) {
    r[a] = resid[e * R + a];
#pragma unroll
    for (int s = 0; s < DL; ++s) jl[a][s] = jl_in[(e * R + a) * DL + s];
#pragma unroll
    for (int b = 0; b < R; ++b) om[a][b] = w * info[(e * R + a) * R + b];
  }
  if (hll != nullptr) {
    // Jl_w = Jl^T (w Omega), then Hll_e = Jl_w Jl and b_l,e = -Jl_w r
    const long long col = off + e;
#pragma unroll
    for (int s = 0; s < DL; ++s) {
      T jlw[R];
#pragma unroll
      for (int b = 0; b < R; ++b) {
        T acc = T(0);
#pragma unroll
        for (int a = 0; a < R; ++a) acc += jl[a][s] * om[a][b];
        jlw[b] = acc;
      }
      T g = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) g += jlw[b] * r[b];
      bl[s * ld + col] = -g;
#pragma unroll
      for (int t = 0; t < DL; ++t) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < R; ++b) acc += jlw[b] * jl[b][t];
        hll[(s * DL + t) * ld + col] = acc;
      }
    }
  }
  if (jp_in == nullptr) return;
  const long long pl = lm_pos[e], pp = pose_pos[e];
  // one row of Jt^T (w Omega) at a time: its row of W
#pragma unroll
  for (int s = 0; s < DP; ++s) {
    T jpw[R];
#pragma unroll
    for (int b = 0; b < R; ++b) {
      T acc = T(0);
#pragma unroll
      for (int a = 0; a < R; ++a) acc += jp_in[(e * R + a) * DP + s] * om[a][b];
      jpw[b] = acc;
    }
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      T acc = T(0);
#pragma unroll
      for (int b = 0; b < R; ++b) acc += jpw[b] * jl[b][t];
      w_lm[(s * DL + t) * ld_lm + pl] = acc;
      w_pose[(s * DL + t) * ld_pose + pp] = acc;
    }
  }
}

// -- launchers ---------------------------------------------------------------

template <typename T, int DP, int DL>
int edge_dims(int R, const T* resid, const T* jl, const T* jp, const T* rho1,
              const T* info, int n_edges, long long off, long long ld, T* hll,
              T* bl, const int* lm_pos, long long ld_lm, T* w_lm,
              const int* pose_pos, long long ld_pose, T* w_pose,
              cudaStream_t stream) {
  const int grid = grid_for(n_edges);
  switch (R) {
    case 1:
      schur_edge_kernel<T, 1, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jp, rho1, info, n_edges, off, ld, hll, bl, lm_pos, ld_lm,
          w_lm, pose_pos, ld_pose, w_pose);
      break;
    case 2:
      schur_edge_kernel<T, 2, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jp, rho1, info, n_edges, off, ld, hll, bl, lm_pos, ld_lm,
          w_lm, pose_pos, ld_pose, w_pose);
      break;
    case 3:
      schur_edge_kernel<T, 3, DP, DL><<<grid, kThreads, 0, stream>>>(
          resid, jl, jp, rho1, info, n_edges, off, ld, hll, bl, lm_pos, ld_lm,
          w_lm, pose_pos, ld_pose, w_pose);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_status();
}

template <typename T>
int launch_schur_edge(const T* resid, const T* jl, const T* jp,
                      const T* rho1, const T* info, int n_edges,
                      long long off, long long ld, int R, int DP, int DL,
                      T* hll, T* bl, const int* lm_pos, long long ld_lm,
                      T* w_lm, const int* pose_pos, long long ld_pose,
                      T* w_pose, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  if (DP == 6 && DL == 3)
    return edge_dims<T, 6, 3>(R, resid, jl, jp, rho1, info, n_edges, off, ld,
                              hll, bl, lm_pos, ld_lm, w_lm, pose_pos, ld_pose,
                              w_pose, stream);
  if (DP == 4 && DL == 3)
    return edge_dims<T, 4, 3>(R, resid, jl, jp, rho1, info, n_edges, off, ld,
                              hll, bl, lm_pos, ld_lm, w_lm, pose_pos, ld_pose,
                              w_pose, stream);
  if (DP == 3 && DL == 2)
    return edge_dims<T, 3, 2>(R, resid, jl, jp, rho1, info, n_edges, off, ld,
                              hll, bl, lm_pos, ld_lm, w_lm, pose_pos, ld_pose,
                              w_pose, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace g2o_torch

extern "C" {

#define G2O_SCHUR_GENERAL_ENTRY(SUFFIX, T)                                     \
  int g2o_schur_edge_##SUFFIX(                                                 \
      const T* resid, const T* jl, const T* jp, const T* rho1, const T* info,  \
      int n_edges, long long off, long long ld, int R, int DP, int DL, T* hll, \
      T* bl, const int* lm_pos, long long ld_lm, T* w_lm,                      \
      const int* pose_pos, long long ld_pose, T* w_pose, void* stream) {       \
    return g2o_torch::launch_schur_edge<T>(                                    \
        resid, jl, jp, rho1, info, n_edges, off, ld, R, DP, DL, hll, bl,       \
        lm_pos, ld_lm, w_lm, pose_pos, ld_pose, w_pose,                        \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_SCHUR_GENERAL_ENTRY(f32, float)
G2O_SCHUR_GENERAL_ENTRY(f64, double)

#undef G2O_SCHUR_GENERAL_ENTRY

}  // extern "C"
