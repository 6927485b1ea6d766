// K7 for SE3 pose graphs: the candidate of one LM-PCG trial and its chi2.
//
// Replaces, on the SE3 pose-graph path, `apply_update_parts`
// (openslam_g2o_tpu/core/problem.py:557-565) with `se3_retract_mqt`
// (ops/lie.py:256) and `robust_chi2` (core/problem.py:302-329) of the trial
// body of `_lm_pcg_step` (core/algorithms.py:306-332):
//
//   retract_se3     cand = x * fromVectorMQT(dx * free), the quaternion
//                   renormalized (also where dx * free is 0: the reference
//                   retracts every vertex); per-block partial sums of
//                   dx . (lambda dx + b) over all 6N values
//   se3_edge_chi2   per edge group: e at cand (the arithmetic of the
//                   linearizer, se3_edge.cuh), rho(e^T Omega e) for the
//                   group's robust kernel; per-block partial sums
//
// The partials go to lm_outcome (retract_chi2.cu), which serves every block
// width. A NaN dx or a NaN residual reaches it as a non-finite sum (the
// block sums keep it). No atomics: a run repeats bit for bit.
//
// Bound: memory. retract_se3 moves 7N (x) + 6N (dx) + 6N (b) + N (free)
// values in and 7N out; se3_edge_chi2 7 + 36 + 1 values, 2 indices and two
// gathered poses per edge.
#include "se3_edge.cuh"

namespace g2o_torch {

template <typename T>
__global__ void retract_se3_kernel(const T* __restrict__ x,
                                   const T* __restrict__ dxT,
                                   const T* __restrict__ free_mask,
                                   const T* __restrict__ bT,
                                   const T* __restrict__ lam,
                                   T* __restrict__ cand,
                                   T* __restrict__ part_dot, int n) {
  __shared__ T smem[32];
  const long long v = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const long long N = n;
  T local = T(0);
  if (v < n) {
    const T l = *lam, f = free_mask[v];
    T pose[7], step[6], moved[7];
    for (int k = 0; k < 7; ++k) pose[k] = x[7 * v + k];
    for (int a = 0; a < 6; ++a) {
      const T d = dxT[a * N + v];
      local += d * (l * d + bT[a * N + v]);
      step[a] = d * f;
    }
    se3_retract_mqt(pose, step, moved);
    for (int k = 0; k < 7; ++k) cand[7 * v + k] = moved[k];
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) part_dot[blockIdx.x] = total;
}

template <typename T>
__global__ void se3_edge_chi2_kernel(const T* __restrict__ cand,
                                     const int* __restrict__ ii,
                                     const int* __restrict__ jj,
                                     const T* __restrict__ meas,
                                     const T* __restrict__ info,
                                     const T* __restrict__ delta,
                                     int kernel_id, T* __restrict__ partials,
                                     int n_edges) {
  __shared__ T smem[32];
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  T local = T(0);
  if (e < n_edges) {
    T err[6];
    se3_edge_residual(cand, ii[e], jj[e], meas + 7 * e, err);
    local = robust_rho0<T>(kernel_id, se3_mahalanobis(err, info + 36 * e),
                           delta[e]);
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
int launch_retract_se3(const T* x, const T* dxT, const T* free_mask,
                       const T* bT, const T* lam, T* cand, T* part_dot, int n,
                       cudaStream_t stream) {
  retract_se3_kernel<T><<<grid_for(n > 0 ? n : 1), kThreads, 0, stream>>>(
      x, dxT, free_mask, bT, lam, cand, part_dot, n);
  return launch_status();
}

template <typename T>
int launch_se3_edge_chi2(const T* cand, const int* ii, const int* jj,
                         const T* meas, const T* info, const T* delta,
                         int kernel_id, T* partials, int n_edges,
                         cudaStream_t stream) {
  se3_edge_chi2_kernel<T>
      <<<grid_for(n_edges > 0 ? n_edges : 1), kThreads, 0, stream>>>(
          cand, ii, jj, meas, info, delta, kernel_id, partials, n_edges);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_RETRACT_SE3_ENTRY(SUFFIX, T)                                       \
  int g2o_retract_se3_##SUFFIX(const T* x, const T* dxT, const T* free_mask,   \
                               const T* bT, const T* lam, T* cand,             \
                               T* part_dot, int n, void* stream) {             \
    return g2o_torch::launch_retract_se3<T>(                                   \
        x, dxT, free_mask, bT, lam, cand, part_dot, n,                         \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_se3_edge_chi2_##SUFFIX(const T* cand, const int* ii, const int* jj,  \
                                 const T* meas, const T* info,                 \
                                 const T* delta, int kernel_id, T* partials,   \
                                 int n_edges, void* stream) {                  \
    return g2o_torch::launch_se3_edge_chi2<T>(                                 \
        cand, ii, jj, meas, info, delta, kernel_id, partials, n_edges,         \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_RETRACT_SE3_ENTRY(f32, float)
G2O_RETRACT_SE3_ENTRY(f64, double)

#undef G2O_RETRACT_SE3_ENTRY

}  // extern "C"
