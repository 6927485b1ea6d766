// K7: the candidate, its chi2 and the LM bookkeeping of one LM-PCG trial.
//
// Replaces, on the SE2 pose-graph path, `apply_update_parts`
// (openslam_g2o_tpu/core/problem.py:557-565) with `se2_retract`
// (ops/lie.py:96), `robust_chi2` (core/problem.py:302-329) and the trial
// body of `_lm_pcg_step` (core/algorithms.py:306-332), which XLA fused into
// the trial program; run op by op they are about sixty elementwise launches
// and two reductions per trial. Here a trial's outcome is
//
//   retract_se2     cand = retract(x, dx * free), the angle wrapped by the
//                   floor formula; per-block partial sums of
//                   dx . (lambda dx + b) over all 3N values
//   se2_edge_chi2   per edge group: e at cand (the arithmetic of the
//                   linearizer, se2_edge.cuh), rho(e^T Omega e) for the
//                   group's robust kernel; per-block partial sums
//   lm_outcome      one block: both sums in a fixed order, then
//                   solved = ok && finite(chi2); chi2_new = solved ? chi2 : inf;
//                   rho = solved ? (chi2_cur - chi2_new) / (dot + 1e-3) : -1;
//                   accept = rho > 0 && finite(chi2_new);
//                   lambda *= accept ? clamp(1 - (2 rho - 1)^3, 1/3, 2/3) : nu;
//                   nu = accept ? 2 : 2 nu; retry = !accept && rho < 0
//
// lambda, nu, chi2_cur and ok are read from device memory and the results
// are written there: the host reads the retry flag and nothing else. A NaN
// dx or a NaN residual reaches lm_outcome as a non-finite chi2 (the block
// sums keep it), which pins rho to -1 so the trial loop retries. No atomics:
// a run repeats bit for bit.
//
// Bound: memory. retract_se2 moves 3N(x) + 3N(dx) + 3N(b) + N(free) values
// in and 3N out; se2_edge_chi2 13 values, 2 indices and two gathered poses
// per edge. At N = 100,000 that is a few MB, all of it in L2 after the
// solve, so launch latency is what remains: three launches per trial for
// one edge group.
#include "se2_edge.cuh"

namespace g2o_torch {

template <typename T>
__global__ void retract_se2_kernel(const T* __restrict__ x,
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
    T c[3];
    for (int a = 0; a < 3; ++a) {
      const T d = dxT[a * N + v];
      local += d * (l * d + bT[a * N + v]);
      c[a] = x[3 * v + a] + d * f;
    }
    cand[3 * v] = c[0];
    cand[3 * v + 1] = c[1];
    cand[3 * v + 2] = wrap_angle(c[2]);
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) part_dot[blockIdx.x] = total;
}

template <typename T>
__global__ void se2_edge_chi2_kernel(const T* __restrict__ cand,
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
    const long long vi = ii[e], vj = jj[e];
    T err[3], cz, sz, ci, si;
    se2_edge_error(cand[3 * vi], cand[3 * vi + 1], cand[3 * vi + 2],
                   cand[3 * vj], cand[3 * vj + 1], cand[3 * vj + 2],
                   meas[3 * e], meas[3 * e + 1], meas[3 * e + 2], err, cz, sz,
                   ci, si);
    local = robust_rho0<T>(kernel_id, se2_mahalanobis(err, info + 9 * e),
                           delta[e]);
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Slots of `out`; `flags` holds accept, retry (mirrored in
// kernels/retract_chi2.py).
enum OutcomeSlot { CHI_NEW = 0, RHO = 1, LAM_NEW = 2, NI_NEW = 3 };

template <typename T>
__global__ void lm_outcome_kernel(const T* __restrict__ part_chi, int n_chi,
                                  const T* __restrict__ part_dot, int n_dot,
                                  const unsigned char* __restrict__ ok,
                                  const T* __restrict__ lam,
                                  const T* __restrict__ ni,
                                  const T* __restrict__ chi_cur,
                                  T* __restrict__ out,
                                  unsigned char* __restrict__ flags) {
  __shared__ T smem[32];
  const T chi = sum_partials(part_chi, n_chi, smem);
  const T dot = sum_partials(part_dot, n_dot, smem);
  if (threadIdx.x != 0) return;
  const bool solved = (*ok != 0) && isfinite(chi);
  const T chi_new = solved ? chi : static_cast<T>(INFINITY);
  const T scale = dot + T(1e-3);
  const T rho = solved ? (*chi_cur - chi_new) / scale : T(-1);
  const bool accept = rho > T(0) && isfinite(chi_new);
  const T t = T(2) * rho - T(1);
  const T alpha = T(1) - t * t * t;
  const T hi = static_cast<T>(2.0 / 3.0), lo = static_cast<T>(1.0 / 3.0);
  T good = alpha > hi ? hi : alpha;            // both clamps keep a NaN
  good = good < lo ? lo : good;
  out[CHI_NEW] = chi_new;
  out[RHO] = rho;
  out[LAM_NEW] = accept ? *lam * good : *lam * *ni;
  out[NI_NEW] = accept ? T(2) : *ni * T(2);
  flags[0] = accept ? 1 : 0;
  flags[1] = (!accept && rho < T(0)) ? 1 : 0;
}

template <typename T>
int launch_retract_se2(const T* x, const T* dxT, const T* free_mask,
                       const T* bT, const T* lam, T* cand, T* part_dot, int n,
                       cudaStream_t stream) {
  retract_se2_kernel<T><<<grid_for(n > 0 ? n : 1), kThreads, 0, stream>>>(
      x, dxT, free_mask, bT, lam, cand, part_dot, n);
  return launch_status();
}

template <typename T>
int launch_se2_edge_chi2(const T* cand, const int* ii, const int* jj,
                         const T* meas, const T* info, const T* delta,
                         int kernel_id, T* partials, int n_edges,
                         cudaStream_t stream) {
  se2_edge_chi2_kernel<T>
      <<<grid_for(n_edges > 0 ? n_edges : 1), kThreads, 0, stream>>>(
          cand, ii, jj, meas, info, delta, kernel_id, partials, n_edges);
  return launch_status();
}

template <typename T>
int launch_lm_outcome(const T* part_chi, int n_chi, const T* part_dot,
                      int n_dot, const unsigned char* ok, const T* lam,
                      const T* ni, const T* chi_cur, T* out,
                      unsigned char* flags, cudaStream_t stream) {
  lm_outcome_kernel<T><<<1, kThreads, 0, stream>>>(
      part_chi, n_chi, part_dot, n_dot, ok, lam, ni, chi_cur, out, flags);
  return launch_status();
}

}  // namespace g2o_torch

extern "C" {

#define G2O_RETRACT_CHI2_ENTRY(SUFFIX, T)                                      \
  int g2o_retract_se2_##SUFFIX(const T* x, const T* dxT, const T* free_mask,   \
                               const T* bT, const T* lam, T* cand,             \
                               T* part_dot, int n, void* stream) {             \
    return g2o_torch::launch_retract_se2<T>(                                   \
        x, dxT, free_mask, bT, lam, cand, part_dot, n,                         \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_se2_edge_chi2_##SUFFIX(const T* cand, const int* ii, const int* jj,  \
                                 const T* meas, const T* info,                 \
                                 const T* delta, int kernel_id, T* partials,   \
                                 int n_edges, void* stream) {                  \
    return g2o_torch::launch_se2_edge_chi2<T>(                                 \
        cand, ii, jj, meas, info, delta, kernel_id, partials, n_edges,         \
        static_cast<cudaStream_t>(stream));                                    \
  }                                                                            \
  int g2o_lm_outcome_##SUFFIX(const T* part_chi, int n_chi,                    \
                              const T* part_dot, int n_dot,                    \
                              const unsigned char* ok, const T* lam,           \
                              const T* ni, const T* chi_cur, T* out,           \
                              unsigned char* flags, void* stream) {            \
    return g2o_torch::launch_lm_outcome<T>(                                    \
        part_chi, n_chi, part_dot, n_dot, ok, lam, ni, chi_cur, out, flags,    \
        static_cast<cudaStream_t>(stream));                                    \
  }

G2O_RETRACT_CHI2_ENTRY(f32, float)
G2O_RETRACT_CHI2_ENTRY(f64, double)

#undef G2O_RETRACT_CHI2_ENTRY

}  // extern "C"
