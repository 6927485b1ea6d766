// K6: the conjugate-gradient step of the LM-PCG trial solve, three launches
// per iteration with every CG scalar on the device.
//
// Replaces the loop of `pcg_solve`
// (openslam_g2o_tpu/core/solvers.py:213-297), which XLA fused into one TPU
// program; run op by op it is a matvec, two dot products and about fifteen
// elementwise launches per iteration. Here one iteration is
//
//   spmv_dot      hp = H p (the block row product of kernel A) and per-block
//                 partial sums of p . hp
//   cg_update_xr  denom = sum of those partials; pd &= denom > 0 (sticky);
//                 alpha = pd ? rz / safe(denom) : 0; x += alpha p;
//                 r -= alpha hp; per-block partial sums of r . r
//   cg_update_p   rz_new = sum of the r . z partials; beta = rz_new /
//                 safe(rz); p = z + beta p; stores rz, r2, pd and the
//                 continue flag pd && r2 > thresh
//
// with z = r when there is no preconditioner (then the r . r partials are
// the r . z partials); with one, the caller applies it between the two
// updates and `dot_partials` gives r . z. `cg_residual` and `cg_start` set
// a solve up, `cg_finish` computes ok = finite(x) && (pd || r2 <= thresh)
// and zeroes x when not ok.
//
// Reductions take two passes and no atomics: a kernel writes one partial
// per block, and every block of the next kernel re-reduces all partials in
// the same fixed order (sum_partials), so all blocks use the same alpha and
// beta bit for bit and a run repeats exactly.
//
// The scalars sit in one buffer of kSlots values (the slot names are
// mirrored in kernels/cg_step.py). A kernel never writes a slot that
// another block of the same launch reads: cg_update_xr reads RZ and PD and
// writes RZ_OLD and PD_NEXT, cg_update_p reads those and writes RZ and PD.
//
// The vector kernels are flat over the n = D N values of a CG vector and
// serve every block width; spmv_dot is instantiated for D = 3 and D = 6.
//
// Bound: memory. At 3 N = 300,000 float32 values a CG vector is 1.2 MB:
// cg_update_xr moves six vectors, cg_update_p three, spmv_dot what kernel A
// moves. At D = 3 all of it fits the 50 MB L2, so in the loop launch
// latency, not bandwidth, is what remains; at D = 6 and N = 100,000 the
// values alone are 58 MB and the product streams them from HBM.
#include "block_ell.cuh"

namespace g2o_torch {

enum Slot {
  RZ = 0, R2 = 1, B2 = 2, THRESH = 3, PD = 4, CONT = 5,
  RZ_OLD = 6, PD_NEXT = 7, ALPHA = 8, BETA = 9, kSlots = 10
};

template <typename T, int D>
__global__ void spmv_dot_kernel(const int* __restrict__ nb,
                                const T* __restrict__ vals,
                                const T* __restrict__ p, T* __restrict__ hp,
                                T* __restrict__ partials, int n,
                                int k_width) {
  __shared__ T smem[32];
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long N = n;
  T local = T(0);
  if (row < n) {
    T y[D];
    block_ell_row<T, D>(nb, vals, p, row, N, k_width, y);
#pragma unroll
    for (int s = 0; s < D; ++s) hp[s * N + row] = y[s];
    local = block_row_dot<T, D>(p, row, N, y);
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void dot_partials_kernel(const T* __restrict__ a,
                                    const T* __restrict__ b,
                                    T* __restrict__ partials, long long n) {
  __shared__ T smem[32];
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  T local = T(0);
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) local += a[i] * b[i];
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// r = b - hx, p = r, partials of r . r and b . b.
template <typename T>
__global__ void cg_residual_kernel(const T* __restrict__ b,
                                   const T* __restrict__ hx,
                                   T* __restrict__ r, T* __restrict__ p,
                                   T* __restrict__ part_rr,
                                   T* __restrict__ part_bb, long long n) {
  __shared__ T smem[32];
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  T rr = T(0), bb = T(0);
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) {
      const T bi = b[i];
      const T ri = bi - hx[i];
      r[i] = ri;
      p[i] = ri;
      rr += ri * ri;
      bb += bi * bi;
    }
  }
  const T rr_total = block_sum(rr, smem);
  const T bb_total = block_sum(bb, smem);
  if (threadIdx.x == 0) {
    part_rr[blockIdx.x] = rr_total;
    part_bb[blockIdx.x] = bb_total;
  }
}

// One block: the scalars of a fresh solve.
template <typename T>
__global__ void cg_start_kernel(T* __restrict__ scal,
                                const T* __restrict__ part_rz, int n_rz,
                                const T* __restrict__ part_rr, int n_rr,
                                const T* __restrict__ part_b2, int n_b2,
                                T tol2, int precond_norm) {
  __shared__ T smem[32];
  const T rz = sum_partials(part_rz, n_rz, smem);
  const T r2 = precond_norm ? rz : sum_partials(part_rr, n_rr, smem);
  const T bsum = sum_partials(part_b2, n_b2, smem);
  if (threadIdx.x == 0) {
    const T b2 = bsum < T(1e-30) ? T(1e-30) : bsum;     // keeps a NaN
    const T thresh = tol2 * b2;
    scal[RZ] = rz;
    scal[R2] = r2;
    scal[B2] = b2;
    scal[THRESH] = thresh;
    scal[PD] = T(1);
    scal[CONT] = r2 > thresh ? T(1) : T(0);
    scal[RZ_OLD] = rz;
    scal[PD_NEXT] = T(1);
    scal[ALPHA] = T(0);
    scal[BETA] = T(0);
  }
}

template <typename T>
__global__ void cg_update_xr_kernel(T* __restrict__ scal,
                                    const T* __restrict__ part_pap, int n_pap,
                                    T* __restrict__ x, T* __restrict__ r,
                                    const T* __restrict__ p,
                                    const T* __restrict__ hp,
                                    T* __restrict__ part_rr, long long n) {
  __shared__ T smem[32];
  const T denom = sum_partials(part_pap, n_pap, smem);
  const T rz = scal[RZ];
  // a NaN denom fails denom > 0, so it turns pd off as well
  const bool pd = (scal[PD] != T(0)) && (denom > T(0));
  const T safe = denom == T(0) ? T(1) : denom;
  const T alpha = pd ? rz / safe : T(0);
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  T rr = T(0);
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) {
      x[i] = alpha * p[i] + x[i];
      const T ri = -alpha * hp[i] + r[i];
      r[i] = ri;
      rr += ri * ri;
    }
  }
  const T total = block_sum(rr, smem);
  if (threadIdx.x == 0) {
    part_rr[blockIdx.x] = total;
    if (blockIdx.x == 0) {
      scal[RZ_OLD] = rz;
      scal[PD_NEXT] = pd ? T(1) : T(0);
      scal[ALPHA] = alpha;
    }
  }
}

template <typename T>
__global__ void cg_update_p_kernel(T* __restrict__ scal,
                                   const T* __restrict__ part_rz, int n_rz,
                                   const T* __restrict__ part_rr, int n_rr,
                                   const T* __restrict__ z, T* __restrict__ p,
                                   long long n, int precond_norm) {
  __shared__ T smem[32];
  const T rz_new = sum_partials(part_rz, n_rz, smem);
  const T rz_old = scal[RZ_OLD];
  const T beta = rz_new / (rz_old == T(0) ? T(1) : rz_old);
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) p[i] = beta * p[i] + z[i];
  }
  if (blockIdx.x == 0) {
    // block-uniform branch: sum_partials synchronizes the block
    const T r2 = (precond_norm || part_rr == part_rz)
                     ? rz_new : sum_partials(part_rr, n_rr, smem);
    if (threadIdx.x == 0) {
      const T pd = scal[PD_NEXT];
      scal[RZ] = rz_new;
      scal[R2] = r2;
      scal[PD] = pd;
      scal[BETA] = beta;
      scal[CONT] = (pd != T(0) && r2 > scal[THRESH]) ? T(1) : T(0);
    }
  }
}

template <typename T>
__global__ void nonfinite_partials_kernel(const T* __restrict__ x,
                                          int* __restrict__ partials,
                                          long long n) {
  __shared__ int smem[32];
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  int bad = 0;
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n && !isfinite(x[i])) ++bad;
  }
  const int total = block_sum(bad, smem);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <typename T>
__global__ void cg_finish_kernel(const T* __restrict__ scal,
                                 const int* __restrict__ part_bad, int n_bad,
                                 T* __restrict__ x, unsigned char* ok_out,
                                 long long n) {
  __shared__ int smem[32];
  const int bad = sum_partials(part_bad, n_bad, smem);
  const bool ok = bad == 0
                  && (scal[PD] != T(0) || scal[R2] <= scal[THRESH]);
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  if (!ok) {
    for (int v = 0; v < kVec; ++v) {
      const long long i = base + v * kThreads;
      if (i < n) x[i] = T(0);
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) ok_out[0] = ok ? 1 : 0;
}

template <typename T, int D>
int run_spmv_dot(const int* nb, const T* vals, const T* p, T* hp, T* partials,
                 int n, int k_width, cudaStream_t stream) {
  spmv_dot_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, p, hp, partials, n, k_width);
  return launch_status();
}

template <typename T>
int launch_spmv_dot(const int* nb, const T* vals, const T* p, T* hp,
                    T* partials, int n, int k_width, int d,
                    cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 3:
      return run_spmv_dot<T, 3>(nb, vals, p, hp, partials, n, k_width, stream);
    case 6:
      return run_spmv_dot<T, 6>(nb, vals, p, hp, partials, n, k_width, stream);
    default:
      return bad_block_width();
  }
}

template <typename T>
int launch_dot_partials(const T* a, const T* b, T* partials, long long n,
                        cudaStream_t stream) {
  dot_partials_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      a, b, partials, n);
  return launch_status();
}

template <typename T>
int launch_cg_residual(const T* b, const T* hx, T* r, T* p, T* part_rr,
                       T* part_bb, long long n, cudaStream_t stream) {
  cg_residual_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      b, hx, r, p, part_rr, part_bb, n);
  return launch_status();
}

template <typename T>
int launch_cg_start(T* scal, const T* part_rz, int n_rz, const T* part_rr,
                    int n_rr, const T* part_b2, int n_b2, double tol2,
                    int precond_norm, cudaStream_t stream) {
  cg_start_kernel<T><<<1, kThreads, 0, stream>>>(
      scal, part_rz, n_rz, part_rr, n_rr, part_b2, n_b2,
      static_cast<T>(tol2), precond_norm);
  return launch_status();
}

template <typename T>
int launch_cg_update_xr(T* scal, const T* part_pap, int n_pap, T* x, T* r,
                        const T* p, const T* hp, T* part_rr, long long n,
                        cudaStream_t stream) {
  cg_update_xr_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      scal, part_pap, n_pap, x, r, p, hp, part_rr, n);
  return launch_status();
}

template <typename T>
int launch_cg_update_p(T* scal, const T* part_rz, int n_rz, const T* part_rr,
                       int n_rr, const T* z, T* p, long long n,
                       int precond_norm, cudaStream_t stream) {
  cg_update_p_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      scal, part_rz, n_rz, part_rr, n_rr, z, p, n, precond_norm);
  return launch_status();
}

template <typename T>
int launch_nonfinite_partials(const T* x, int* partials, long long n,
                              cudaStream_t stream) {
  nonfinite_partials_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      x, partials, n);
  return launch_status();
}

template <typename T>
int launch_cg_finish(const T* scal, const int* part_bad, int n_bad, T* x,
                     unsigned char* ok_out, long long n,
                     cudaStream_t stream) {
  cg_finish_kernel<T><<<chunks_for(n), kThreads, 0, stream>>>(
      scal, part_bad, n_bad, x, ok_out, n);
  return launch_status();
}

}  // namespace g2o_torch

#define G2O_STREAM static_cast<cudaStream_t>(stream)

extern "C" {

int g2o_spmv_dot_f32(const int* nb, const float* vals, const float* p,
                     float* hp, float* partials, int n, int k_width, int d,
                     void* stream) {
  return g2o_torch::launch_spmv_dot<float>(nb, vals, p, hp, partials, n,
                                           k_width, d, G2O_STREAM);
}
int g2o_spmv_dot_f64(const int* nb, const double* vals, const double* p,
                     double* hp, double* partials, int n, int k_width, int d,
                     void* stream) {
  return g2o_torch::launch_spmv_dot<double>(nb, vals, p, hp, partials, n,
                                            k_width, d, G2O_STREAM);
}

int g2o_dot_partials_f32(const float* a, const float* b, float* partials,
                         int n, void* stream) {
  return g2o_torch::launch_dot_partials<float>(a, b, partials, n, G2O_STREAM);
}
int g2o_dot_partials_f64(const double* a, const double* b, double* partials,
                         int n, void* stream) {
  return g2o_torch::launch_dot_partials<double>(a, b, partials, n,
                                                G2O_STREAM);
}

int g2o_cg_residual_f32(const float* b, const float* hx, float* r, float* p,
                        float* part_rr, float* part_bb, int n, void* stream) {
  return g2o_torch::launch_cg_residual<float>(b, hx, r, p, part_rr, part_bb,
                                              n, G2O_STREAM);
}
int g2o_cg_residual_f64(const double* b, const double* hx, double* r,
                        double* p, double* part_rr, double* part_bb, int n,
                        void* stream) {
  return g2o_torch::launch_cg_residual<double>(b, hx, r, p, part_rr, part_bb,
                                               n, G2O_STREAM);
}

int g2o_cg_start_f32(float* scal, const float* part_rz, int n_rz,
                     const float* part_rr, int n_rr, const float* part_b2,
                     int n_b2, double tol2, int precond_norm, void* stream) {
  return g2o_torch::launch_cg_start<float>(scal, part_rz, n_rz, part_rr, n_rr,
                                           part_b2, n_b2, tol2, precond_norm,
                                           G2O_STREAM);
}
int g2o_cg_start_f64(double* scal, const double* part_rz, int n_rz,
                     const double* part_rr, int n_rr, const double* part_b2,
                     int n_b2, double tol2, int precond_norm, void* stream) {
  return g2o_torch::launch_cg_start<double>(scal, part_rz, n_rz, part_rr,
                                            n_rr, part_b2, n_b2, tol2,
                                            precond_norm, G2O_STREAM);
}

int g2o_cg_update_xr_f32(float* scal, const float* part_pap, int n_pap,
                         float* x, float* r, const float* p, const float* hp,
                         float* part_rr, int n, void* stream) {
  return g2o_torch::launch_cg_update_xr<float>(scal, part_pap, n_pap, x, r, p,
                                               hp, part_rr, n, G2O_STREAM);
}
int g2o_cg_update_xr_f64(double* scal, const double* part_pap, int n_pap,
                         double* x, double* r, const double* p,
                         const double* hp, double* part_rr, int n,
                         void* stream) {
  return g2o_torch::launch_cg_update_xr<double>(scal, part_pap, n_pap, x, r,
                                                p, hp, part_rr, n,
                                                G2O_STREAM);
}

int g2o_cg_update_p_f32(float* scal, const float* part_rz, int n_rz,
                        const float* part_rr, int n_rr, const float* z,
                        float* p, int n, int precond_norm, void* stream) {
  return g2o_torch::launch_cg_update_p<float>(scal, part_rz, n_rz, part_rr,
                                              n_rr, z, p, n, precond_norm,
                                              G2O_STREAM);
}
int g2o_cg_update_p_f64(double* scal, const double* part_rz, int n_rz,
                        const double* part_rr, int n_rr, const double* z,
                        double* p, int n, int precond_norm, void* stream) {
  return g2o_torch::launch_cg_update_p<double>(scal, part_rz, n_rz, part_rr,
                                               n_rr, z, p, n, precond_norm,
                                               G2O_STREAM);
}

int g2o_nonfinite_partials_f32(const float* x, int* partials, int n,
                               void* stream) {
  return g2o_torch::launch_nonfinite_partials<float>(x, partials, n,
                                                     G2O_STREAM);
}
int g2o_nonfinite_partials_f64(const double* x, int* partials, int n,
                               void* stream) {
  return g2o_torch::launch_nonfinite_partials<double>(x, partials, n,
                                                      G2O_STREAM);
}

int g2o_cg_finish_f32(const float* scal, const int* part_bad, int n_bad,
                      float* x, unsigned char* ok_out, int n, void* stream) {
  return g2o_torch::launch_cg_finish<float>(scal, part_bad, n_bad, x, ok_out,
                                            n, G2O_STREAM);
}
int g2o_cg_finish_f64(const double* scal, const int* part_bad, int n_bad,
                      double* x, unsigned char* ok_out, int n, void* stream) {
  return g2o_torch::launch_cg_finish<double>(scal, part_bad, n_bad, x, ok_out,
                                             n, G2O_STREAM);
}

}  // extern "C"
