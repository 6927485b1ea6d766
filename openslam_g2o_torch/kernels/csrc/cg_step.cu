// K6: the conjugate-gradient step of the LM-PCG trial solve, two launches
// per iteration without a preconditioner and three with one, with every CG
// scalar on the device.
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
// Without a preconditioner the step is two launches. cg_update_xr, given
// an arrival counter, stores cg_update_p's scalars itself: its last block
// to arrive (the counter after __threadfence, the partials read past L1
// with __ldcg) re-reduces the r . r partials and stores rz, r2, pd, beta
// and the continue flag, so the host's flag read sees what it saw after
// cg_update_p. The p update then rides on the product that reads p next:
// spmv_dot_p writes p_new = beta p + r into the other of two p buffers
// (neighbours still gather p) and gathers beta p[j] + r[j] at every
// neighbour column j, the same expression (next_direction) with the same
// FMA contraction, so H p_new and p_new . H p_new have the bits of the
// three-launch step. The first iteration has no beta (cg_residual set
// p = r) and runs spmv_dot.
//
// Reductions take two passes and no atomics on values: a kernel writes one
// partial per block, and every block of the next kernel re-reduces all
// partials in the same fixed order (sum_partials; in cg_update_xr and
// cg_update_p one warp, warp_sum_partials), so all blocks use the same
// alpha and beta bit for bit and a run repeats exactly.
//
// The scalars sit in one buffer of kSlots values (the slot names are
// mirrored in kernels/cg_step.py). A kernel never writes a slot that
// another block of the same launch reads, with one exception:
// cg_update_xr reads RZ and PD and writes RZ_OLD and PD_NEXT (block 0);
// cg_update_p reads those and writes RZ and PD; cg_update_xr's finishing
// block writes RZ and PD after every other block has arrived, that is,
// after each has read them.
//
// The vector kernels are flat over the n = D N values of a CG vector and
// serve every block width; spmv_dot and spmv_dot_p are instantiated for
// D = 3 and D = 6.
//
// Bound: memory. At 3 N = 300,000 float32 values a CG vector is 1.2 MB:
// cg_update_xr moves six vectors (7.2 MB, 2.15 us at 3.35 TB/s; 4.30 us at
// D = 6), cg_update_p three, spmv_dot what kernel A moves. At D = 3 all of
// it fits the 50 MB L2, so in the loop launch latency, not bandwidth, is
// what remains, and one launch fewer per iteration is the lever; at D = 6
// and N = 100,000 the values alone are 58 MB and the product streams them
// from HBM. What stood between cg_update_xr and its bound was latency in
// series: every block re-reduced the 391 partials of p . hp with a block
// sum (two barriers), and the finishing block re-reduced one r . r partial
// per 1024 values the same way after the last arrival. Now one warp reduces
// each with all its loads in flight at once, and a block takes 2048 values
// (kXrShare), which halves the partials the finish re-reduces.
#include "block_ell.cuh"

namespace g2o_torch {

enum Slot {
  RZ = 0, R2 = 1, B2 = 2, THRESH = 3, PD = 4, CONT = 5,
  RZ_OLD = 6, PD_NEXT = 7, ALPHA = 8, BETA = 9, kSlots = 10
};

// Declared, as spmv_dot_p and kernel A are, for 256 threads and 3 blocks an
// SM (see spmv_dot_p_kernel).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3) spmv_dot_kernel(
    const int* __restrict__ nb, const T* __restrict__ vals,
    const T* __restrict__ p, T* __restrict__ hp, T* __restrict__ partials,
    int n, int k_width) {
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

// One value of the next search direction, p = beta p + z: the one
// expression of cg_update_p and spmv_dot_p, so that both contract it to the
// same FMA and the gathered copies equal the stored ones bit for bit.
template <typename T>
__device__ __forceinline__ T next_direction(T beta, T p, T z) {
  return beta * p + z;
}

// The column gather of spmv_dot_p: beta p_old[:, col] + r[:, col].
template <typename T, int D>
struct NextColumn {
  const T* __restrict__ p;
  const T* __restrict__ r;
  T beta;
  long long N;
  __device__ __forceinline__ void operator()(long long col,
                                             T (&xg)[D]) const {
#pragma unroll
    for (int t = 0; t < D; ++t)
      xg[t] = next_direction(beta, p[t * N + col], r[t * N + col]);
  }
};

// spmv_dot with the p update of the step before folded in (z = r):
// p_new = beta p + r (beta from the scalar buffer, stored by the last
// cg_update_xr), hp = H p_new and the per-block partials of p_new . hp.
// Declared for 256 threads and 3 blocks an SM, ptxas gives the float32
// D = 6 instantiation 79 registers, enough to keep a slot's loads in
// flight: on an H100 it ran 57.1 us without the bound and 31.6 us with it
// (spmv_dot: 33.6).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 3) spmv_dot_p_kernel(
    const int* __restrict__ nb, const T* __restrict__ vals,
    const T* __restrict__ scal, const T* __restrict__ p,
    const T* __restrict__ r, T* __restrict__ p_new, T* __restrict__ hp,
    T* __restrict__ partials, int n, int k_width) {
  __shared__ T smem[32];
  const long long row = blockIdx.x * static_cast<long long>(blockDim.x)
                        + threadIdx.x;
  const long long N = n;
  const T beta = scal[BETA];
  T local = T(0);
  if (row < n) {
    const NextColumn<T, D> next{p, r, beta, N};
    T pn[D];
    next(row, pn);
#pragma unroll
    for (int s = 0; s < D; ++s) p_new[s * N + row] = pn[s];
    T y[D];
    block_ell_row_of<T, D>(nb, vals, next, row, N, k_width, y);
#pragma unroll
    for (int s = 0; s < D; ++s) hp[s * N + row] = y[s];
    local = row_dot<T, D>(pn, y);
  }
  // cg_update_xr, launched after it with programmatic stream
  // serialization, may be placed once every block is here: its blocks wait
  // for this grid to finish, and its launch hides behind these last sums
  asm volatile("griddepcontrol.launch_dependents;");
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

// A re-reduction of partials in one warp: lane i sums partials i, i + 32,
// ... in order, then a butterfly (__shfl_xor_sync) adds the lanes' sums.
// Addition is commutative, so at every step two partner lanes add the same
// two values and end with the same bits: every lane holds the sum. A lane
// issues up to 16 loads before it adds them (zeros past the end, which
// leave the sum's bits as they are), so 391 partials cost one round trip
// to L2, not one a partial. The loads go to L2 (__ldcg), past this SM's
// L1: cg_update_xr's finishing block reads partials that other blocks of
// its launch wrote, and under a programmatic dependent launch it reads the
// product's. cg_update_p sums the r . r partials in this same order, so the
// two-launch step's beta and r2 equal the three-launch step's bit for bit.
// Called by all 32 lanes of a warp.
template <typename T>
__device__ __forceinline__ T warp_sum_partials(const T* partials, int count) {
  constexpr int kBatch = 16;
  const int lane = threadIdx.x & 31;
  T v = T(0);
  for (int base = lane; base < count; base += 32 * kBatch) {
    T buf[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + 32 * j;
      buf[j] = i < count ? __ldcg(partials + i) : T(0);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) v += buf[j];
  }
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// cg_update_xr's share: kXrVals values a thread, element i = base + v *
// kThreads + threadIdx.x (coalesced), kXrShare = 2048 values a block, so one
// r . r partial per 2048 values (mirrored in kernels/cg_step.py XR_SHARE).
constexpr int kXrVals = 8;
constexpr int kXrShare = kThreads * kXrVals;

inline int xr_blocks(long long n) {
  return static_cast<int>(n <= 0 ? 1 : (n + kXrShare - 1) / kXrShare);
}

// denom = sum part_pap; pd &= denom > 0; alpha = pd ? rz / safe(denom) : 0;
// x += alpha p; r -= alpha hp; a partial sum of r . r per block.
//
// Warp 0 re-reduces the p . hp partials (warp_sum_partials: one round trip)
// while the other warps wait; then every thread issues its 4 kXrVals loads
// at once and updates its values. Every block reduces the same partials in
// the same order, so all use one alpha bit for bit. A share of 2048 values
// halves the partials (147 at 3 x 100,000, 293 at 6 x 100,000) against a
// share of 1024. Issuing the vector loads before the partials' round trip, or
// 16-byte loads over a fixed grid of 132 blocks, measured slower on the
// H100: the partials' loads queue behind the block's vector loads.
//
// With `arrivals` (one int32, zero) the launch also finishes the step for
// z = r: each block's thread 0 writes its partial, fences it and counts its
// arrival; the last block's warp 0 re-reduces the partials
// (warp_sum_partials, the order of cg_update_p) and stores what
// cg_update_p stores (rz_new = r2 = r . r, beta, pd, the continue flag),
// then sets the counter back to 0.
//
// It is always launched with programmatic stream serialization, so the
// grid may start while the kernel before it still runs: griddepcontrol.wait
// holds every thread until that kernel has finished and its writes (the
// partials, p and hp) are visible. That holds after any kernel; spmv_dot_p
// alone triggers early. p and hp are read from L2 (__ldcg).
template <typename T>
__global__ void __launch_bounds__(kThreads) cg_update_xr_kernel(
    T* __restrict__ scal, const T* __restrict__ part_pap, int n_pap,
    T* __restrict__ x, T* __restrict__ r, const T* __restrict__ p,
    const T* __restrict__ hp, T* __restrict__ part_rr, long long n,
    int* __restrict__ arrivals) {
  constexpr int kWarps = kThreads / 32;
  __shared__ T warp_rr[kWarps];
  __shared__ T s_alpha, s_rz;
  __shared__ int s_pd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (warp == 0) {
    const T denom = warp_sum_partials(part_pap, n_pap);
    if (lane == 0) {
      const T rz = __ldcg(scal + RZ);
      // a NaN denom fails denom > 0, so it turns pd off as well
      const bool pd = (__ldcg(scal + PD) != T(0)) && (denom > T(0));
      const T safe = denom == T(0) ? T(1) : denom;
      s_alpha = pd ? rz / safe : T(0);
      s_rz = rz;
      s_pd = pd;
    }
  }
  __syncthreads();
  const T alpha = s_alpha;
  const long long base = blockIdx.x * static_cast<long long>(kXrShare)
                         + threadIdx.x;
  T xv[kXrVals], rv[kXrVals], pv[kXrVals], hv[kXrVals];
#pragma unroll
  for (int v = 0; v < kXrVals; ++v) {
    const long long i = base + v * kThreads;
    const bool in = i < n;
    xv[v] = in ? x[i] : T(0);
    rv[v] = in ? r[i] : T(0);
    pv[v] = in ? __ldcg(p + i) : T(0);
    hv[v] = in ? __ldcg(hp + i) : T(0);
  }
  T rr = T(0);
#pragma unroll
  for (int v = 0; v < kXrVals; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) {
      x[i] = alpha * pv[v] + xv[v];
      const T ri = -alpha * hv[v] + rv[v];
      r[i] = ri;
      rr += ri * ri;
    }
  }
  for (int o = 16; o > 0; o >>= 1) rr += __shfl_down_sync(0xffffffffu, rr, o);
  if (lane == 0) warp_rr[warp] = rr;
  __syncthreads();
  int last = 0;
  if (threadIdx.x == 0) {
    T total = warp_rr[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) total += warp_rr[w];
    part_rr[blockIdx.x] = total;
    if (blockIdx.x == 0) {
      scal[RZ_OLD] = s_rz;
      scal[PD_NEXT] = s_pd ? T(1) : T(0);
      scal[ALPHA] = alpha;
    }
    if (arrivals != nullptr) {
      __threadfence();               // the partial, before the arrival
      last = atomicAdd(arrivals, 1) == static_cast<int>(gridDim.x) - 1;
    }
  }
  if (warp != 0 || arrivals == nullptr) return;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  const T rz_new = warp_sum_partials(part_rr, gridDim.x);
  if (lane == 0) {
    const T rz = s_rz;
    scal[RZ] = rz_new;
    scal[R2] = rz_new;
    scal[PD] = s_pd ? T(1) : T(0);
    scal[BETA] = rz_new / (rz == T(0) ? T(1) : rz);
    scal[CONT] = (s_pd && rz_new > scal[THRESH]) ? T(1) : T(0);
    *arrivals = 0;
  }
}

// rz_new and r2 re-reduce their partials with warp_sum_partials (warp 0,
// then shared memory), the order of cg_update_xr's finishing block.
template <typename T>
__global__ void cg_update_p_kernel(T* __restrict__ scal,
                                   const T* __restrict__ part_rz, int n_rz,
                                   const T* __restrict__ part_rr, int n_rr,
                                   const T* __restrict__ z, T* __restrict__ p,
                                   long long n, int precond_norm) {
  __shared__ T s_rz_new;
  if (threadIdx.x < 32) {
    const T v = warp_sum_partials(part_rz, n_rz);
    if (threadIdx.x == 0) s_rz_new = v;
  }
  __syncthreads();
  const T rz_new = s_rz_new;
  const T rz_old = scal[RZ_OLD];
  const T beta = rz_new / (rz_old == T(0) ? T(1) : rz_old);
  const long long base = blockIdx.x * static_cast<long long>(kChunk)
                         + threadIdx.x;
  for (int v = 0; v < kVec; ++v) {
    const long long i = base + v * kThreads;
    if (i < n) p[i] = next_direction(beta, p[i], z[i]);
  }
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // warp-uniform branch: warp_sum_partials needs the whole warp
    const T r2 = (precond_norm || part_rr == part_rz)
                     ? rz_new : warp_sum_partials(part_rr, n_rr);
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

template <typename T, int D>
int run_spmv_dot_p(const int* nb, const T* vals, const T* scal, const T* p,
                   const T* r, T* p_new, T* hp, T* partials, int n,
                   int k_width, cudaStream_t stream) {
  spmv_dot_p_kernel<T, D><<<grid_for(n), kThreads, 0, stream>>>(
      nb, vals, scal, p, r, p_new, hp, partials, n, k_width);
  return launch_status();
}

template <typename T>
int launch_spmv_dot_p(const int* nb, const T* vals, const T* scal,
                      const T* p, const T* r, T* p_new, T* hp, T* partials,
                      int n, int k_width, int d, cudaStream_t stream) {
  if (n <= 0) return 0;
  switch (d) {
    case 3:
      return run_spmv_dot_p<T, 3>(nb, vals, scal, p, r, p_new, hp, partials,
                                  n, k_width, stream);
    case 6:
      return run_spmv_dot_p<T, 6>(nb, vals, scal, p, r, p_new, hp, partials,
                                  n, k_width, stream);
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
                        int* arrivals, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(xr_blocks(n));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, cg_update_xr_kernel<T>, scal, part_pap, n_pap, x, r, p, hp,
      part_rr, n, arrivals);
  if (err != cudaSuccess) return static_cast<int>(err);
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

int g2o_spmv_dot_p_f32(const int* nb, const float* vals, const float* scal,
                       const float* p, const float* r, float* p_new,
                       float* hp, float* partials, int n, int k_width, int d,
                       void* stream) {
  return g2o_torch::launch_spmv_dot_p<float>(nb, vals, scal, p, r, p_new, hp,
                                             partials, n, k_width, d,
                                             G2O_STREAM);
}
int g2o_spmv_dot_p_f64(const int* nb, const double* vals, const double* scal,
                       const double* p, const double* r, double* p_new,
                       double* hp, double* partials, int n, int k_width,
                       int d, void* stream) {
  return g2o_torch::launch_spmv_dot_p<double>(nb, vals, scal, p, r, p_new,
                                              hp, partials, n, k_width, d,
                                              G2O_STREAM);
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
                         float* part_rr, int n, int* arrivals,
                         void* stream) {
  return g2o_torch::launch_cg_update_xr<float>(scal, part_pap, n_pap, x, r, p,
                                               hp, part_rr, n, arrivals,
                                               G2O_STREAM);
}
int g2o_cg_update_xr_f64(double* scal, const double* part_pap, int n_pap,
                         double* x, double* r, const double* p,
                         const double* hp, double* part_rr, int n,
                         int* arrivals, void* stream) {
  return g2o_torch::launch_cg_update_xr<double>(scal, part_pap, n_pap, x, r,
                                                p, hp, part_rr, n, arrivals,
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
