// K17: the edge linearizers of every edge type openslam_g2o_torch.models
// registers, for core/problem.py `linearize_group` on the card.
//
// Replaces, for one edge group, the JAX hot loop `linearize`
// (openslam_g2o_tpu/core/problem.py:350-392): its forward branch
// (vmap(jax.jacfwd) at :378 over `_tangent_residual_fn`:336) and its
// analytic branch (:367-370), with the residual at :365, rho' at :382-383
// and the fixed-vertex mask at :386-390, over the error functions of
// openslam_g2o_tpu/models/slam2d.py, slam3d.py, sba.py and bal.py. It
// writes what openslam_g2o_torch/core/problem.py `linearize_group`
// returns:
//   resid [E, D]       the error at the stored parameters
//   jac_s [E, D, Ds]   d e(retract(x_0, d_0), ...) / d d_s at d = 0, per
//                      slot s, times the slot vertex's free flag
//   rho1  [E]          rho'(e^T Omega e) of the group's robust kernel
// so K15, K14 and K10's generic entry read them as before.
//
// The edge functors (each type's retractions and error) are in
// edge_functors.cuh, which K7's trial chi2 (trial.cu) shares. Two kernels:
//  * edge_lin_kernel (forward mode; every type but the three below): a
//    block per tile of 32 consecutive edges. The block stages the tile in
//    shared memory once, a thread per slot and edge: the vertex index and
//    free flag, the gathered vertex parameters, and the vertex retracted
//    by a plain zero (jacfwd retracts every slot, which renormalizes
//    stored quaternions and wraps angles); the measurement and parameter
//    data come as contiguous runs. Its warps then run the tile's jobs from
//    that copy, a lane an edge; LinPlan spreads the jobs over the warps,
//    costliest first onto the least loaded, so that their loads come out
//    even. The residual job evaluates the error at the stored parameters,
//    e^T Omega e and rho'. Every other job is a pass over up to 6 tangent
//    directions of one slot: it retracts that slot's vertex by a
//    Jet<T, 6> whose derivative k is the one-hot direction c0 + k, takes
//    every other slot at its staged retraction by zero, and evaluates the
//    error through the same templated code, so that the derivative follows
//    what the error computes: renormalizations, the qw >= 0 flip, the
//    compact quaternion's clamp, the expmap's and the logarithm's
//    small-angle branches and the angle wrap, as jvp follows them. The
//    residual and each slot's Jacobian [32, D, Ds] collect in shared
//    memory in global memory's layout and leave as contiguous runs: whole
//    128-byte lines.
//  * edge_lin_analytic_kernel (EDGE_SE2, EDGE_PROJECT_XYZ2UV:EXPMAP,
//    EDGE_PROJECT_XYZ2UVU:EXPMAP, whose JAX types carry a closed-form
//    Jacobian): a block per tile of consecutive edges, a thread an edge,
//    over the tile loader of edge_tile.cuh (K7's trial chi2 shares it):
//    the contiguous inputs arrive in shared memory by cp.async while the
//    threads gather their vertices; each thread computes the residual, the
//    closed form (se2_edge.cuh, the code of kernel B; xyz2uv.cuh, the code
//    of K10's fused entry) and rho' into the tile, and the outputs leave
//    as contiguous runs of whole lines. EDGE_SE2 runs
//    edge_lin_analytic_direct_kernel instead, a thread per edge that reads
//    and writes global memory itself (launch_analytic says why).
//
// Bound: memory. An edge's vertex parameters, measurement, parameter data,
// Omega and delta are read, and D + 1 values and the D x sum(Ds) Jacobian
// entries written, once. At the PSI2UV scene's 80,000 edges in float32
// that is about 19 MB, 5.6 us at 3.35 TB/s. The forward mode's Jet
// arithmetic (the expmap retraction and logarithm on 6 directions) is
// what keeps the kernel above it. Measured and dropped (PERF.md §6):
// a warp a job whatever its cost (idle light warps hold registers), two
// tiles a block, passes of 1-3 directions (more value work; 1 and 2 also
// other bits), the retractions by zero recomputed in every pass, and
// small groups writing their Jacobians straight from the jobs.
#include <type_traits>

#include "edge_tile.cuh"

namespace g2o_torch {

template <typename T>
struct LinArgs {
  const T* params[kMaxSlots];        // per slot: its vertex group's table
  const T* free_mask[kMaxSlots];
  const int* idx[kMaxSlots];
  const T* meas;                     // [E, kMeas]
  const T* info;                     // [E, D, D]
  const T* delta;                    // [E]
  const T* pdata[2];                 // [E, kPdata], [E, kPdata2] or null
  int kernel_id;
  T* resid;                          // [E, D]
  T* jac[kMaxSlots];                 // [E, D, Ds]
  T* rho1;                           // [E]
  int n_edges;
};

// The forward kernel's shape: a tile of kLinTile consecutive edges a
// block, one a lane of each warp; kLinW tangent directions a Jacobian pass
// (a Jet of 6: in float64 too, whose 6-wide passes measured faster than
// 3-wide ones and gave the same bits); at most kLinMaxWarps warps a block.
constexpr int kLinTile = 32;
constexpr int kLinW = 6;
constexpr int kLinMaxWarps = 8;

template <class F>
__host__ __device__ constexpr int slot_offset(int s) {   // of slot s's values
  int n = 0;
  for (int k = 0; k < s; ++k) n += F::used(k);
  return n;
}

template <class F>
__host__ __device__ constexpr int jac_offset(int s) {    // per edge
  int n = 0;
  for (int k = 0; k < s; ++k) n += F::kD * F::dim(k);
  return n;
}

template <class F>
__host__ __device__ constexpr int jac_passes() {
  int n = 0;
  for (int s = 0; s < F::kSlots; ++s) n += (F::dim(s) + kLinW - 1) / kLinW;
  return n;
}

// Pass j of an edge (0: the residual; j > 0: Jacobian pass j - 1, counted
// slot by slot, kLinW directions at a time): its slot, first direction and
// width (the residual's slot is -1)
struct PassOf {
  int slot, c0, w;
};

template <class F>
__host__ __device__ constexpr PassOf pass_of(int j) {
  if (j == 0) return PassOf{-1, 0, 0};
  int k = 1;
  for (int s = 0; s < F::kSlots; ++s)
    for (int c0 = 0; c0 < F::dim(s); c0 += kLinW, ++k)
      if (k == j)
        return PassOf{s, c0, F::dim(s) - c0 < kLinW ? F::dim(s) - c0 : kLinW};
  return PassOf{-1, 0, 0};
}

// The tile's jobs, 1 + passes of them (job q: the residual for q = 0, else
// Jacobian pass q - 1), spread over the block's warps by longest job first
// onto the least loaded warp. A pass of w directions costs about 1 + w
// evaluations of the error, the residual one: the warps' loads come out
// even, so that no warp holds its registers idle while the others run the
// heavy passes.
template <class F>
struct LinPlan {
  static constexpr int kJobs = 1 + jac_passes<F>();

  __host__ __device__ static constexpr int cost(int q) {
    return 1 + pass_of<F>(q).w;
  }
  __host__ __device__ static constexpr int warps() {
    int total = 0, most = 0;
    for (int q = 0; q < kJobs; ++q) {
      total += cost(q);
      most = cost(q) > most ? cost(q) : most;
    }
    const int nw = (total + most - 1) / most;
    return nw < kLinMaxWarps ? nw : kLinMaxWarps;
  }
  // the warp of job q
  __host__ __device__ static constexpr int warp_of(int q) {
    int load[kLinMaxWarps] = {}, owner = 0;
    bool done[kJobs] = {};
    for (int n = 0; n < kJobs; ++n) {
      int best = -1;                       // the costliest job left
      for (int r = 0; r < kJobs; ++r)
        if (!done[r] && (best < 0 || cost(r) > cost(best))) best = r;
      int w = 0;                           // the least loaded warp
      for (int v = 1; v < warps(); ++v)
        if (load[v] < load[w]) w = v;
      done[best] = true;
      load[w] += cost(best);
      if (best == q) owner = w;
    }
    return owner;
  }
};

// One tile in shared memory, edge on the fastest axis of every staged
// value (a lane reads its edge's values without bank conflicts): the
// slots' gathered parameters x, their retractions by zero (rest), the
// measurement, the parameter data, the free flags, and the outputs
// (residual [E, D], each slot's Jacobian [E, D, Ds]) in the layout of
// global memory, so that each is one contiguous run there.
template <class F, typename T>
struct LinTile {
  static constexpr int kUsed = slot_offset<F>(F::kSlots);
  T x[kUsed][kLinTile];
  T rest[kUsed][kLinTile];
  T meas[F::kMeas][kLinTile];
  T pd[pd_size<F>()][kLinTile];
  T fm[kMaxSlots][kLinTile];
  T resid[kLinTile * F::kD];
  T jac[kLinTile * jac_offset<F>(F::kSlots)];
};

// slot S's values of edge i, from a staged table
template <class F, int S, typename T>
__device__ __forceinline__ void tile_slot(const T (*src)[kLinTile], int i,
                                          T (&dst)[kMaxUsed]) {
#pragma unroll
  for (int k = 0; k < F::used(S); ++k)
    dst[k] = src[slot_offset<F>(S) + k][i];
}

// x[S] -> rest: the slot's vertex retracted by zero
template <class F, int S, typename T>
__device__ __forceinline__ void retract_zero(const T (&x)[kMaxUsed],
                                             T (&rest)[kMaxUsed]) {
  T zero[F::dim(S)];
#pragma unroll
  for (int k = 0; k < F::dim(S); ++k) zero[k] = T(0);
  F::template retract<S>(x, zero, rest);
}

// Slot S of edge i (edge e0 + i): its vertex index and free flag, its
// parameters and its retraction by zero
template <class F, int S, typename T>
__device__ __forceinline__ void stage_slot(const LinArgs<T>& a,
                                           LinTile<F, T>& t, long long e0,
                                           int i) {
  if constexpr (S < F::kSlots) {
    const long long v = a.idx[S][e0 + i];
    t.fm[S][i] = a.free_mask[S][v];
    T x[kMaxUsed], r[kMaxUsed];
#pragma unroll
    for (int k = 0; k < F::used(S); ++k) {
      x[k] = a.params[S][v * F::stride(S) + k];
      t.x[slot_offset<F>(S) + k][i] = x[k];
    }
    retract_zero<F, S>(x, r);
#pragma unroll
    for (int k = 0; k < F::used(S); ++k)
      t.rest[slot_offset<F>(S) + k][i] = r[k];
  }
}

// rest[O] of a pass on slot S: slot O at its retraction by zero
template <class F, int S, int O, typename T>
__device__ __forceinline__ void other_slot(const LinTile<F, T>& t, int i,
                                           T (&rest)[kMaxUsed]) {
  if constexpr (O < F::kSlots && O != S) tile_slot<F, O>(t.rest, i, rest);
}

// Columns C0 .. C0+W-1 of slot S's Jacobian of edge i, into the tile: the
// slot's vertex retracted by a Jet of the one-hot directions C0 + m, every
// other slot at its retraction by zero
template <class F, typename T, int S, int C0, int W>
__device__ __forceinline__ void jac_pass(LinTile<F, T>& t, int i,
                                         const T* meas, const T* pd) {
  typedef Jet<T, W> J;
  constexpr int Ds = F::dim(S);
  T x[kMaxUsed], rest[kMaxSlots][kMaxUsed];
  tile_slot<F, S>(t.x, i, x);
  other_slot<F, S, 0>(t, i, rest[0]);
  other_slot<F, S, 1>(t, i, rest[1]);
  other_slot<F, S, 2>(t, i, rest[2]);
  J step[Ds], moved[kMaxUsed];
#pragma unroll
  for (int k = 0; k < Ds; ++k) {
    step[k] = J(T(0));
#pragma unroll
    for (int m = 0; m < W; ++m) step[k].d[m] = k == C0 + m ? T(1) : T(0);
  }
  F::template retract<S>(x, step, moved);
  J err[F::kD];
  if constexpr (S == 0)
    call_error<F>(moved, rest[1], rest[2], meas, pd, err);
  else if constexpr (S == 1)
    call_error<F>(rest[0], moved, rest[2], meas, pd, err);
  else
    call_error<F>(rest[0], rest[1], moved, meas, pd, err);
  const T fm = t.fm[S][i];
  T* out = t.jac + kLinTile * jac_offset<F>(S) + i * (F::kD * Ds);
#pragma unroll
  for (int r = 0; r < F::kD; ++r)
#pragma unroll
    for (int m = 0; m < W; ++m) out[r * Ds + C0 + m] = err[r].d[m] * fm;
}

// The residual, e^T Omega e and rho' of edge e: the residual into `out`
template <class F, typename T>
__device__ __forceinline__ void store_residual(const LinArgs<T>& a,
                                               long long e, const T* err,
                                               T* out) {
  const T* om = a.info + e * (F::kD * F::kD);
  T e2 = T(0);
#pragma unroll
  for (int r = 0; r < F::kD; ++r)
#pragma unroll
    for (int c = 0; c < F::kD; ++c) e2 += err[r] * om[r * F::kD + c] * err[c];
#pragma unroll
  for (int r = 0; r < F::kD; ++r) out[r] = err[r];
  a.rho1[e] = robust_rho1<T>(a.kernel_id, e2, a.delta[e]);
}

// Job Q of the tile, on lane i (the caller's warp owns it)
template <class F, typename T, int Q>
__device__ __forceinline__ void run_job(const LinArgs<T>& a,
                                        LinTile<F, T>& t, long long e0,
                                        int i) {
  constexpr PassOf pass = pass_of<F>(Q);
  T meas[F::kMeas], pd[pd_size<F>()];
#pragma unroll
  for (int k = 0; k < F::kMeas; ++k) meas[k] = t.meas[k][i];
#pragma unroll
  for (int k = 0; k < F::kPdata + F::kPdata2; ++k) pd[k] = t.pd[k][i];
  if constexpr (pass.slot < 0) {
    // the residual at the stored parameters, e^T Omega e, rho'
    T x[kMaxSlots][kMaxUsed], err[F::kD];
    tile_slot<F, 0>(t.x, i, x[0]);
    if constexpr (F::kSlots > 1) tile_slot<F, 1>(t.x, i, x[1]);
    if constexpr (F::kSlots > 2) tile_slot<F, 2>(t.x, i, x[2]);
    call_error<F>(x[0], x[1], x[2], meas, pd, err);
    store_residual<F>(a, e0 + i, err, t.resid + i * F::kD);
  } else {
    jac_pass<F, T, pass.slot, pass.c0, pass.w>(t, i, meas, pd);
  }
}

template <class F, typename T, int Q>
__device__ __forceinline__ void run_jobs(const LinArgs<T>& a,
                                         LinTile<F, T>& t, long long e0,
                                         int i, int warp) {
  if constexpr (Q < LinPlan<F>::kJobs) {
    constexpr int w = LinPlan<F>::warp_of(Q);
    if (warp == w) run_job<F, T, Q>(a, t, e0, i);
    run_jobs<F, T, Q + 1>(a, t, e0, i, warp);
  }
}

// The tile's run src[0..count) of W values an edge (count <= kLinTile W)
// into its staged table, dst[k % W][k / W] = src[k]: consecutive threads
// on consecutive values, every load of a thread issued before its stores
template <int W, int NT, typename T>
__device__ __forceinline__ void stage_run(T (*dst)[kLinTile],
                                          const T* __restrict__ src,
                                          int count) {
  constexpr int kPer = (kLinTile * W + NT - 1) / NT;
  T v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = threadIdx.x + r * NT;
    if (k < count) v[r] = src[k];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = threadIdx.x + r * NT;
    if (k < count) dst[k % W][k / W] = v[r];
  }
}

// The tile's output src[0..count) (count <= kLinTile W) -> dst, the same
// way round: consecutive threads on consecutive values, the shared-memory
// loads of a thread before its stores
template <int W, int NT, typename T>
__device__ __forceinline__ void store_run(T* __restrict__ dst, const T* src,
                                          int count) {
  constexpr int kPer = (kLinTile * W + NT - 1) / NT;
  T v[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = threadIdx.x + r * NT;
    if (k < count) v[r] = src[k];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int k = threadIdx.x + r * NT;
    if (k < count) dst[k] = v[r];
  }
}

// slot S's Jacobian tile -> global memory
template <class F, int S, int NT, typename T>
__device__ __forceinline__ void store_jac(const LinArgs<T>& a,
                                          const LinTile<F, T>& t,
                                          long long e0, int n) {
  if constexpr (S < F::kSlots) {
    constexpr int W = F::kD * F::dim(S);
    store_run<W, NT>(a.jac[S] + e0 * W, t.jac + kLinTile * jac_offset<F>(S),
                     n * W);
  }
}

// Forward mode: a block per tile of kLinTile consecutive edges. Its
// threads stage the tile (a thread per slot and edge: the vertex index and
// free flag, the gathered parameters and the retraction by zero; the
// measurement and parameter data as contiguous runs); its warps then run
// the tile's jobs from that copy, a lane an edge, as LinPlan spreads them:
// the residual at the stored parameters with e^T Omega e and rho', and
// every Jacobian pass of up to kLinW directions of one slot into the
// tile's Jacobians; last, every output leaves as contiguous runs.
template <class F, typename T>
__global__ void __launch_bounds__(32 * LinPlan<F>::warps())
edge_lin_kernel(const LinArgs<T> a) {
  static_assert(pd_size<F>() <= kMaxPdata, "parameter data too wide");
  constexpr int NT = 32 * LinPlan<F>::warps();
  __shared__ LinTile<F, T> t;
  const long long e0 = static_cast<long long>(blockIdx.x) * kLinTile;
  const int n = static_cast<int>(
      a.n_edges - e0 < kLinTile ? a.n_edges - e0 : kLinTile);
  for (int k = threadIdx.x; k < F::kSlots * kLinTile; k += NT) {
    const int s = k / kLinTile, i = k - s * kLinTile;
    if (i >= n) continue;
    if (s == 0)
      stage_slot<F, 0>(a, t, e0, i);
    else if (s == 1)
      stage_slot<F, 1>(a, t, e0, i);
    else
      stage_slot<F, 2>(a, t, e0, i);
  }
  stage_run<F::kMeas, NT>(t.meas, a.meas + e0 * F::kMeas, n * F::kMeas);
  if constexpr (F::kPdata > 0)
    stage_run<F::kPdata, NT>(t.pd, a.pdata[0] + e0 * F::kPdata,
                             n * F::kPdata);
  if constexpr (F::kPdata2 > 0)
    stage_run<F::kPdata2, NT>(t.pd + F::kPdata,
                              a.pdata[1] + e0 * F::kPdata2, n * F::kPdata2);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (lane < n) run_jobs<F, T, 0>(a, t, e0, lane, threadIdx.x >> 5);
  __syncthreads();
  store_run<F::kD, NT>(a.resid + e0 * F::kD, t.resid, n * F::kD);
  store_jac<F, 0, NT>(a, t, e0, n);
  store_jac<F, 1, NT>(a, t, e0, n);
  store_jac<F, 2, NT>(a, t, e0, n);
}

template <class F, typename T>
int launch_forward(const LinArgs<T>& a, cudaStream_t stream) {
  edge_lin_kernel<F, T><<<(a.n_edges + kLinTile - 1) / kLinTile,
                          32 * LinPlan<F>::warps(), 0, stream>>>(a);
  return launch_status();
}

// The closed forms (two slots), staged: a block per tile of kAnalyticTile
// consecutive edges, a thread an edge. The tile loader (edge_tile.cuh)
// stages the measurement, Omega, delta and the camera parameters while each
// thread gathers its slots' parameters and free flags; after the wait each
// thread runs F::lin, e^T Omega e and rho', and puts its residual,
// Jacobians and rho' into the tile's outputs in global memory's layout;
// after a barrier every output leaves as one contiguous run of whole
// 128-byte lines (16-byte stores), where a thread per edge stores 12-, 24-
// or 36-value strides. The tile is 128 edges: XYZ2UVU in float64 then
// stages 48 KB (17 input and 31 output values an edge), four blocks an SM.
constexpr int kAnalyticTile = 128;

// One tile's staged inputs, then its outputs: the residual [kTile, D],
// each slot's Jacobian [kTile, D, Ds] and rho' [kTile], each run 16-byte
// aligned
template <class F, typename T>
struct AnalyticTile {
  using In = EdgeTile<F, T, kAnalyticTile, 48 * 1024>;
  static constexpr int kR = F::kD, kW0 = kR * F::dim(0), kW1 = kR * F::dim(1);
  static constexpr int kResidAt = In::kValues;
  static constexpr int kJ0At = kResidAt + pad16<T>(kAnalyticTile * kR);
  static constexpr int kJ1At = kJ0At + pad16<T>(kAnalyticTile * kW0);
  static constexpr int kRhoAt = kJ1At + pad16<T>(kAnalyticTile * kW1);
  static constexpr int kBytes =
      (kRhoAt + pad16<T>(kAnalyticTile)) * static_cast<int>(sizeof(T));
};

template <class F, typename T>
__global__ void __launch_bounds__(kAnalyticTile)
edge_lin_analytic_kernel(const LinArgs<T> a) {
  using Tile = AnalyticTile<F, T>;
  using In = typename Tile::In;
  constexpr int R = Tile::kR, D0 = F::dim(0), D1 = F::dim(1);
  T* t = reinterpret_cast<T*>(g2o_tile_smem);
  const long long e0 = blockIdx.x * static_cast<long long>(kAnalyticTile);
  const int n = static_cast<int>(a.n_edges - e0 < kAnalyticTile
                                     ? a.n_edges - e0 : kAnalyticTile);
  const int i = threadIdx.x;
  long long v[kMaxSlots];
  T x[kMaxSlots][kMaxUsed], f0 = T(0), f1 = T(0);
  if (i < n) load_indices<F>(a, e0 + i, v);
  In::stage(a, t, e0, n);
  if (i < n) {
    gather_slots<F>(a, v, x);
    f0 = a.free_mask[0][v[0]];
    f1 = a.free_mask[1][v[1]];
  }
  In::wait();
  if (i < n) {
    T meas[F::kMeas], pd[pd_size<F>()], err[R], j0[R][D0], j1[R][D1];
    In::inputs(a, t, e0 + i, i, meas, pd);
    F::lin(x[0], x[1], meas, pd, f0, f1, err, j0, j1);
    const T rho1 =
        robust_rho1<T>(a.kernel_id, In::chi2(t, i, err), In::delta(t, i));
    tile_put<R>(t + Tile::kResidAt + i * R, err);
    tile_put<Tile::kW0>(t + Tile::kJ0At + i * Tile::kW0, &j0[0][0]);
    tile_put<Tile::kW1>(t + Tile::kJ1At + i * Tile::kW1, &j1[0][0]);
    t[Tile::kRhoAt + i] = rho1;
  }
  __syncthreads();
  store_tile_run<kAnalyticTile>(a.resid + e0 * R, t + Tile::kResidAt, n * R);
  store_tile_run<kAnalyticTile>(a.jac[0] + e0 * Tile::kW0, t + Tile::kJ0At,
                                n * Tile::kW0);
  store_tile_run<kAnalyticTile>(a.jac[1] + e0 * Tile::kW1, t + Tile::kJ1At,
                                n * Tile::kW1);
  store_tile_run<kAnalyticTile>(a.rho1 + e0, t + Tile::kRhoAt, n);
}

// The closed forms, direct: a thread per edge that reads its inputs and
// writes its outputs itself, the staged kernel's arithmetic (its bits)
// without shared memory or barriers
template <class F, typename T>
__global__ void __launch_bounds__(kAnalyticTile)
edge_lin_analytic_direct_kernel(const LinArgs<T> a) {
  constexpr int R = F::kD, D0 = F::dim(0), D1 = F::dim(1);
  const long long e =
      blockIdx.x * static_cast<long long>(kAnalyticTile) + threadIdx.x;
  if (e >= a.n_edges) return;
  T x[kMaxSlots][kMaxUsed], meas[F::kMeas], pd[pd_size<F>()];
  load_edge<F>(a, e, x, meas, pd);
  T err[R], j0[R][D0], j1[R][D1];
  F::lin(x[0], x[1], meas, pd, a.free_mask[0][a.idx[0][e]],
         a.free_mask[1][a.idx[1][e]], err, j0, j1);
  store_residual<F>(a, e, err, a.resid + e * R);
  T* out0 = a.jac[0] + e * (R * D0);
  T* out1 = a.jac[1] + e * (R * D1);
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int c = 0; c < D0; ++c) out0[r * D0 + c] = j0[r][c];
#pragma unroll
    for (int c = 0; c < D1; ++c) out1[r * D1 + c] = j1[r][c];
  }
}

// The form a type takes: EDGE_SE2 direct, the projections staged. Every
// EDGE_SE2 group the paths run holds at most 3,961 edges (phases 4d, 4i
// and 4o), under one block an SM, where the staging pass and its two
// barriers are latency the direct form does not pay: staged, phase 4d's
// group measured slower (float64 5.80-5.89 -> 6.02-6.04 us on an NVIDIA
// H100 80GB HBM3, 700.00 W; kernel_times.py --only lin). The
// projections' staged form measured faster at every size the paths run
// (PERF.md §6).
template <class F, typename T>
int launch_analytic(const LinArgs<T>& a, cudaStream_t stream) {
  const unsigned blocks = (a.n_edges + kAnalyticTile - 1) / kAnalyticTile;
  if constexpr (std::is_same<F, LinSE2>::value) {
    edge_lin_analytic_direct_kernel<F, T>
        <<<blocks, kAnalyticTile, 0, stream>>>(a);
  } else {
    constexpr int bytes = AnalyticTile<F, T>::kBytes;
    static unsigned long long allowed = 0;
    const int err = allow_tile_smem(edge_lin_analytic_kernel<F, T>, bytes,
                                    allowed);
    if (err) return err;
    edge_lin_analytic_kernel<F, T>
        <<<blocks, kAnalyticTile, bytes, stream>>>(a);
  }
  return launch_status();
}

template <class F, typename T>
int launch_edge_lin(const T* p0, const T* f0, const int* i0, const T* p1,
                    const T* f1, const int* i1, const T* p2, const T* f2,
                    const int* i2, const T* meas, const T* info,
                    const T* delta, const T* pdata, const T* pdata2,
                    int kernel_id, T* resid, T* j0, T* j1, T* j2, T* rho1,
                    int n_edges, cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  const LinArgs<T> a{{p0, p1, p2}, {f0, f1, f2}, {i0, i1, i2}, meas, info,
                     delta, {pdata, pdata2}, kernel_id, resid, {j0, j1, j2},
                     rho1, n_edges};
  if constexpr (F::kAnalytic) {
    return launch_analytic<F, T>(a, stream);
  } else {
    return launch_forward<F, T>(a, stream);
  }
}

}  // namespace g2o_torch

#define G2O_EDGE_LIN_ENTRY(NAME, FUNCTOR, T, SUFFIX)                         \
  int NAME##SUFFIX(const T* p0, const T* f0, const int* i0, const T* p1,     \
                   const T* f1, const int* i1, const T* p2, const T* f2,     \
                   const int* i2, const T* meas, const T* info,              \
                   const T* delta, const T* pdata, const T* pdata2,          \
                   int kernel_id, T* resid, T* j0, T* j1, T* j2, T* rho1,    \
                   int n_edges, void* stream) {                              \
    return g2o_torch::launch_edge_lin<g2o_torch::FUNCTOR, T>(                \
        p0, f0, i0, p1, f1, i1, p2, f2, i2, meas, info, delta, pdata,        \
        pdata2, kernel_id, resid, j0, j1, j2, rho1, n_edges,                 \
        static_cast<cudaStream_t>(stream));                                  \
  }
#define G2O_EDGE_LIN_ENTRIES(NAME, FUNCTOR)                                  \
  G2O_EDGE_LIN_ENTRY(NAME, FUNCTOR, float, _f32)                             \
  G2O_EDGE_LIN_ENTRY(NAME, FUNCTOR, double, _f64)

// One entry pair per edge type; the names are kernels/edge_lin.py's
// LINEARIZERS with the prefix g2o_.
extern "C" {

G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3, LinSE3)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_xyz, LinSE3XYZ)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_p2mc_intrinsics, LinP2MCIntrinsics)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_psi2uv, LinPSI2UV)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2, LinSE2)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_xy, LinSE2XY)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_bearing, LinSE2Bearing)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_prior, LinSE2Prior)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_prior_xy, LinSE2PriorXY)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_xy_calib, LinSE2XYCalib)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_offset, LinSE2Offset)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se2_xy_offset, LinSE2XYOffset)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_depth, LinSE3Depth)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_disparity, LinSE3Disparity)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_prior, LinSE3Prior)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_offset, LinSE3Offset)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_se3_expmap, LinSE3Expmap)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_xyz2uv, LinXYZ2UV)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_xyz2uvu, LinXYZ2UVU)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_p2mc, LinP2MC)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_p2sc, LinP2SC)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_sba_cam, LinSBACam)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_sba_scale, LinSBAScale)
G2O_EDGE_LIN_ENTRIES(g2o_edge_lin_bal, LinBAL)

}  // extern "C"
