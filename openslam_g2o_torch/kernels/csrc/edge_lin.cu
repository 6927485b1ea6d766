// K17: the edge linearizers of every edge type openslam_g2o_torch.models
// registers, for core/problem.py `linearize_group` on the card.
//
// Replaces, for one edge group, the JAX hot loop `linearize`
// (openslam_g2o_tpu/core/problem.py:350-392): its forward branch
// (vmap(jax.jacfwd) at :378 over `_tangent_residual_fn`:336) and its
// analytic branch (:367-370), with the residual at :365, rho' at :382-383
// and the fixed-vertex mask at :386-390, over the error functions of
// openslam_g2o_tpu/models/slam2d.py, slam3d.py and sba.py. It writes what
// openslam_g2o_torch/core/problem.py `linearize_group` returns:
//   resid [E, D]       the error at the stored parameters
//   jac_s [E, D, Ds]   d e(retract(x_0, d_0), ...) / d d_s at d = 0, per
//                      slot s, times the slot vertex's free flag
//   rho1  [E]          rho'(e^T Omega e) of the group's robust kernel
// so K15, K14 and K10's generic entry read them as before.
//
// The edge functors (each type's retractions and error) are in
// edge_functors.cuh, which K7's trial chi2 (trial.cu) shares. Two kernels,
// correct first:
//  * edge_lin_kernel (forward mode; every type but the three below): a
//    thread per (edge, pass). Pass 0 (blockIdx.y = 0) evaluates the error
//    at the stored parameters, e^T Omega e and rho'. Every other pass takes
//    up to kW tangent directions of one slot: it retracts that slot's
//    vertex by a Jet<T, W> whose derivative k is the one-hot direction
//    c0 + k, retracts every other slot by a plain zero (jacfwd retracts
//    them too, which renormalizes stored quaternions and wraps angles) and
//    evaluates the error through the same templated code, so that the
//    derivative follows what the error computes: renormalizations, the
//    qw >= 0 flip, the compact quaternion's clamp, the expmap's and the
//    logarithm's small-angle branches and the angle wrap, as jvp follows
//    them. kW = 6 in float32 and 3 in float64, to bound registers.
//  * edge_lin_analytic_kernel (EDGE_SE2, EDGE_PROJECT_XYZ2UV:EXPMAP,
//    EDGE_PROJECT_XYZ2UVU:EXPMAP, whose JAX types carry a closed-form
//    Jacobian): a thread per edge writes the residual, the closed form
//    (se2_edge.cuh, the code of kernel B; xyz2uv.cuh, the code of K10's
//    fused entry) and rho'.
// Every input is read from global memory by the thread that needs it (no
// shared-memory staging) and every output written once.
//
// Bound: memory. A pass reads the edge's vertex parameters, measurement
// and parameter data; pass 0 also Omega, delta and writes D + 1 values;
// the passes write the D x sum(Ds) Jacobian entries once. At the PSI2UV
// scene's 80,000 edges in float32 that is about 19 MB, 5.6 us at 3.35
// TB/s. The Jet arithmetic of the expmap retraction and the repeated
// gathers of the passes (each pass reads the edge's vertices again) are
// what a faster design would trim.
#include "edge_functors.cuh"

namespace g2o_torch {

constexpr int kLinThreads = 128;

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

// Directions per pass: a Jet of 6 floats, or of 3 doubles (a 6-wide Jet of
// doubles through the expmap retraction holds too many registers).
template <typename T>
struct LinChunk { static constexpr int kW = 6; };
template <>
struct LinChunk<double> { static constexpr int kW = 3; };

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

// x[s] <- the slot's vertex retracted by zero, for every slot but MOVED
template <class F, int S, int MOVED, typename T>
__device__ __forceinline__ void rest_slot(const T (&x)[kMaxSlots][kMaxUsed],
                                          T (&rest)[kMaxSlots][kMaxUsed]) {
  if constexpr (S < F::kSlots && S != MOVED) {
    T zero[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) zero[k] = T(0);
    F::template retract<S>(x[S], zero, rest[S]);
  }
}

// Columns C0 .. C0+W-1 of slot S's Jacobian of one edge
template <class F, typename T, int S, int C0, int W>
__device__ __forceinline__ void jac_pass(const LinArgs<T>& a, long long e,
                                         const T (&x)[kMaxSlots][kMaxUsed],
                                         const T* meas, const T* pd) {
  typedef Jet<T, W> J;
  constexpr int Ds = F::dim(S);
  T rest[kMaxSlots][kMaxUsed];
  rest_slot<F, 0, S>(x, rest);
  rest_slot<F, 1, S>(x, rest);
  rest_slot<F, 2, S>(x, rest);
  J step[Ds], moved[kMaxUsed];
#pragma unroll
  for (int k = 0; k < Ds; ++k) {
    step[k] = J(T(0));
#pragma unroll
    for (int m = 0; m < W; ++m) step[k].d[m] = k == C0 + m ? T(1) : T(0);
  }
  F::template retract<S>(x[S], step, moved);
  J err[F::kD];
  if constexpr (S == 0)
    call_error<F>(moved, rest[1], rest[2], meas, pd, err);
  else if constexpr (S == 1)
    call_error<F>(rest[0], moved, rest[2], meas, pd, err);
  else
    call_error<F>(rest[0], rest[1], moved, meas, pd, err);
  const T fm = a.free_mask[S][a.idx[S][e]];
  T* out = a.jac[S] + e * (F::kD * Ds);
#pragma unroll
  for (int r = 0; r < F::kD; ++r)
#pragma unroll
    for (int m = 0; m < W; ++m) out[r * Ds + C0 + m] = err[r].d[m] * fm;
}

// Pass `pass` of the Jacobian passes, counted from (S, C0)
template <class F, typename T, int S, int C0>
__device__ __forceinline__ void jac_dispatch(
    int pass, const LinArgs<T>& a, long long e,
    const T (&x)[kMaxSlots][kMaxUsed], const T* meas, const T* pd) {
  if constexpr (S < F::kSlots) {
    constexpr int Ds = F::dim(S), kW = LinChunk<T>::kW;
    constexpr int W = Ds - C0 < kW ? Ds - C0 : kW;
    if (pass == 0) {
      jac_pass<F, T, S, C0, W>(a, e, x, meas, pd);
      return;
    }
    if constexpr (C0 + W < Ds)
      jac_dispatch<F, T, S, C0 + W>(pass - 1, a, e, x, meas, pd);
    else
      jac_dispatch<F, T, S + 1, 0>(pass - 1, a, e, x, meas, pd);
  }
}

template <class F, typename T>
constexpr int jac_passes() {
  int n = 0;
  for (int s = 0; s < F::kSlots; ++s)
    n += (F::dim(s) + LinChunk<T>::kW - 1) / LinChunk<T>::kW;
  return n;
}

// The residual, e^T Omega e and rho' of edge e
template <class F, typename T>
__device__ __forceinline__ void store_residual(const LinArgs<T>& a,
                                               long long e, const T* err) {
  const T* om = a.info + e * (F::kD * F::kD);
  T e2 = T(0);
#pragma unroll
  for (int r = 0; r < F::kD; ++r)
#pragma unroll
    for (int c = 0; c < F::kD; ++c) e2 += err[r] * om[r * F::kD + c] * err[c];
#pragma unroll
  for (int r = 0; r < F::kD; ++r) a.resid[e * F::kD + r] = err[r];
  a.rho1[e] = robust_rho1<T>(a.kernel_id, e2, a.delta[e]);
}

template <class F, typename T>
__global__ void __launch_bounds__(kLinThreads)
edge_lin_kernel(const LinArgs<T> a) {
  static_assert(pd_size<F>() <= kMaxPdata, "parameter data too wide");
  const long long e =
      blockIdx.x * static_cast<long long>(kLinThreads) + threadIdx.x;
  if (e >= a.n_edges) return;
  T x[kMaxSlots][kMaxUsed], meas[F::kMeas], pd[pd_size<F>()];
  load_edge<F>(a, e, x, meas, pd);
  if (blockIdx.y > 0) {
    jac_dispatch<F, T, 0, 0>(blockIdx.y - 1, a, e, x, meas, pd);
    return;
  }
  // pass 0: the residual at the stored parameters, e^T Omega e, rho'
  T err[F::kD];
  call_error<F>(x[0], x[1], x[2], meas, pd, err);
  store_residual<F>(a, e, err);
}

// The closed forms: a thread per edge, two slots
template <class F, typename T>
__global__ void __launch_bounds__(kLinThreads)
edge_lin_analytic_kernel(const LinArgs<T> a) {
  constexpr int D0 = F::dim(0), D1 = F::dim(1);
  const long long e =
      blockIdx.x * static_cast<long long>(kLinThreads) + threadIdx.x;
  if (e >= a.n_edges) return;
  T x[kMaxSlots][kMaxUsed], meas[F::kMeas], pd[pd_size<F>()];
  load_edge<F>(a, e, x, meas, pd);
  T err[F::kD], j0[F::kD][D0], j1[F::kD][D1];
  F::lin(x[0], x[1], meas, pd, a.free_mask[0][a.idx[0][e]],
         a.free_mask[1][a.idx[1][e]], err, j0, j1);
  store_residual<F>(a, e, err);
  T* out0 = a.jac[0] + e * (F::kD * D0);
  T* out1 = a.jac[1] + e * (F::kD * D1);
#pragma unroll
  for (int r = 0; r < F::kD; ++r) {
#pragma unroll
    for (int c = 0; c < D0; ++c) out0[r * D0 + c] = j0[r][c];
#pragma unroll
    for (int c = 0; c < D1; ++c) out1[r * D1 + c] = j1[r][c];
  }
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
  const unsigned blocks = (n_edges + kLinThreads - 1) / kLinThreads;
  if constexpr (F::kAnalytic) {
    edge_lin_analytic_kernel<F, T><<<blocks, kLinThreads, 0, stream>>>(a);
  } else {
    const dim3 grid(blocks, 1 + jac_passes<F, T>());
    edge_lin_kernel<F, T><<<grid, kLinThreads, 0, stream>>>(a);
  }
  return launch_status();
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

}  // extern "C"
