// K17: forward-mode edge linearizers of EDGE_SE3:QUAT (on the dense and
// Schur routes), EDGE_SE3_TRACKXYZ, EDGE_PROJECT_P2MC_INTRINSICS and
// EDGE_PROJECT_PSI2UV:EXPMAP.
//
// Replaces, for one edge group of one of those types, the JAX hot loop
// `linearize` (openslam_g2o_tpu/core/problem.py:350-392: vmap(jax.jacfwd)
// at :378 over `_tangent_residual_fn`:336, the residual at :365, rho' at
// :382-383 and the fixed-vertex mask at :386-390) over the error functions
// `_edge_se3_error` (models/slam3d.py:70), `_edge_se3_xyz_error`
// (slam3d.py:95), `_edge_p2mc_intrinsics_error` (models/sba.py:320) and
// `_edge_psi2uv_error` (sba.py:262). It writes what
// openslam_g2o_torch/core/problem.py `linearize_group` returns:
//   resid [E, D]       the error at the stored parameters
//   jac_s [E, D, Ds]   d e(retract(x_0, d_0), ...) / d d_s at d = 0, per
//                      slot s, times the slot vertex's free flag
//   rho1  [E]          rho'(e^T Omega e) of the group's robust kernel
// so K15, K14 and K10's generic entry read them as before.
//
// Design, correct first: a thread per (edge, pass). Pass 0 (blockIdx.y = 0)
// evaluates the error at the stored parameters, e^T Omega e and rho'. Every
// other pass takes up to kW tangent directions of one slot: it retracts
// that slot's vertex by a Jet<T, W> whose derivative k is the one-hot
// direction c0 + k, retracts every other slot by a plain zero (jacfwd
// retracts them too, which renormalizes stored quaternions) and evaluates
// the error through the same templated code, so that the derivative
// follows what the error computes: renormalizations, the qw >= 0 flip, the
// compact quaternion's clamp and the expmap's small-angle branch, as jvp
// follows them. kW = 6 in float32 and 3 in float64, to bound registers.
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
#include "sba_edge.cuh"

namespace g2o_torch {

constexpr int kLinThreads = 128;
constexpr int kMaxSlots = 3;
constexpr int kMaxUsed = 7;          // parameters a slot reads, at most

template <typename T>
struct LinArgs {
  const T* params[kMaxSlots];        // per slot: its vertex group's table
  const T* free_mask[kMaxSlots];
  const int* idx[kMaxSlots];
  const T* meas;                     // [E, kMeas]
  const T* info;                     // [E, D, D]
  const T* delta;                    // [E]
  const T* pdata;                    // [E, kPdata] or null
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
// The edge functors: slot widths, parameter strides, retractions per slot
// and the error, each templated on the slots' scalar types.
// ---------------------------------------------------------------------------

// EDGE_SE3:QUAT (models/slam3d.py _edge_se3_error):
// toVectorMQT(Z^-1 Xi^-1 Xj); slots se3, se3.
struct LinSE3 {
  static constexpr int kSlots = 2, kD = 6, kMeas = 7, kPdata = 0;
  __host__ __device__ static constexpr int dim(int) { return 6; }
  __host__ __device__ static constexpr int stride(int) { return 7; }
  __host__ __device__ static constexpr int used(int) { return 7; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    se3_retract_mqt(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* xi, const B* xj, const T* meas,
                               const T*, mix_t<A, B>* err) {
    T zinv[7];
    se3_inverse(meas, zinv);
    se3_error_mqt(zinv, xi, xj, err);
  }
};

// EDGE_SE3_TRACKXYZ (slam3d.py _edge_se3_xyz_error): (X offset)^-1 p - z;
// slots se3, point_xyz; the offset (t, q) per edge in pdata.
struct LinSE3XYZ {
  static constexpr int kSlots = 2, kD = 3, kMeas = 3, kPdata = 7;
  __host__ __device__ static constexpr int dim(int s) { return s ? 3 : 6; }
  __host__ __device__ static constexpr int stride(int s) {
    return s ? 3 : 7;
  }
  __host__ __device__ static constexpr int used(int s) { return s ? 3 : 7; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 0)
      se3_retract_mqt(x, d, o);
    else
      rn_retract<3>(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* pt, const T* meas,
                               const T* off, mix_t<A, B>* err) {
    A n2w[7], w2n[7];
    se3_compose(x, off, n2w);
    se3_inverse(n2w, w2n);
    se3_apply(w2n, pt, err);
    for (int k = 0; k < 3; ++k) err[k] = err[k] - meas[k];
  }
};

// EDGE_PROJECT_P2MC_INTRINSICS (models/sba.py
// _edge_p2mc_intrinsics_error): pc = R^T (p - t) of the camera-to-world
// VERTEX_CAM, (fx pc.x + cx pc.z, fy pc.y + cy pc.z) / pc.z - obs through
// the shared VERTEX_INTRINSICS; slots sba_point_xyz, cam (12 parameters,
// the pose's 7 read), intrinsics (5, the first 4 read).
struct LinP2MCIntrinsics {
  static constexpr int kSlots = 3, kD = 2, kMeas = 2, kPdata = 0;
  __host__ __device__ static constexpr int dim(int s) {
    return s == 0 ? 3 : (s == 1 ? 6 : 4);
  }
  __host__ __device__ static constexpr int stride(int s) {
    return s == 0 ? 3 : (s == 1 ? 12 : 5);
  }
  __host__ __device__ static constexpr int used(int s) {
    return s == 0 ? 3 : (s == 1 ? 7 : 4);
  }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 1)
      cam_retract(x, d, o);
    else
      rn_retract<dim(S)>(x, d, o);
  }
  template <typename T, typename P, typename C, typename K>
  __device__ static void error(const P* point, const C* cam, const K* intr,
                               const T* meas, const T*,
                               mix3_t<P, C, K>* err) {
    typedef mix_t<P, C> R;
    C qc[4] = {-cam[3], -cam[4], -cam[5], cam[6]};
    R d[3], pc[3];
    for (int k = 0; k < 3; ++k) d[k] = point[k] - cam[k];
    quat_rotate(qc, d, pc);
    err[0] = (intr[0] * pc[0] + intr[2] * pc[2]) / pc[2] - meas[0];
    err[1] = (intr[1] * pc[1] + intr[3] * pc[2]) / pc[2] - meas[1];
  }
};

// EDGE_PROJECT_PSI2UV:EXPMAP (sba.py _edge_psi2uv_error):
// obs - cam_map(T_c T_a^-1 invert_depth(psi)); slots sba_point_xyz (psi),
// se3_expmap (observing camera), se3_expmap (anchor); the camera
// parameters (focal, cx, cy, baseline) per edge in pdata.
struct LinPSI2UV {
  static constexpr int kSlots = 3, kD = 2, kMeas = 2, kPdata = 4;
  __host__ __device__ static constexpr int dim(int s) { return s ? 6 : 3; }
  __host__ __device__ static constexpr int stride(int s) {
    return s ? 7 : 3;
  }
  __host__ __device__ static constexpr int used(int s) { return s ? 7 : 3; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 0)
      rn_retract<3>(x, d, o);
    else
      se3_retract_expmap_left(x, d, o);
  }
  template <typename T, typename P, typename C, typename A>
  __device__ static void error(const P* psi, const C* cam, const A* anchor,
                               const T* meas, const T* camp,
                               mix3_t<P, C, A>* err) {
    A ainv[7];
    P pa[3];
    mix_t<A, P> pw[3];
    mix3_t<C, A, P> pc[3], uv[2];
    se3_inverse(anchor, ainv);
    invert_depth(psi, pa);
    se3_apply(ainv, pa, pw);
    se3_apply(cam, pw, pc);
    cam_map(pc, camp[0], camp[1], camp[2], uv);
    err[0] = meas[0] - uv[0];
    err[1] = meas[1] - uv[1];
  }
};

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

// The error of F on the slots' parameters x0, x1, x2 of whatever types
template <class F, typename T, typename A, typename B, typename C, typename O>
__device__ __forceinline__ void call_error(const A* x0, const B* x1,
                                           const C* x2, const T* meas,
                                           const T* pd, O* err) {
  if constexpr (F::kSlots == 2)
    F::error(x0, x1, meas, pd, err);
  else
    F::error(x0, x1, x2, meas, pd, err);
}

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

template <class F, typename T>
__global__ void __launch_bounds__(kLinThreads)
edge_lin_kernel(const LinArgs<T> a) {
  const long long e =
      blockIdx.x * static_cast<long long>(kLinThreads) + threadIdx.x;
  if (e >= a.n_edges) return;
  T x[kMaxSlots][kMaxUsed];
#pragma unroll
  for (int s = 0; s < F::kSlots; ++s) {
    const long long v = a.idx[s][e];
#pragma unroll
    for (int k = 0; k < F::used(s); ++k)
      x[s][k] = a.params[s][v * F::stride(s) + k];
  }
  T meas[F::kMeas], pd[F::kPdata > 0 ? F::kPdata : 1];
#pragma unroll
  for (int k = 0; k < F::kMeas; ++k) meas[k] = a.meas[e * F::kMeas + k];
#pragma unroll
  for (int k = 0; k < F::kPdata; ++k) pd[k] = a.pdata[e * F::kPdata + k];
  if (blockIdx.y > 0) {
    jac_dispatch<F, T, 0, 0>(blockIdx.y - 1, a, e, x, meas, pd);
    return;
  }
  // pass 0: the residual at the stored parameters, e^T Omega e, rho'
  T err[F::kD];
  call_error<F>(x[0], x[1], x[2], meas, pd, err);
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
int launch_edge_lin(const T* p0, const T* f0, const int* i0, const T* p1,
                    const T* f1, const int* i1, const T* p2, const T* f2,
                    const int* i2, const T* meas, const T* info,
                    const T* delta, const T* pdata, int kernel_id, T* resid,
                    T* j0, T* j1, T* j2, T* rho1, int n_edges,
                    cudaStream_t stream) {
  if (n_edges <= 0) return 0;
  const LinArgs<T> a{{p0, p1, p2}, {f0, f1, f2}, {i0, i1, i2}, meas, info,
                     delta, pdata, kernel_id, resid, {j0, j1, j2}, rho1,
                     n_edges};
  const dim3 grid((n_edges + kLinThreads - 1) / kLinThreads,
                  1 + jac_passes<F, T>());
  edge_lin_kernel<F, T><<<grid, kLinThreads, 0, stream>>>(a);
  return launch_status();
}

}  // namespace g2o_torch

#define G2O_EDGE_LIN_ENTRY(NAME, FUNCTOR, T, SUFFIX)                         \
  int NAME##SUFFIX(const T* p0, const T* f0, const int* i0, const T* p1,     \
                   const T* f1, const int* i1, const T* p2, const T* f2,     \
                   const int* i2, const T* meas, const T* info,              \
                   const T* delta, const T* pdata, int kernel_id, T* resid,  \
                   T* j0, T* j1, T* j2, T* rho1, int n_edges, void* stream) { \
    return g2o_torch::launch_edge_lin<g2o_torch::FUNCTOR, T>(                \
        p0, f0, i0, p1, f1, i1, p2, f2, i2, meas, info, delta, pdata,        \
        kernel_id, resid, j0, j1, j2, rho1, n_edges,                         \
        static_cast<cudaStream_t>(stream));                                  \
  }

extern "C" {

G2O_EDGE_LIN_ENTRY(g2o_edge_lin_se3, LinSE3, float, _f32)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_se3, LinSE3, double, _f64)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_se3_xyz, LinSE3XYZ, float, _f32)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_se3_xyz, LinSE3XYZ, double, _f64)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_p2mc_intrinsics, LinP2MCIntrinsics, float,
                   _f32)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_p2mc_intrinsics, LinP2MCIntrinsics, double,
                   _f64)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_psi2uv, LinPSI2UV, float, _f32)
G2O_EDGE_LIN_ENTRY(g2o_edge_lin_psi2uv, LinPSI2UV, double, _f64)

}  // extern "C"
