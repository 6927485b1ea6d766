// K7 on the dense GN / LM routes, the dual-ELL Schur trial and the general
// Schur trial: one trial's candidate and its robust chi2, for every vertex
// and edge type openslam_g2o_torch.models registers.
//
// Replaces `apply_update_parts` (openslam_g2o_tpu/core/problem.py:557-570),
// `apply_update` (:572-585) and `robust_chi2` (:321-329) over `edge_chi2`
// (:302) and `compute_errors` (:288), which XLA fused into the trial
// program and which, run op by op, are one torch launch per step of each
// vertex type's retraction and each edge type's error. Here a trial's
// outcome is 1 + (vertex groups) + (edge groups) launches:
//
//   trial_retract<V, T>    a thread per vertex of one group: cand =
//                          retract(x, dx * free) (a fixed vertex too, by a
//                          zero step, which renormalizes a stored
//                          quaternion and wraps an angle, as JAX's
//                          vmap(retract) over the masked step does); with
//                          b given, per-block partial sums of
//                          dx . (lambda dx + b) over the group's values
//   trial_edge_chi2<F, T>  a block of 256 edges of one group, a thread an
//                          edge (the float64 D = 6 types' inputs staged by
//                          the tile loader, edge_tile.cuh, while each thread
//                          gathers its edge's slots): the error at the
//                          candidate through K17's own functors
//                          (edge_functors.cuh), e^T Omega e and rho of the
//                          group's robust kernel; per-block partial sums
//   lm_outcome             (retract_chi2.cu) sums both in a fixed order
//
// and chi2_sum sums the partials of a chi2 alone (the chi2 at a route's
// init, GN's) in lm_outcome's order, so both give the same bits for the
// same partials. The step and the gradient are read by pointer and
// strides, (v, k) at v * sv + k * sk: the dense route's flat [T] vectors
// at the group's offset and the Schur routes' lane-major [D, N] parts
// without a transposed copy. No atomics: a run repeats bit for bit.
//
// Bound: memory. trial_retract moves P + 2D + 1 values in and P out per
// vertex; trial_edge_chi2 reads the edge's measurement, Omega, delta,
// parameter data, indices and gathered vertices. At the 400,000-edge BA
// scene in float32 that is about 21 MB per trial, 6.4 us at 3.35 TB/s.
#include "edge_tile.cuh"

namespace g2o_torch {

// ---------------------------------------------------------------------------
// The vertex retractions (oplus), one per built-in vertex type: kP stored
// parameters, kD tangent dimensions, the device code K17 retracts with.
// ---------------------------------------------------------------------------

// VERTEX_SE2 (ops/lie.py se2_retract): x + d, the angle wrapped
struct VtxSE2 {
  static constexpr int kP = 3, kD = 3;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    se2_retract(x, d, o);
  }
};

// VERTEX_SE3:QUAT (lie.py se3_retract_mqt): x * fromVectorMQT(d), the
// quaternion renormalized
struct VtxSE3 {
  static constexpr int kP = 7, kD = 6;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    se3_retract_mqt(x, d, o);
  }
};

// VERTEX_SE3:EXPMAP (lie.py se3_retract_expmap_left): exp(d) x
struct VtxSE3Expmap {
  static constexpr int kP = 7, kD = 6;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    se3_retract_expmap_left(x, d, o);
  }
};

// VERTEX_CAM (models/sba.py _cam_retract): cam_retract on the pose, the
// intrinsics (fx, fy, cx, cy, baseline) carried
struct VtxCam {
  static constexpr int kP = 12, kD = 6;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    cam_retract_all(x, d, o);
  }
};

// VERTEX_INTRINSICS (sba.py _intrinsics_retract): (fx, fy, cx, cy)
// additive, the baseline carried
struct VtxIntrinsics {
  static constexpr int kP = 5, kD = 4;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    rn_retract<4>(x, d, o);
    o[4] = x[4];
  }
};

// VERTEX_XY, VERTEX_TRACKXYZ, VERTEX_XYZ (the SBA point, also PSI2UV's
// inverse-depth point), VERTEX_CAMERA_BAL (models/bal.py: the nine camera
// values): additive
template <int W>
struct VtxRn {
  static constexpr int kP = W, kD = W;
  template <typename T>
  __device__ static void retract(const T* x, const T* d, T* o) {
    rn_retract<W>(x, d, o);
  }
};

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

template <typename T>
struct RetractArgs {
  const T* x;                        // [N, kP]
  const T* dx;                       // (v, k) at dx[v * dx_v + k * dx_k]
  long long dx_v, dx_k;
  const T* b;                        // likewise; null: no dot product
  long long b_v, b_k;
  const T* free_mask;                // [N]
  const T* lam;                      // 0-dim
  T* cand;                           // [N, kP]
  T* part_dot;                       // [blocks] or null
  int n;
};

template <class V, typename T>
__global__ void __launch_bounds__(kThreads)
trial_retract_kernel(const RetractArgs<T> a) {
  __shared__ T smem[32];
  const long long v = blockIdx.x * static_cast<long long>(kThreads)
                      + threadIdx.x;
  const bool dot = a.part_dot != nullptr;
  T local = T(0);
  if (v < a.n) {
    const T f = a.free_mask[v];
    const T l = dot ? *a.lam : T(0);
    T x[V::kP], step[V::kD], moved[V::kP];
#pragma unroll
    for (int k = 0; k < V::kP; ++k) x[k] = a.x[v * V::kP + k];
#pragma unroll
    for (int k = 0; k < V::kD; ++k) {
      const T d = a.dx[v * a.dx_v + k * a.dx_k];
      if (dot) local += d * (l * d + a.b[v * a.b_v + k * a.b_k]);
      step[k] = d * f;
    }
    V::retract(x, step, moved);
#pragma unroll
    for (int k = 0; k < V::kP; ++k) a.cand[v * V::kP + k] = moved[k];
  }
  if (dot) {                         // uniform over the grid
    const T total = block_sum(local, smem);
    if (threadIdx.x == 0) a.part_dot[blockIdx.x] = total;
  }
}

template <typename T>
struct ChiArgs {
  const T* params[kMaxSlots];        // per slot: its candidate table
  const int* idx[kMaxSlots];
  const T* meas;                     // [E, kMeas]
  const T* info;                     // [E, D, D]
  const T* delta;                    // [E]
  const T* pdata[2];                 // [E, kPdata], [E, kPdata2] or null
  int kernel_id;
  T* partials;                       // [blocks]
  int n_edges;
};

// A block of kThreads (256) threads takes 256 consecutive edges, a thread
// an edge, and writes one partial (trial.partial_count; lm_outcome and
// chi2_sum sum them in a fixed order). Two forms, by edge type and
// dtype, with the same arithmetic and so the same bits:
//  * staged (float64, the types whose Omega has 36 values, D = 6:
//    EDGE_SE3:QUAT, SE3_PRIOR, SE3_OFFSET, SE3:EXPMAP, EDGE_CAM): the tile
//    loader (edge_tile.cuh) stages the block's measurement, Omega, delta
//    and parameter data while each thread gathers its slots' candidates. A
//    thread that read its 36 Omega values itself issued them after the
//    error (they do not fit in its registers beside it), a second memory
//    latency after the gathers; staged, they arrive with the gathers.
//  * direct (the other 18 types, and the D = 6 types in float32): each
//    thread reads its edge's inputs itself. Staging measured slower for
//    the 18 at every shape the paths run, the 400,000-edge XYZ2UV group
//    included (kernel_times.py --only trial with every type staged,
//    PERF.md §6): their few Omega values are loaded with the gathers
//    anyway, and the staging pass and its barrier only add latency. The
//    D = 6 types in float32, whose Omega is half the bytes, measured
//    slower staged on 50,000-edge groups (EDGE_SE3:QUAT 8.27 -> 8.57 us,
//    EDGE_CAM 8.20 -> 8.56, SE3:EXPMAP 7.82 -> 9.28 on an NVIDIA H100
//    80GB HBM3, 700.00 W), and no path runs them in float32.
// Then the error through K17's functor, e^T Omega e in K17's order, rho of
// the group's robust kernel, and the block's partial by block_sum. The
// launcher picks the kernel of the form (trial_edge_chi2_kernel or
// trial_edge_chi2_direct_kernel) from the type and the dtype.
//
// The staged inputs may take up to kChiTileBytes of shared memory: two
// blocks then fit an SM, so a group of 50,000 edges (196 blocks) is
// resident at once on the 132 SMs. Only EDGE_SE3_OFFSET in float64 exceeds
// it with both offsets staged (116 KB): its second offset is read from
// global memory after the wait.
template <class F, typename T>
__host__ __device__ constexpr bool chi2_staged() {
  return F::kD == 6 && sizeof(T) == 8;
}

constexpr int kChiTileBytes = 112 * 1024;

template <class F, typename T>
using ChiTile = EdgeTile<F, T, kThreads, kChiTileBytes>;

template <class F, typename T>
__global__ void __launch_bounds__(kThreads)
trial_edge_chi2_kernel(const ChiArgs<T> a) {
  static_assert(pd_size<F>() <= kMaxPdata, "parameter data too wide");
  using Tile = ChiTile<F, T>;
  __shared__ T smem[32];
  T* t = reinterpret_cast<T*>(g2o_tile_smem);
  const long long e0 = blockIdx.x * static_cast<long long>(kThreads);
  const int n = static_cast<int>(
      a.n_edges - e0 < kThreads ? a.n_edges - e0 : kThreads);
  const int i = threadIdx.x;
  long long v[kMaxSlots];
  T x[kMaxSlots][kMaxUsed];
  if (i < n) load_indices<F>(a, e0 + i, v);
  Tile::stage(a, t, e0, n);
  if (i < n) gather_slots<F>(a, v, x);
  Tile::wait();
  T local = T(0);
  if (i < n) {
    T meas[F::kMeas], pd[pd_size<F>()], err[F::kD];
    Tile::inputs(a, t, e0 + i, i, meas, pd);
    call_error<F>(x[0], x[1], x[2], meas, pd, err);
    local = robust_rho0<T>(a.kernel_id, Tile::chi2(t, i, err),
                           Tile::delta(t, i));
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = total;
}

// The direct form: each thread reads its edge's inputs itself
template <class F, typename T>
__global__ void __launch_bounds__(kThreads)
trial_edge_chi2_direct_kernel(const ChiArgs<T> a) {
  static_assert(pd_size<F>() <= kMaxPdata, "parameter data too wide");
  __shared__ T smem[32];
  const long long e = blockIdx.x * static_cast<long long>(kThreads)
                      + threadIdx.x;
  T local = T(0);
  if (e < a.n_edges) {
    T x[kMaxSlots][kMaxUsed], meas[F::kMeas], pd[pd_size<F>()], err[F::kD];
    load_edge<F>(a, e, x, meas, pd);
    call_error<F>(x[0], x[1], x[2], meas, pd, err);
    local = robust_rho0<T>(
        a.kernel_id, quad_form<F::kD>(err, a.info + e * (F::kD * F::kD)),
        a.delta[e]);
  }
  const T total = block_sum(local, smem);
  if (threadIdx.x == 0) a.partials[blockIdx.x] = total;
}

// One block: out = the sum of the partials in lm_outcome's order
template <typename T>
__global__ void __launch_bounds__(kThreads)
chi2_sum_kernel(const T* __restrict__ partials, int n, T* __restrict__ out) {
  __shared__ T smem[32];
  const T total = sum_partials(partials, n, smem);
  if (threadIdx.x == 0) *out = total;
}

inline unsigned trial_blocks(int n) {
  return n > 0 ? static_cast<unsigned>(grid_for(n)) : 1u;
}

template <class V, typename T>
int launch_trial_retract(const T* x, const T* dx, long long dx_v,
                         long long dx_k, const T* b, long long b_v,
                         long long b_k, const T* free_mask, const T* lam,
                         T* cand, T* part_dot, int n, cudaStream_t stream) {
  const RetractArgs<T> a{x,         dx,  dx_v, dx_k, b,        b_v, b_k,
                         free_mask, lam, cand, part_dot, n};
  trial_retract_kernel<V, T><<<trial_blocks(n), kThreads, 0, stream>>>(a);
  return launch_status();
}

template <class F, typename T>
int launch_trial_chi2(const T* p0, const int* i0, const T* p1, const int* i1,
                      const T* p2, const int* i2, const T* meas,
                      const T* info, const T* delta, const T* pdata,
                      const T* pdata2, int kernel_id, T* partials,
                      int n_edges, cudaStream_t stream) {
  const ChiArgs<T> a{{p0, p1, p2}, {i0, i1, i2}, meas, info, delta,
                     {pdata, pdata2}, kernel_id, partials, n_edges};
  if constexpr (chi2_staged<F, T>()) {
    constexpr int bytes =
        ChiTile<F, T>::kValues * static_cast<int>(sizeof(T));
    static unsigned long long allowed = 0;
    const int err = allow_tile_smem(trial_edge_chi2_kernel<F, T>, bytes,
                                    allowed);
    if (err) return err;
    trial_edge_chi2_kernel<F, T>
        <<<trial_blocks(n_edges), kThreads, bytes, stream>>>(a);
  } else {
    trial_edge_chi2_direct_kernel<F, T>
        <<<trial_blocks(n_edges), kThreads, 0, stream>>>(a);
  }
  return launch_status();
}

template <typename T>
int launch_chi2_sum(const T* partials, int n, T* out, cudaStream_t stream) {
  chi2_sum_kernel<T><<<1, kThreads, 0, stream>>>(partials, n, out);
  return launch_status();
}

}  // namespace g2o_torch

#define G2O_TRIAL_RETRACT_ENTRY(NAME, V, T, SUFFIX)                          \
  int NAME##SUFFIX(const T* x, const T* dx, long long dx_v, long long dx_k,  \
                   const T* b, long long b_v, long long b_k,                 \
                   const T* free_mask, const T* lam, T* cand, T* part_dot,   \
                   int n, void* stream) {                                    \
    return g2o_torch::launch_trial_retract<g2o_torch::V, T>(                 \
        x, dx, dx_v, dx_k, b, b_v, b_k, free_mask, lam, cand, part_dot, n,   \
        static_cast<cudaStream_t>(stream));                                  \
  }
#define G2O_TRIAL_RETRACT_ENTRIES(NAME, V)                                   \
  G2O_TRIAL_RETRACT_ENTRY(NAME, V, float, _f32)                              \
  G2O_TRIAL_RETRACT_ENTRY(NAME, V, double, _f64)

#define G2O_TRIAL_CHI2_ENTRY(NAME, FUNCTOR, T, SUFFIX)                       \
  int NAME##SUFFIX(const T* p0, const int* i0, const T* p1, const int* i1,   \
                   const T* p2, const int* i2, const T* meas, const T* info, \
                   const T* delta, const T* pdata, const T* pdata2,          \
                   int kernel_id, T* partials, int n_edges, void* stream) {  \
    return g2o_torch::launch_trial_chi2<g2o_torch::FUNCTOR, T>(              \
        p0, i0, p1, i1, p2, i2, meas, info, delta, pdata, pdata2, kernel_id, \
        partials, n_edges, static_cast<cudaStream_t>(stream));               \
  }
#define G2O_TRIAL_CHI2_ENTRIES(NAME, FUNCTOR)                                \
  G2O_TRIAL_CHI2_ENTRY(NAME, FUNCTOR, float, _f32)                           \
  G2O_TRIAL_CHI2_ENTRY(NAME, FUNCTOR, double, _f64)

// One entry pair per vertex type (kernels/trial.py RETRACTIONS) and per edge
// type (kernels/trial.py CHI2, K17's functor list), with the prefix g2o_.
extern "C" {

G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_se2, VtxSE2)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_point_xy, VtxRn<2>)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_se3, VtxSE3)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_point_xyz, VtxRn<3>)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_se3_expmap, VtxSE3Expmap)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_sba_point_xyz, VtxRn<3>)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_cam, VtxCam)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_intrinsics, VtxIntrinsics)
G2O_TRIAL_RETRACT_ENTRIES(g2o_trial_retract_bal_camera, VtxRn<9>)

G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2, LinSE2)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_xy, LinSE2XY)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_bearing, LinSE2Bearing)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_prior, LinSE2Prior)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_prior_xy, LinSE2PriorXY)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_xy_calib, LinSE2XYCalib)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_offset, LinSE2Offset)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se2_xy_offset, LinSE2XYOffset)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3, LinSE3)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_xyz, LinSE3XYZ)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_depth, LinSE3Depth)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_disparity, LinSE3Disparity)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_prior, LinSE3Prior)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_offset, LinSE3Offset)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_se3_expmap, LinSE3Expmap)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_xyz2uv, LinXYZ2UV)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_xyz2uvu, LinXYZ2UVU)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_psi2uv, LinPSI2UV)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_p2mc, LinP2MC)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_p2mc_intrinsics, LinP2MCIntrinsics)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_p2sc, LinP2SC)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_sba_cam, LinSBACam)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_sba_scale, LinSBAScale)
G2O_TRIAL_CHI2_ENTRIES(g2o_trial_chi2_bal, LinBAL)

int g2o_chi2_sum_f32(const float* partials, int n, float* out, void* stream) {
  return g2o_torch::launch_chi2_sum<float>(partials, n, out,
                                           static_cast<cudaStream_t>(stream));
}
int g2o_chi2_sum_f64(const double* partials, int n, double* out,
                     void* stream) {
  return g2o_torch::launch_chi2_sum<double>(
      partials, n, out, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
