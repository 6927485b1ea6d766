// K7 on the dense GN / LM routes, the dual-ELL Schur trial and the general
// Schur trial: one trial's candidate and its robust chi2, for every vertex
// and edge type openslam_g2o_torch.models registers.
//
// Replaces `apply_update_parts` (openslam_g2o_tpu/core/problem.py:557-570),
// `apply_update` (:572-585) and `robust_chi2` (:321-329) over `edge_chi2`
// (:302) and `compute_errors` (:288), which XLA fused into the trial
// program and which, run op by op, are one torch launch per step of each
// vertex type's retraction and each edge type's error. Here a trial's
// outcome is 1 + ceil(vertex groups / 8) + (edge groups) launches:
//
//   trial_retract_groups<T>  the retraction of every vertex group
//                          of a trial, a table of up to kRetractMaxGroups
//                          groups in the launch parameters (type id,
//                          tables and strides, n, first block, first
//                          partial): a block finds its group from the
//                          prefix of the groups' blocks and switches on
//                          the type id (uniform in the block) to its
//                          V::retract; a thread per vertex: cand =
//                          retract(x, dx * free) (a fixed vertex too, by
//                          a zero step, which renormalizes a stored
//                          quaternion and wraps an angle, as JAX's
//                          vmap(retract) over the masked step does); with
//                          b given, per-block partial sums of
//                          dx . (lambda dx + b), each at the place the
//                          group's own launch would put it. The types of
//                          more than 3 stored values stage x and the
//                          candidate through shared memory with coalesced
//                          loads and stores.
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
// Bound: memory. The retraction moves P + 2D + 1 values in and P out per
// vertex: under 3 us at 50,000 vertices against a few us of launch
// latency, so the launches a trial saves are what counts (one a group
// beyond the first); trial_edge_chi2 reads the edge's measurement, Omega,
// delta, parameter data, indices and gathered vertices. At the
// 400,000-edge BA scene in float32 that is about 21 MB per trial, 6.4 us at
// 3.35 TB/s.
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

// One vertex group of trial_retract_groups: its type id (kRetract* below,
// kernels/trial.py RETRACT_IDS), tables, the group's first block in the
// launch and its first partial in part_dot.
template <typename T>
struct RetractGroup {
  const T* x;                        // [N, kP]
  const T* dx;                       // (v, k) at dx[v * dx_v + k * dx_k]
  long long dx_v, dx_k;
  const T* b;                        // likewise; null: no dot product
  long long b_v, b_k;
  const T* free_mask;                // [N]
  T* cand;                           // [N, kP]
  int type, n, block0, part0;
};

constexpr int kRetractMaxGroups = 8;       // trial.MAX_RETRACT_GROUPS
constexpr int kRetractMaxP = 12;           // the widest stored vertex (cam)

template <typename T>
struct RetractGroups {
  RetractGroup<T> g[kRetractMaxGroups];
  const T* lam;                      // 0-dim
  T* part_dot;                       // null: no dot product
  int n_groups;
};

enum RetractType {
  kRetractSE2 = 0, kRetractPointXY = 1, kRetractSE3 = 2,
  kRetractPointXYZ = 3, kRetractSE3Expmap = 4, kRetractSBAPoint = 5,
  kRetractCam = 6, kRetractIntrinsics = 7, kRetractBALCamera = 8,
  kRetractTypes = 9
};

// Types of more than kRetractDirectP stored values stage x and the
// candidate through shared memory; the narrower ones (se2, point_xy,
// point_xyz, the SBA point) read and write them directly. On an H100
// (chip_smoke.py phase 3, 50,000 vertices) staging took a narrow type
// longer (point_xyz, float64: 4.12 against 3.38 us) and a wide one 2.1-2.3x
// less time (cam; PERF.md section 6).
constexpr int kRetractDirectP = 3;

// Block `blk` of group G: a thread per vertex, cand = retract(x, dx *
// free) and the block's partial of dx . (lambda dx + b).
template <class V, typename T>
__device__ __forceinline__ void retract_group_block(
    const RetractGroup<T>& G, const T* __restrict__ lam,
    T* __restrict__ part_dot, int blk, T* sx, T* smem) {
  constexpr bool kStaged = V::kP > kRetractDirectP;
  const long long v0 = blk * static_cast<long long>(kThreads);
  const int cnt = static_cast<int>(G.n - v0 < kThreads ? G.n - v0
                                                       : kThreads);
  const bool dot = part_dot != nullptr;
  const int i = threadIdx.x;
  const long long v = v0 + i;
  // the step, gradient and mask first, so that their loads are in flight
  // with the staging of x
  T f = T(0), d[V::kD], bv[V::kD];
  if (i < cnt) {
    f = G.free_mask[v];
#pragma unroll
    for (int k = 0; k < V::kD; ++k) {
      d[k] = G.dx[v * G.dx_v + k * G.dx_k];
      bv[k] = dot ? G.b[v * G.b_v + k * G.b_k] : T(0);
    }
  }
  const int vals = cnt * V::kP;
  if constexpr (kStaged) {
    const T* __restrict__ xs = G.x + v0 * V::kP;
    for (int j = threadIdx.x; j < vals; j += kThreads) sx[j] = xs[j];
    __syncthreads();
  }
  T local = T(0);
  if (i < cnt) {
    const T l = dot ? *lam : T(0);
    T x[V::kP], step[V::kD], moved[V::kP];
#pragma unroll
    for (int k = 0; k < V::kP; ++k)
      x[k] = kStaged ? sx[i * V::kP + k] : G.x[v * V::kP + k];
#pragma unroll
    for (int k = 0; k < V::kD; ++k) {
      if (dot) local += d[k] * (l * d[k] + bv[k]);
      step[k] = d[k] * f;
    }
    V::retract(x, step, moved);
    // a thread rewrites only the values it read itself
#pragma unroll
    for (int k = 0; k < V::kP; ++k) {
      if constexpr (kStaged)
        sx[i * V::kP + k] = moved[k];
      else
        G.cand[v * V::kP + k] = moved[k];
    }
  }
  if constexpr (kStaged) {
    __syncthreads();
    T* __restrict__ cs = G.cand + v0 * V::kP;
    for (int j = threadIdx.x; j < vals; j += kThreads) cs[j] = sx[j];
  }
  if (dot) {                         // uniform over the grid
    const T total = block_sum(local, smem);
    if (threadIdx.x == 0) part_dot[G.part0 + blk] = total;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
trial_retract_groups_kernel(const RetractGroups<T> a) {
  __shared__ T smem[32];
  __shared__ T sx[kThreads * kRetractMaxP];
  int gi = 0;
  while (gi + 1 < a.n_groups
         && static_cast<int>(blockIdx.x) >= a.g[gi + 1].block0)
    ++gi;
  const RetractGroup<T>& G = a.g[gi];
  const int blk = static_cast<int>(blockIdx.x) - G.block0;
  switch (G.type) {
    case kRetractSE2:
      retract_group_block<VtxSE2, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
    case kRetractPointXY:
      retract_group_block<VtxRn<2>, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
    case kRetractSE3:
      retract_group_block<VtxSE3, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
    case kRetractPointXYZ:
    case kRetractSBAPoint:
      retract_group_block<VtxRn<3>, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
    case kRetractSE3Expmap:
      retract_group_block<VtxSE3Expmap, T>(G, a.lam, a.part_dot, blk, sx,
                                           smem);
      break;
    case kRetractCam:
      retract_group_block<VtxCam, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
    case kRetractIntrinsics:
      retract_group_block<VtxIntrinsics, T>(G, a.lam, a.part_dot, blk, sx,
                                            smem);
      break;
    default:                         // kRetractBALCamera
      retract_group_block<VtxRn<9>, T>(G, a.lam, a.part_dot, blk, sx, smem);
      break;
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

// desc: kRetractGroupWords words per group (type, x, dx, dx_v, dx_k, b,
// b_v, b_k, free, cand, n, block0, part0: RetractGroup), block0 the
// prefix of trial_blocks(n) over the launch's groups, starting at 0.
constexpr int kRetractGroupWords = 13;

template <typename T>
int launch_trial_retract_groups(const long long* desc, int n_groups,
                                int n_blocks, const T* lam, T* part_dot,
                                cudaStream_t stream) {
  if (n_groups < 1 || n_groups > kRetractMaxGroups || n_blocks < 1
      || (part_dot != nullptr && lam == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  RetractGroups<T> a = {};
  a.n_groups = n_groups;
  a.lam = lam;
  a.part_dot = part_dot;
  int blocks = 0;
  for (int i = 0; i < n_groups; ++i) {
    const long long* w = desc + i * kRetractGroupWords;
    RetractGroup<T>& G = a.g[i];
    G.type = static_cast<int>(w[0]);
    G.x = reinterpret_cast<const T*>(w[1]);
    G.dx = reinterpret_cast<const T*>(w[2]);
    G.dx_v = w[3];
    G.dx_k = w[4];
    G.b = reinterpret_cast<const T*>(w[5]);
    G.b_v = w[6];
    G.b_k = w[7];
    G.free_mask = reinterpret_cast<const T*>(w[8]);
    G.cand = reinterpret_cast<T*>(w[9]);
    G.n = static_cast<int>(w[10]);
    G.block0 = static_cast<int>(w[11]);
    G.part0 = static_cast<int>(w[12]);
    if (G.type < 0 || G.type >= kRetractTypes || G.n < 0
        || G.block0 != blocks || G.part0 < 0
        || (part_dot != nullptr && G.b == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    blocks += static_cast<int>(trial_blocks(G.n));
  }
  if (blocks != n_blocks) return static_cast<int>(cudaErrorInvalidValue);
  trial_retract_groups_kernel<T><<<n_blocks, kThreads, 0, stream>>>(a);
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

// One entry pair per edge type (kernels/trial.py CHI2, K17's functor list),
// with the prefix g2o_; the retraction over every vertex group; chi2_sum.
extern "C" {

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

int g2o_trial_retract_groups_f32(const long long* desc, int n_groups,
                                 int n_blocks, const float* lam,
                                 float* part_dot, void* stream) {
  return g2o_torch::launch_trial_retract_groups<float>(
      desc, n_groups, n_blocks, lam, part_dot,
      static_cast<cudaStream_t>(stream));
}
int g2o_trial_retract_groups_f64(const long long* desc, int n_groups,
                                 int n_blocks, const double* lam,
                                 double* part_dot, void* stream) {
  return g2o_torch::launch_trial_retract_groups<double>(
      desc, n_groups, n_blocks, lam, part_dot,
      static_cast<cudaStream_t>(stream));
}

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
