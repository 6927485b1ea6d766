// The edge functors of every edge type openslam_g2o_torch.models registers:
// per type its slot widths, parameter strides, the retraction of each slot
// and the error, each templated on the slots' scalar types (T, or a Jet of
// T for forward mode). Shared by K17's linearizers (edge_lin.cu), which
// differentiate the error through the retractions, and K7's trial chi2
// (trial.cu), which evaluates the error at the candidate, so that the
// residual a trial is judged by is the residual the system was linearized
// with. EDGE_SE2 and the XYZ2UV / XYZ2UVU projections also carry their
// closed-form Jacobians (`lin`) beside the error.
#pragma once

#include "se2_edge.cuh"
#include "se2_jet.cuh"
#include "xyz2uv.cuh"

namespace g2o_torch {

constexpr int kMaxSlots = 3;
constexpr int kMaxUsed = 12;         // parameters a slot reads, at most
constexpr int kMaxPdata = 14;        // parameter data an edge reads, at most

// ---------------------------------------------------------------------------
// The edge functors: slot widths, parameter strides, retractions per slot
// and the error, each templated on the slots' scalar types. kPdata and
// kPdata2 are the widths of the edge's first and second parameter slot;
// the kernel hands the error both, one after the other, in `pd`.
// ---------------------------------------------------------------------------

struct LinForward {
  static constexpr bool kAnalytic = false;
  static constexpr int kPdata = 0, kPdata2 = 0;
};

// The SBACam retraction of the whole VERTEX_CAM record: cam_retract on the
// pose, the intrinsics (fx, fy, cx, cy, baseline) carried as constants
template <typename X, typename D>
__device__ __forceinline__ void cam_retract_all(const X* x, const D* d,
                                                mix_t<X, D>* o) {
  cam_retract(x, d, o);
  for (int k = 7; k < 12; ++k) o[k] = x[k];
}

// EDGE_SE3:QUAT (models/slam3d.py _edge_se3_error):
// toVectorMQT(Z^-1 Xi^-1 Xj); slots se3, se3.
struct LinSE3 : LinForward {
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
struct LinSE3XYZ : LinForward {
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
struct LinP2MCIntrinsics : LinForward {
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
struct LinPSI2UV : LinForward {
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

// --- models/slam2d.py ------------------------------------------------------

// EDGE_SE2_XY (slam2d.py _edge_se2_xy_error): X^-1 l - z; slots se2,
// point_xy.
struct LinSE2XY : LinForward {
  static constexpr int kSlots = 2, kD = 2, kMeas = 2;
  __host__ __device__ static constexpr int dim(int s) { return s ? 2 : 3; }
  __host__ __device__ static constexpr int stride(int s) { return dim(s); }
  __host__ __device__ static constexpr int used(int s) { return dim(s); }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 0)
      se2_retract(x, d, o);
    else
      rn_retract<2>(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* l, const T* meas,
                               const T*, mix_t<A, B>* err) {
    se2_point_in(x, l, err);
    for (int k = 0; k < 2; ++k) err[k] = err[k] - meas[k];
  }
};

// EDGE_BEARING_SE2_XY (slam2d.py _edge_se2_bearing_error):
// normalize_angle(atan2(d.y, d.x) - z), d = X^-1 l; slots se2, point_xy.
struct LinSE2Bearing : LinSE2XY {
  static constexpr int kD = 1, kMeas = 1;
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* l, const T* meas,
                               const T*, mix_t<A, B>* err) {
    mix_t<A, B> d[2];
    se2_point_in(x, l, d);
    err[0] = wrap_angle(datan2(d[1], d[0]) - meas[0]);
  }
};

// EDGE_PRIOR_SE2 (slam2d.py _edge_se2_prior_error): Z^-1 X; slot se2.
struct LinSE2Prior : LinForward {
  static constexpr int kSlots = 1, kD = 3, kMeas = 3;
  __host__ __device__ static constexpr int dim(int) { return 3; }
  __host__ __device__ static constexpr int stride(int) { return 3; }
  __host__ __device__ static constexpr int used(int) { return 3; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    se2_retract(x, d, o);
  }
  template <typename T, typename A>
  __device__ static void error(const A* x, const T* meas, const T*, A* err) {
    T zinv[3];
    se2_inverse(meas, zinv);
    se2_compose(zinv, x, err);
  }
};

// EDGE_PRIOR_SE2_XY (slam2d.py _edge_prior_se2_xy_error): X.t - z; slot
// se2.
struct LinSE2PriorXY : LinSE2Prior {
  static constexpr int kD = 2, kMeas = 2;
  template <typename T, typename A>
  __device__ static void error(const A* x, const T* meas, const T*, A* err) {
    for (int k = 0; k < 2; ++k) err[k] = x[k] - meas[k];
  }
};

// EDGE_SE2_XY_CALIB (slam2d.py _edge_se2_xy_calib_error): (X C)^-1 l - z
// with the calibration pose C a vertex; slots se2, point_xy, se2.
struct LinSE2XYCalib : LinForward {
  static constexpr int kSlots = 3, kD = 2, kMeas = 2;
  __host__ __device__ static constexpr int dim(int s) {
    return s == 1 ? 2 : 3;
  }
  __host__ __device__ static constexpr int stride(int s) { return dim(s); }
  __host__ __device__ static constexpr int used(int s) { return dim(s); }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 1)
      rn_retract<2>(x, d, o);
    else
      se2_retract(x, d, o);
  }
  template <typename T, typename A, typename B, typename C>
  __device__ static void error(const A* x, const B* l, const C* calib,
                               const T* meas, const T*,
                               mix3_t<A, B, C>* err) {
    mix_t<A, C> sensor[3];
    se2_compose(x, calib, sensor);
    se2_point_in(sensor, l, err);
    for (int k = 0; k < 2; ++k) err[k] = err[k] - meas[k];
  }
};

// EDGE_SE2_OFFSET (slam2d.py _edge_se2_offset_error): Z^-1 ((Xi Oi)^-1
// (Xj Oj)); slots se2, se2; the two se2_offset parameters per edge in pd
// (Oi at pd[0..3), Oj at pd[3..6)).
struct LinSE2Offset : LinForward {
  static constexpr int kSlots = 2, kD = 3, kMeas = 3, kPdata = 3,
                       kPdata2 = 3;
  __host__ __device__ static constexpr int dim(int) { return 3; }
  __host__ __device__ static constexpr int stride(int) { return 3; }
  __host__ __device__ static constexpr int used(int) { return 3; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    se2_retract(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* xi, const B* xj, const T* meas,
                               const T* pd, mix_t<A, B>* err) {
    A si[3], si_inv[3];
    B sj[3];
    T zinv[3];
    mix_t<A, B> rel[3];
    se2_compose(xi, pd, si);
    se2_compose(xj, pd + 3, sj);
    se2_inverse(meas, zinv);
    se2_inverse(si, si_inv);
    se2_compose(si_inv, sj, rel);
    se2_compose(zinv, rel, err);
  }
};

// EDGE_SE2_POINTXY_OFFSET (slam2d.py _edge_se2_pointxy_offset_error):
// (X O)^-1 l - z; slots se2, point_xy; the se2_offset O per edge in pd.
struct LinSE2XYOffset : LinSE2XY {
  static constexpr int kPdata = 3;
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* l, const T* meas,
                               const T* off, mix_t<A, B>* err) {
    A sensor[3];
    se2_compose(x, off, sensor);
    se2_point_in(sensor, l, err);
    for (int k = 0; k < 2; ++k) err[k] = err[k] - meas[k];
  }
};

// --- models/slam3d.py ------------------------------------------------------

// EDGE_PROJECT_DEPTH (slam3d.py _edge_se3_depth_error, _project_w2i):
// p = K (X O)^-1 pt, (p.x / p.z, p.y / p.z, p.z) - z; slots se3,
// point_xyz; the camera_calib (O = (t, q), fx, fy, cx, cy) per edge in pd.
struct LinSE3Depth : LinSE3XYZ {
  static constexpr int kPdata = 11;
  template <typename T, typename A, typename B>
  __device__ static void project(const A* x, const B* pt, const T* cam,
                                 mix_t<A, B>* p) {
    A n2w[7], w2n[7];
    mix_t<A, B> pc[3];
    se3_compose(x, cam, n2w);
    se3_inverse(n2w, w2n);
    se3_apply(w2n, pt, pc);
    p[0] = cam[7] * pc[0] + cam[9] * pc[2];
    p[1] = cam[8] * pc[1] + cam[10] * pc[2];
    p[2] = pc[2];
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* pt, const T* meas,
                               const T* cam, mix_t<A, B>* err) {
    mix_t<A, B> p[3];
    project(x, pt, cam, p);
    err[0] = p[0] / p[2] - meas[0];
    err[1] = p[1] / p[2] - meas[1];
    err[2] = p[2] - meas[2];
  }
};

// EDGE_PROJECT_DISPARITY (slam3d.py _edge_se3_disparity_error): (p.x / p.z,
// p.y / p.z, 1 / p.z) - z with p as EDGE_PROJECT_DEPTH's.
struct LinSE3Disparity : LinSE3Depth {
  template <typename T, typename A, typename B>
  __device__ static void error(const A* x, const B* pt, const T* meas,
                               const T* cam, mix_t<A, B>* err) {
    mix_t<A, B> p[3];
    project(x, pt, cam, p);
    err[0] = p[0] / p[2] - meas[0];
    err[1] = p[1] / p[2] - meas[1];
    err[2] = T(1) / p[2] - meas[2];
  }
};

// EDGE_SE3_PRIOR (slam3d.py _edge_se3_prior_error): toVectorMQT(Z^-1 (X
// O)); slot se3; the se3_offset O per edge in pd.
struct LinSE3Prior : LinForward {
  static constexpr int kSlots = 1, kD = 6, kMeas = 7, kPdata = 7;
  __host__ __device__ static constexpr int dim(int) { return 6; }
  __host__ __device__ static constexpr int stride(int) { return 7; }
  __host__ __device__ static constexpr int used(int) { return 7; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    se3_retract_mqt(x, d, o);
  }
  template <typename T, typename A>
  __device__ static void error(const A* x, const T* meas, const T* off,
                               A* err) {
    A n2w[7], d[7];
    T zinv[7];
    se3_compose(x, off, n2w);
    se3_inverse(meas, zinv);
    se3_compose(zinv, n2w, d);
    se3_to_mqt(d, err);
  }
};

// EDGE_SE3_OFFSET (slam3d.py _edge_se3_offset_error): toVectorMQT(Z^-1
// (Xi Oi)^-1 (Xj Oj)); slots se3, se3; Oi at pd[0..7), Oj at pd[7..14).
struct LinSE3Offset : LinSE3 {
  static constexpr int kPdata = 7, kPdata2 = 7;
  template <typename T, typename A, typename B>
  __device__ static void error(const A* xi, const B* xj, const T* meas,
                               const T* pd, mix_t<A, B>* err) {
    A si[7];
    B sj[7];
    T zinv[7];
    se3_compose(xi, pd, si);
    se3_compose(xj, pd + 7, sj);
    se3_inverse(meas, zinv);
    se3_error_mqt(zinv, si, sj, err);
  }
};

// --- models/sba.py ---------------------------------------------------------

// EDGE_SE3:EXPMAP (sba.py _edge_se3_expmap_error): log(T2^-1 Z T1), T
// world-to-camera; slots se3_expmap, se3_expmap.
struct LinSE3Expmap : LinForward {
  static constexpr int kSlots = 2, kD = 6, kMeas = 7;
  __host__ __device__ static constexpr int dim(int) { return 6; }
  __host__ __device__ static constexpr int stride(int) { return 7; }
  __host__ __device__ static constexpr int used(int) { return 7; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    se3_retract_expmap_left(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* t1, const B* t2, const T* meas,
                               const T*, mix_t<A, B>* err) {
    A zt1[7];
    B t2_inv[7];
    mix_t<A, B> p[7];
    se3_compose(meas, t1, zt1);
    se3_inverse(t2, t2_inv);
    se3_compose(t2_inv, zt1, p);
    se3_log(p, err);
  }
};

// EDGE_PROJECT_P2MC (sba.py _edge_p2mc_error, _cam_w2i_project): pc =
// R^T (p - t) of the camera-to-world VERTEX_CAM, ((fx pc.x + cx pc.z) /
// pc.z, (fy pc.y + cy pc.z) / pc.z) - z with the camera's own intrinsics;
// slots sba_point_xyz, cam (all 12 parameters: the pose retracted, the
// intrinsics carried).
struct LinP2MC : LinForward {
  static constexpr int kSlots = 2, kD = 2, kMeas = 2;
  __host__ __device__ static constexpr int dim(int s) { return s ? 6 : 3; }
  __host__ __device__ static constexpr int stride(int s) {
    return s ? 12 : 3;
  }
  __host__ __device__ static constexpr int used(int s) { return stride(s); }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    if constexpr (S == 1)
      cam_retract_all(x, d, o);
    else
      rn_retract<3>(x, d, o);
  }
  template <typename P, typename C>
  __device__ static void camera_point(const P* point, const C* cam,
                                      mix_t<P, C>* pc) {
    C qc[4] = {-cam[3], -cam[4], -cam[5], cam[6]};
    mix_t<P, C> d[3];
    for (int k = 0; k < 3; ++k) d[k] = point[k] - cam[k];
    quat_rotate(qc, d, pc);
  }
  template <typename T, typename P, typename C>
  __device__ static void error(const P* point, const C* cam, const T* meas,
                               const T*, mix_t<P, C>* err) {
    mix_t<P, C> pc[3];
    camera_point(point, cam, pc);
    err[0] = (cam[7] * pc[0] + cam[9] * pc[2]) / pc[2] - meas[0];
    err[1] = (cam[8] * pc[1] + cam[10] * pc[2]) / pc[2] - meas[1];
  }
};

// EDGE_PROJECT_P2SC (sba.py _edge_p2sc_error): P2MC's (u, v) and the right
// image's u, (fx (pc.x - baseline) + cx pc.z) / pc.z, minus z.
struct LinP2SC : LinP2MC {
  static constexpr int kD = 3, kMeas = 3;
  template <typename T, typename P, typename C>
  __device__ static void error(const P* point, const C* cam, const T* meas,
                               const T*, mix_t<P, C>* err) {
    mix_t<P, C> pc[3];
    camera_point(point, cam, pc);
    err[0] = (cam[7] * pc[0] + cam[9] * pc[2]) / pc[2] - meas[0];
    err[1] = (cam[8] * pc[1] + cam[10] * pc[2]) / pc[2] - meas[1];
    err[2] = (cam[7] * (pc[0] - cam[11]) + cam[9] * pc[2]) / pc[2]
             - meas[2];
  }
};

// --- models/bal.py ---------------------------------------------------------

// EDGE_PROJECT_BAL (bal.py _edge_bal_error, snavely_project): p = R(omega)
// x + t with R by so3_exp (its Taylor branch below theta^2 = 1e-12, where
// the derivative is jvp's), proj = -p.xy / p.z, f (1 + k1 r^2 + k2 r^4)
// proj - z; slots sba_point_xyz, bal_camera (omega, t, f, k1, k2: nine
// values, retracted additively).
struct LinBAL : LinForward {
  static constexpr int kSlots = 2, kD = 2, kMeas = 2;
  __host__ __device__ static constexpr int dim(int s) { return s ? 9 : 3; }
  __host__ __device__ static constexpr int stride(int s) { return dim(s); }
  __host__ __device__ static constexpr int used(int s) { return dim(s); }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    rn_retract<dim(S)>(x, d, o);
  }
  template <typename T, typename P, typename C>
  __device__ static void error(const P* point, const C* cam, const T* meas,
                               const T*, mix_t<P, C>* err) {
    typedef mix_t<P, C> R;
    C q[4];
    R p[3];
    so3_exp(cam, q);
    quat_rotate(q, point, p);
    for (int k = 0; k < 3; ++k) p[k] = p[k] + cam[3 + k];
    const R px = -p[0] / p[2], py = -p[1] / p[2];
    const R r2 = px * px + py * py;
    const R distortion = T(1) + cam[7] * r2 + cam[8] * r2 * r2;
    const R scale = cam[6] * distortion;
    err[0] = scale * px - meas[0];
    err[1] = scale * py - meas[1];
  }
};

// EDGE_CAM (sba.py _edge_sba_cam_error): toVectorMQT(Z^-1 C1^-1 C2) of the
// two cameras' (t, q); slots cam, cam.
struct LinSBACam : LinForward {
  static constexpr int kSlots = 2, kD = 6, kMeas = 7;
  __host__ __device__ static constexpr int dim(int) { return 6; }
  __host__ __device__ static constexpr int stride(int) { return 12; }
  __host__ __device__ static constexpr int used(int) { return 7; }
  template <int S, typename X, typename D>
  __device__ static void retract(const X* x, const D* d, mix_t<X, D>* o) {
    cam_retract(x, d, o);
  }
  template <typename T, typename A, typename B>
  __device__ static void error(const A* c1, const B* c2, const T* meas,
                               const T*, mix_t<A, B>* err) {
    T zinv[7];
    se3_inverse(meas, zinv);
    se3_error_mqt(zinv, c1, c2, err);
  }
};

// EDGE_SCALE (sba.py _edge_sba_scale_error): |c1 - c2| - z of the camera
// centers; slots cam, cam. Two equal centers give 0/0 in the derivative,
// as they do in the plain version.
struct LinSBAScale : LinSBACam {
  static constexpr int kD = 1, kMeas = 1;
  template <typename T, typename A, typename B>
  __device__ static void error(const A* c1, const B* c2, const T* meas,
                               const T*, mix_t<A, B>* err) {
    mix_t<A, B> d[3];
    for (int k = 0; k < 3; ++k) d[k] = c1[k] - c2[k];
    err[0] = dsqrt(d[0] * d[0] + d[1] * d[1] + d[2] * d[2]) - meas[0];
  }
};

// --- the analytic forms ----------------------------------------------------

struct LinAnalytic {
  static constexpr bool kAnalytic = true;
  static constexpr int kSlots = 2, kPdata2 = 0;
};

// EDGE_SE2 (slam2d.py _edge_se2_error, _edge_se2_jacobian): the error and
// closed-form Jacobians of kernel B (se2_edge.cuh); slots se2, se2.
struct LinSE2 : LinAnalytic {
  static constexpr int kD = 3, kMeas = 3, kPdata = 0;
  __host__ __device__ static constexpr int dim(int) { return 3; }
  __host__ __device__ static constexpr int stride(int) { return 3; }
  __host__ __device__ static constexpr int used(int) { return 3; }
  template <typename T>
  __device__ static void error(const T* xi, const T* xj, const T* z,
                               const T*, T* err) {
    T cz, sz, ci, si;
    se2_edge_error(xi[0], xi[1], xi[2], xj[0], xj[1], xj[2], z[0], z[1],
                   z[2], err, cz, sz, ci, si);
  }
  template <typename T>
  __device__ static void lin(const T* xi, const T* xj, const T* z, const T*,
                             T fi, T fj, T (&err)[3], T (&ji)[3][3],
                             T (&jj)[3][3]) {
    T cz, sz, ci, si, J[2][3][3];
    se2_edge_error(xi[0], xi[1], xi[2], xj[0], xj[1], xj[2], z[0], z[1],
                   z[2], err, cz, sz, ci, si);
    se2_edge_jacobians(xi[0], xi[1], xj[0], xj[1], cz, sz, ci, si, J);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        ji[a][b] = J[0][a][b] * fi;
        jj[a][b] = J[1][a][b] * fj;
      }
  }
};

// EDGE_PROJECT_XYZ2UV:EXPMAP (R = 2) and EDGE_PROJECT_XYZ2UVU:EXPMAP
// (R = 3) (sba.py _edge_xyz2uv_jacobian, _edge_xyz2uvu_jacobian): the
// closed form of K10's fused entry (xyz2uv.cuh); slots sba_point_xyz,
// se3_expmap; the camera parameters per edge in pd.
template <int R>
struct LinProject : LinAnalytic {
  static constexpr int kD = R, kMeas = R, kPdata = 4;
  __host__ __device__ static constexpr int dim(int s) { return s ? 6 : 3; }
  __host__ __device__ static constexpr int stride(int s) {
    return s ? 7 : 3;
  }
  __host__ __device__ static constexpr int used(int s) { return stride(s); }
  template <typename T>
  __device__ static void error(const T* p, const T* cam, const T* obs,
                               const T* camp, T* err) {
    T pc[3];
    xyz2uv_residual<T, R>(p[0], p[1], p[2], cam, camp, obs, err, pc);
  }
  template <typename T>
  __device__ static void lin(const T* p, const T* cam, const T* obs,
                             const T* camp, T fl, T fc, T (&err)[R],
                             T (&jl)[R][3], T (&jc)[R][6]) {
    xyz2uv_linearize<T, R>(p[0], p[1], p[2], cam, camp, obs, fl, fc, err,
                           jl, jc);
  }
};
using LinXYZ2UV = LinProject<2>;
using LinXYZ2UVU = LinProject<3>;

// The error of F on the slots' parameters x0, x1, x2 of whatever types
template <class F, typename T, typename A, typename B, typename C, typename O>
__device__ __forceinline__ void call_error(const A* x0, const B* x1,
                                           const C* x2, const T* meas,
                                           const T* pd, O* err) {
  if constexpr (F::kSlots == 1)
    F::error(x0, meas, pd, err);
  else if constexpr (F::kSlots == 2)
    F::error(x0, x1, meas, pd, err);
  else
    F::error(x0, x1, x2, meas, pd, err);
}

// The slots' parameters, the measurement and the parameter data of edge e,
// from any argument struct with the tables params[s], idx[s], meas and
// pdata[2] (K17's LinArgs, the trial chi2's ChiArgs)
template <class F, typename T, class Args>
__device__ __forceinline__ void load_edge(const Args& a, long long e,
                                          T (&x)[kMaxSlots][kMaxUsed],
                                          T* meas, T* pd) {
#pragma unroll
  for (int s = 0; s < F::kSlots; ++s) {
    const long long v = a.idx[s][e];
#pragma unroll
    for (int k = 0; k < F::used(s); ++k)
      x[s][k] = a.params[s][v * F::stride(s) + k];
  }
#pragma unroll
  for (int k = 0; k < F::kMeas; ++k) meas[k] = a.meas[e * F::kMeas + k];
#pragma unroll
  for (int k = 0; k < F::kPdata; ++k) pd[k] = a.pdata[0][e * F::kPdata + k];
#pragma unroll
  for (int k = 0; k < F::kPdata2; ++k)
    pd[F::kPdata + k] = a.pdata[1][e * F::kPdata2 + k];
}

template <class F>
__host__ __device__ constexpr int pd_size() {
  return F::kPdata + F::kPdata2 > 0 ? F::kPdata + F::kPdata2 : 1;
}

}  // namespace g2o_torch
