"""Bundle-adjustment types of the expmap family: world-to-camera SE3 poses,
marginalizable 3D points, the camera parameters and the projection and
pose-pose edges.

Counterpart of openslam_g2o_tpu/models/sba.py:48-68, :112-122 and :129-246
(g2o/types/sba, types_six_dof_expmap.cpp). Every function is batched on the
last axis (ops/lie.py): `vparams` holds one [..., P] tensor per slot, `meas`
is [..., M] and `pdata` one [..., 4] tensor (focal, cx, cy, baseline).

* VERTEX_SE3:EXPMAP stores the world-to-camera transform; the .g2o file
  carries camera-to-world (t, q), inverted on read and write
  (types_six_dof_expmap.cpp:88-104). oplus is a LEFT multiply by exp(xi),
  xi = (omega, upsilon) (types_six_dof_expmap.h:101-104).
* Projection edges are (point, camera): slot 0 is the point
  (types_six_dof_expmap.h:143-150). Both projection edges have analytic
  Jacobians; EDGE_SE3:EXPMAP is differentiated in forward mode.

The rest of the JAX module (:71-106, :249-402) follows: the SBACam
family and the anchored inverse-depth edge, every one of them
differentiated in forward mode (core/problem.py `forward_jacobians`), as
the JAX package differentiates them with jacfwd.

* VERTEX_CAM (SBACam) stores the camera-to-world pose (t, q) and the
  intrinsics (fx, fy, cx, cy, baseline), as the file does; projection is
  K [R^T | -R^T t] (sbacam.h:120-159). oplus adds the translation and
  post-multiplies the compact quaternion update (sbacam.h:101-117).
* VERTEX_INTRINSICS optimizes (fx, fy, cx, cy) additively; the baseline
  stays (types_sba.h:106-120).
* EDGE_PROJECT_PSI2UV:EXPMAP is the ternary anchored inverse-depth edge
  (psi, observing camera, anchor camera; types_six_dof_expmap.cpp:
  173-183). The reference registers no file tag for it; the JAX package
  assigns this one, and so does the port.
"""
from __future__ import annotations

import numpy as np
import torch

from openslam_g2o_torch.core.registry import (
    EdgeType, ParameterType, VertexType, register_edge_type,
    register_parameter_type, register_vertex_type)
from openslam_g2o_torch.ops import lie
from openslam_g2o_torch.utils import np_lie


def _rn_retract(params, delta):
    return params + delta


def _se3_file_to_w2c(v):
    """File (t, q) is camera-to-world; the estimate is world-to-camera
    (types_six_dof_expmap.cpp:92-94). An involution, so it also writes."""
    return np_lie.se3_inverse(np.asarray(v, dtype=np.float64))


VERTEX_SE3_EXPMAP = register_vertex_type(VertexType(
    name="se3_expmap",
    tag="VERTEX_SE3:EXPMAP",
    ambient_dim=7,
    tangent_dim=6,
    retract=lie.se3_retract_expmap_left,
    origin=lambda dtype: lie.se3_identity(dtype),
    file_dim=7,
    from_file=_se3_file_to_w2c,
    to_file=_se3_file_to_w2c,
))

VERTEX_SBA_XYZ = register_vertex_type(VertexType(
    name="sba_point_xyz",
    tag="VERTEX_XYZ",
    ambient_dim=3,
    tangent_dim=3,
    retract=_rn_retract,
    origin=lambda dtype: torch.zeros(3, dtype=dtype),
    marginalizable=True,
))

PARAMS_CAMERA = register_parameter_type(ParameterType(
    name="camera_parameters",
    tag="PARAMS_CAMERAPARAMETERS",
    dim=4,                            # focal, cx, cy, baseline
))


def cam_map(p, focal, cx, cy):
    """CameraParameters::cam_map (types_six_dof_expmap.cpp:69-76):
    f * p.xy / p.z + c, [..., 2]."""
    z = p[..., 2]
    return torch.stack([p[..., 0] / z * focal + cx,
                        p[..., 1] / z * focal + cy], dim=-1)


def _edge_se3_expmap_error(vparams, meas, pdata):
    """EdgeSE3Expmap: log(T2^-1 * Z * T1), T world-to-camera
    (types_six_dof_expmap.h:120-127); the measurement is (t, q) of Z."""
    t1, t2 = vparams
    err = lie.se3_compose(lie.se3_inverse(t2), lie.se3_compose(meas, t1))
    return lie.se3_log(err)


EDGE_SE3_EXPMAP = register_edge_type(EdgeType(
    name="edge_se3_expmap",
    tag="EDGE_SE3:EXPMAP",
    vertex_types=("se3_expmap", "se3_expmap"),
    error_dim=6,
    measurement_dim=7,
    error=_edge_se3_expmap_error,
))


def _edge_xyz2uv_error(vparams, meas, pdata):
    """EdgeProjectXYZ2UV: obs - cam_map(T_w2c * point)
    (types_six_dof_expmap.h:143-150)."""
    point, t_w2c = vparams
    (cam,) = pdata
    pc = lie.se3_apply(t_w2c, point)
    return meas - cam_map(pc, cam[..., 0], cam[..., 1], cam[..., 2])


def _rotation_columns(q, like):
    """R(q) as [..., 3, 3] whose column k is quat_rotate(q, e_k), as the
    JAX Jacobians build it."""
    eye = torch.eye(3, dtype=like.dtype, device=like.device)
    return torch.stack([lie.quat_rotate(q, eye[k].expand_as(like))
                        for k in range(3)], dim=-1)


def _projection_jacobians(de_dpc, pc, t, point):
    """(J_point, J_cam) from de/dpc [..., r, 3]: J_point = de/dpc R(T),
    J_cam = [de/dpc (-[pc]x) | de/dpc] (omega | upsilon)."""
    Jp = de_dpc @ _rotation_columns(t[..., 3:7], point)
    Jc_omega = -de_dpc @ lie.skew(pc)
    return Jp, torch.cat([Jc_omega, de_dpc], dim=-1)


def xyz2uv_de_dpc(pc, f):
    """-f [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]], [..., 2, 3]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / z
    fiz = f * iz
    zero = torch.zeros_like(z)
    return -torch.stack([torch.stack([fiz, zero, -fiz * x * iz], dim=-1),
                         torch.stack([zero, fiz, -fiz * y * iz], dim=-1)],
                        dim=-2)


def _edge_xyz2uv_jacobian(vparams, meas, pdata):
    """Analytic linearizeOplus of EdgeProjectXYZ2UV
    (types_six_dof_expmap.cpp:90-115; openslam_g2o_tpu/models/sba.py:
    156-185): with pc = T_w2c * p,
        de/dpc  = -f [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
        J_point = de/dpc R(T),  J_cam = [de/dpc (-[pc]x) | de/dpc]."""
    point, t = vparams
    (cam,) = pdata
    pc = lie.se3_apply(t, point)
    return _projection_jacobians(xyz2uv_de_dpc(pc, cam[..., 0]), pc, t, point)


EDGE_PROJECT_XYZ2UV = register_edge_type(EdgeType(
    name="edge_project_xyz2uv",
    tag="EDGE_PROJECT_XYZ2UV:EXPMAP",
    vertex_types=("sba_point_xyz", "se3_expmap"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_xyz2uv_error,
    jacobian=_edge_xyz2uv_jacobian,
    param_types=("camera_parameters",),
))


def _edge_xyz2uvu_error(vparams, meas, pdata):
    """EdgeProjectXYZ2UVU (stereo): obs - (cam_map(T p), u_right)
    (types_six_dof_expmap.h:191-198, cpp:77-82)."""
    point, t_w2c = vparams
    (cam,) = pdata
    pc = lie.se3_apply(t_w2c, point)
    uv = cam_map(pc, cam[..., 0], cam[..., 1], cam[..., 2])
    u_right = (pc[..., 0] - cam[..., 3]) / pc[..., 2] * cam[..., 0] \
        + cam[..., 1]
    return meas - torch.cat([uv, u_right[..., None]], dim=-1)


def _edge_xyz2uvu_jacobian(vparams, meas, pdata):
    """Analytic linearizeOplus of the stereo EdgeProjectXYZ2UVU
    (openslam_g2o_tpu/models/sba.py:209-236): rows 1-2 as XYZ2UV, the third
    row d u_right / d pc = f [1/z, 0, -(x - b)/z^2]."""
    point, t = vparams
    (cam,) = pdata
    f, b = cam[..., 0], cam[..., 3]
    pc = lie.se3_apply(t, point)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    iz = 1.0 / z
    fiz = f * iz
    zero = torch.zeros_like(z)
    de_dpc = -torch.stack([
        torch.stack([fiz, zero, -fiz * x * iz], dim=-1),
        torch.stack([zero, fiz, -fiz * y * iz], dim=-1),
        torch.stack([fiz, zero, -fiz * (x - b) * iz], dim=-1)], dim=-2)
    return _projection_jacobians(de_dpc, pc, t, point)


EDGE_PROJECT_XYZ2UVU = register_edge_type(EdgeType(
    name="edge_project_xyz2uvu",
    tag="EDGE_PROJECT_XYZ2UVU:EXPMAP",
    vertex_types=("sba_point_xyz", "se3_expmap"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_xyz2uvu_error,
    jacobian=_edge_xyz2uvu_jacobian,
    param_types=("camera_parameters",),
))


# ---------------------------------------------------------------------------
# Anchored inverse depth
# ---------------------------------------------------------------------------

def invert_depth(psi):
    """psi = (u, v, rho) -> the 3D point (u, v, 1) / rho in the anchor frame
    (types_six_dof_expmap.cpp:166-171)."""
    return torch.stack([psi[..., 0], psi[..., 1],
                        torch.ones_like(psi[..., 2])], dim=-1) / psi[..., 2:3]


def depth_to_psi(point_anchor):
    """Inverse of invert_depth: an anchor-frame point -> (u, v, rho)."""
    return torch.stack([point_anchor[..., 0], point_anchor[..., 1],
                        torch.ones_like(point_anchor[..., 2])],
                       dim=-1) / point_anchor[..., 2:3]


def _edge_psi2uv_error(vparams, meas, pdata):
    """EdgeProjectPSI2UV: obs - cam_map(T_p_w T_anchor_w^-1
    invert_depth(psi)) (types_six_dof_expmap.cpp:173-183). Slots: psi
    (marginalizable), observing camera, anchor camera."""
    psi, t_w2c, t_anchor = vparams
    (cam,) = pdata
    pw = lie.se3_apply(lie.se3_inverse(t_anchor), invert_depth(psi))
    pc = lie.se3_apply(t_w2c, pw)
    return meas - cam_map(pc, cam[..., 0], cam[..., 1], cam[..., 2])


EDGE_PROJECT_PSI2UV = register_edge_type(EdgeType(
    name="edge_project_psi2uv",
    tag="EDGE_PROJECT_PSI2UV:EXPMAP",
    vertex_types=("sba_point_xyz", "se3_expmap", "se3_expmap"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_psi2uv_error,
    param_types=("camera_parameters",),
))


# ---------------------------------------------------------------------------
# The SBACam family
# ---------------------------------------------------------------------------

def _cam_retract(params, delta):
    """SBACam::update (sbacam.h:101-117): t += dt, q <- normalize(q dq)
    with dq from the compact update; the intrinsics (last 5) stay."""
    t = params[..., :3] + delta[..., :3]
    dq = lie.quat_from_compact(delta[..., 3:6])
    q = lie.quat_normalize(lie.quat_mul(params[..., 3:7], dq))
    return torch.cat([t, q, params[..., 7:12]], dim=-1)


VERTEX_CAM = register_vertex_type(VertexType(
    name="cam",
    tag="VERTEX_CAM",
    ambient_dim=12,                   # t(3), q(4), fx, fy, cx, cy, baseline
    tangent_dim=6,
    retract=_cam_retract,
    origin=lambda dtype: torch.tensor(
        [0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0], dtype=dtype),
    file_dim=12,
))


def _intrinsics_retract(params, delta):
    """VertexIntrinsics (types_sba.h:106-120): (fx, fy, cx, cy) additive,
    the baseline fixed."""
    return torch.cat([params[..., :4] + delta, params[..., 4:]], dim=-1)


VERTEX_INTRINSICS = register_vertex_type(VertexType(
    name="intrinsics",
    tag="VERTEX_INTRINSICS",
    ambient_dim=5,                    # fx, fy, cx, cy, baseline
    tangent_dim=4,
    retract=_intrinsics_retract,
    origin=lambda dtype: torch.tensor([1, 1, 0.5, 0.5, 0.1], dtype=dtype),
))


def _cam_w2i_project(cam_params, point):
    """A world point through an SBACam, K [R^T | -R^T t] (sbacam.h:120-159,
    types_sba.h:176-181): ((u, v) [..., 2], pc [..., 3])."""
    t, q = cam_params[..., :3], cam_params[..., 3:7]
    fx, fy = cam_params[..., 7], cam_params[..., 8]
    cx, cy = cam_params[..., 9], cam_params[..., 10]
    pc = lie.quat_rotate(lie.quat_conj(q), point - t)   # R^T (p - t)
    u = fx * pc[..., 0] + cx * pc[..., 2]
    v = fy * pc[..., 1] + cy * pc[..., 2]
    return torch.stack([u / pc[..., 2], v / pc[..., 2]], dim=-1), pc


def _edge_p2mc_error(vparams, meas, pdata):
    """EdgeProjectP2MC: (w2i p).xy / z - obs (types_sba.h:170-192)."""
    point, cam = vparams
    uv, _ = _cam_w2i_project(cam, point)
    return uv - meas


EDGE_PROJECT_P2MC = register_edge_type(EdgeType(
    name="edge_project_p2mc",
    tag="EDGE_PROJECT_P2MC",
    vertex_types=("sba_point_xyz", "cam"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_p2mc_error,
))


def _edge_p2mc_intrinsics_error(vparams, meas, pdata):
    """EdgeProjectP2MC_Intrinsics (types_sba.h:256-281): the monocular
    projection through the shared intrinsics vertex (fx, fy, cx, cy), so
    that the forward-mode Jacobian has the reference's dfx/dfy/dcx/dcy
    columns (types_sba.cpp:418-500)."""
    point, cam, intr = vparams
    t, q = cam[..., :3], cam[..., 3:7]
    pc = lie.quat_rotate(lie.quat_conj(q), point - t)   # R^T (p - t)
    u = (intr[..., 0] * pc[..., 0] + intr[..., 2] * pc[..., 2]) / pc[..., 2]
    v = (intr[..., 1] * pc[..., 1] + intr[..., 3] * pc[..., 2]) / pc[..., 2]
    return torch.stack([u, v], dim=-1) - meas


EDGE_PROJECT_P2MC_INTRINSICS = register_edge_type(EdgeType(
    name="edge_project_p2mc_intrinsics",
    tag="EDGE_PROJECT_P2MC_INTRINSICS",
    vertex_types=("sba_point_xyz", "cam", "intrinsics"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_p2mc_intrinsics_error,
))


def _edge_p2sc_error(vparams, meas, pdata):
    """EdgeProjectP2SC (stereo): left (u, v) and the right u shifted by the
    baseline (types_sba.h:209-240)."""
    point, cam = vparams
    uv, pc = _cam_w2i_project(cam, point)
    fx, cx, baseline = cam[..., 7], cam[..., 9], cam[..., 11]
    u_right = (fx * (pc[..., 0] - baseline) + cx * pc[..., 2]) / pc[..., 2]
    return torch.cat([uv, u_right[..., None]], dim=-1) - meas


EDGE_PROJECT_P2SC = register_edge_type(EdgeType(
    name="edge_project_p2sc",
    tag="EDGE_PROJECT_P2SC",
    vertex_types=("sba_point_xyz", "cam"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_p2sc_error,
))


def _edge_sba_cam_error(vparams, meas, pdata):
    """EdgeSBACam: the relative pose of two SBA cams against the
    measurement (t, q), as (t, compact q) of Z^-1 C1^-1 C2
    (types_sba.cpp:133-180)."""
    c1, c2 = vparams
    d = lie.se3_compose(lie.se3_inverse(meas),
                        lie.se3_compose(lie.se3_inverse(c1[..., :7]),
                                        c2[..., :7]))
    return torch.cat([d[..., :3], lie.quat_to_compact(d[..., 3:7])], dim=-1)


EDGE_SBA_CAM = register_edge_type(EdgeType(
    name="edge_sba_cam",
    tag="EDGE_CAM",
    vertex_types=("cam", "cam"),
    error_dim=6,
    measurement_dim=7,
    error=_edge_sba_cam_error,
))


def _edge_sba_scale_error(vparams, meas, pdata):
    """EdgeSBAScale: the distance of two camera centers against the
    measured scale (types_sba.h:244-280)."""
    c1, c2 = vparams
    d = c1[..., :3] - c2[..., :3]
    return (torch.sqrt((d * d).sum(dim=-1)) - meas[..., 0])[..., None]


EDGE_SBA_SCALE = register_edge_type(EdgeType(
    name="edge_sba_scale",
    tag="EDGE_SCALE",
    vertex_types=("cam", "cam"),
    error_dim=1,
    measurement_dim=1,
    error=_edge_sba_scale_error,
))
