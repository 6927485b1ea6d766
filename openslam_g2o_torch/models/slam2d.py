"""2D SLAM types: SE2 poses, XY landmarks, the SE2 offset parameter and
their constraint edges.

Counterpart of openslam_g2o_tpu/models/slam2d.py. Every function is batched
on the last axis (ops/lie.py): `vparams` holds one [..., P] tensor per
slot, `meas` is [..., M] and `pdata` one [..., dim] tensor per parameter
slot. Only EDGE_SE2 has an analytic Jacobian; the other edges are
differentiated in forward mode by core/problem.py `linearize`.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core.registry import (
    EdgeType, ParameterType, VertexType, register_edge_type,
    register_parameter_type, register_vertex_type)
from openslam_g2o_torch.ops import lie
from openslam_g2o_torch.utils import np_lie

VERTEX_SE2 = register_vertex_type(VertexType(
    name="se2",
    tag="VERTEX_SE2",
    ambient_dim=3,
    tangent_dim=3,
    retract=lie.se2_retract,           # vertex_se2.h:41 oplusImpl
    origin=lambda dtype: torch.zeros(3, dtype=dtype),
))


def _rn_retract(params, delta):
    return params + delta


VERTEX_XY = register_vertex_type(VertexType(
    name="point_xy",
    tag="VERTEX_XY",
    ambient_dim=2,
    tangent_dim=2,
    retract=_rn_retract,               # vertex_point_xy.h oplusImpl (additive)
    origin=lambda dtype: torch.zeros(2, dtype=dtype),
    marginalizable=True,
))

PARAMS_SE2_OFFSET = register_parameter_type(ParameterType(
    name="se2_offset",
    tag="PARAMS_SE2OFFSET",
    dim=3,                             # (x, y, theta) sensor offset pose
))


def _edge_se2_error(vparams, meas, pdata):
    """EdgeSE2: (Z^-1 * (Xi^-1 Xj)).toVector() (edge_se2.h:46-52)."""
    xi, xj = vparams
    return lie.se2_error(lie.se2_inverse(meas), xi, xj)


def _edge_se2_init(vparams, meas, pdata, slot):
    """edge_se2.cpp initialEstimate: to = from * Z (or from = to * Z^-1)."""
    if slot == 1:
        return np_lie.se2_compose(vparams[0], meas)
    return np_lie.se2_compose(vparams[1], np_lie.se2_inverse(meas))


def _edge_se2_jacobian(vparams, meas, pdata):
    """Analytic linearizeOplus of EdgeSE2 (edge_se2.cpp), batched: with
    r = R(ti)^T (tj - ti), e_xy = R(z)^T (r - t_z):
      de_xy/dti = -Rz^T Ri^T,  de_xy/dtj = Rz^T Ri^T,
      de_xy/dthi = Rz^T (r_y, -r_x),  de_th/dthi = -1, de_th/dthj = +1.
    Returns (Ji, Jj), each [..., 3, 3]."""
    xi, xj = vparams
    ci, si = torch.cos(xi[..., 2]), torch.sin(xi[..., 2])
    cz, sz = torch.cos(meas[..., 2]), torch.sin(meas[..., 2])
    dx, dy = xj[..., 0] - xi[..., 0], xj[..., 1] - xi[..., 1]
    rx = ci * dx + si * dy
    ry = -si * dx + ci * dy
    rr00 = cz * ci - sz * si
    rr01 = cz * si + sz * ci
    rr10 = -(sz * ci + cz * si)
    rr11 = -sz * si + cz * ci
    g0 = cz * ry - sz * rx
    g1 = -(sz * ry + cz * rx)
    zero = torch.zeros_like(ci)
    one = torch.ones_like(ci)
    rows = lambda *r: torch.stack([torch.stack(x, dim=-1) for x in r], dim=-2)
    ji = rows((-rr00, -rr01, g0), (-rr10, -rr11, g1), (zero, zero, -one))
    jj = rows((rr00, rr01, zero), (rr10, rr11, zero), (zero, zero, one))
    return ji, jj


EDGE_SE2 = register_edge_type(EdgeType(
    name="edge_se2",
    tag="EDGE_SE2",
    vertex_types=("se2", "se2"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_error,
    jacobian=_edge_se2_jacobian,
    initial_estimate=_edge_se2_init,
))


def _edge_se2_xy_error(vparams, meas, pdata):
    """EdgeSE2PointXY: (X^-1 * l) - z (edge_se2_pointxy.h computeError)."""
    x, l = vparams
    return lie.se2_apply(lie.se2_inverse(x), l) - meas


def _edge_se2_xy_init(vparams, meas, pdata, slot):
    """edge_se2_pointxy.cpp initialEstimate: landmark = X * z (the pose
    slot cannot be initialized from a single observation)."""
    if slot == 1:
        return np_lie.se2_apply(vparams[0], meas)
    return None


EDGE_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_xy",
    tag="EDGE_SE2_XY",
    vertex_types=("se2", "point_xy"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_xy_error,
    initial_estimate=_edge_se2_xy_init,
))


def _edge_se2_bearing_error(vparams, meas, pdata):
    """EdgeSE2PointXYBearing: bearing of the landmark in the robot frame
    minus z (edge_se2_pointxy_bearing.h computeError)."""
    x, l = vparams
    d = lie.se2_apply(lie.se2_inverse(x), l)
    return lie.normalize_angle(
        torch.atan2(d[..., 1], d[..., 0]) - meas[..., 0])[..., None]


EDGE_BEARING_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_xy_bearing",
    tag="EDGE_BEARING_SE2_XY",
    vertex_types=("se2", "point_xy"),
    error_dim=1,
    measurement_dim=1,
    error=_edge_se2_bearing_error,
))


def _edge_se2_prior_error(vparams, meas, pdata):
    """EdgeSE2Prior: (Z^-1 * X).toVector() (edge_se2_prior.h computeError)."""
    (x,) = vparams
    return lie.se2_to_vector(lie.se2_compose(lie.se2_inverse(meas), x))


EDGE_PRIOR_SE2 = register_edge_type(EdgeType(
    name="edge_se2_prior",
    tag="EDGE_PRIOR_SE2",
    vertex_types=("se2",),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_prior_error,
))


def _edge_prior_se2_xy_error(vparams, meas, pdata):
    """EdgePointXYPrior-style unary position prior on an SE2 translation."""
    (x,) = vparams
    return x[..., :2] - meas


EDGE_PRIOR_SE2_XY = register_edge_type(EdgeType(
    name="edge_se2_prior_xy",
    tag="EDGE_PRIOR_SE2_XY",
    vertex_types=("se2",),
    error_dim=2,
    measurement_dim=2,
    error=_edge_prior_se2_xy_error,
))


def _edge_se2_xy_calib_error(vparams, meas, pdata):
    """EdgeSE2PointXYCalib: ((X * C)^-1 * l) - z with the calibration pose C
    as a third vertex (edge_se2_pointxy_calib.h:46-52)."""
    x, l, calib = vparams
    sensor = lie.se2_compose(x, calib)
    return lie.se2_apply(lie.se2_inverse(sensor), l) - meas


EDGE_SE2_XY_CALIB = register_edge_type(EdgeType(
    name="edge_se2_xy_calib",
    tag="EDGE_SE2_XY_CALIB",
    vertex_types=("se2", "point_xy", "se2"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_xy_calib_error,
))


def _edge_se2_offset_error(vparams, meas, pdata):
    """EdgeSE2Offset: relative measurement between two sensor frames mounted
    on the poses with per-edge SE2 offset parameters (edge_se2_offset.cpp
    computeError via CacheSE2Offset)."""
    xi, xj = vparams
    off_i, off_j = pdata
    si = lie.se2_compose(xi, off_i)
    sj = lie.se2_compose(xj, off_j)
    return lie.se2_error(lie.se2_inverse(meas), si, sj)


EDGE_SE2_OFFSET = register_edge_type(EdgeType(
    name="edge_se2_offset",
    tag="EDGE_SE2_OFFSET",
    vertex_types=("se2", "se2"),
    error_dim=3,
    measurement_dim=3,
    error=_edge_se2_offset_error,
    param_types=("se2_offset", "se2_offset"),
))


def _edge_se2_pointxy_offset_error(vparams, meas, pdata):
    """EdgeSE2PointXYOffset: landmark seen from an offset sensor frame
    (edge_se2_pointxy_offset.cpp)."""
    x, l = vparams
    (off,) = pdata
    sensor = lie.se2_compose(x, off)
    return lie.se2_apply(lie.se2_inverse(sensor), l) - meas


EDGE_SE2_POINTXY_OFFSET = register_edge_type(EdgeType(
    name="edge_se2_xy_offset",
    tag="EDGE_SE2_POINTXY_OFFSET",
    vertex_types=("se2", "point_xy"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_se2_pointxy_offset_error,
    param_types=("se2_offset",),
))
