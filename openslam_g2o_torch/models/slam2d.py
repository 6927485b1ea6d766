"""2D SLAM types of the port: VERTEX_SE2 and EDGE_SE2.

Counterpart of openslam_g2o_tpu/models/slam2d.py:27-34 and :62-124. The
other 2D types (VERTEX_XY, the landmark and offset edges) are not ported
yet; build_problem raises NotImplementedError for them.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.core.registry import (
    EdgeType, VertexType, register_edge_type, register_vertex_type)
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
