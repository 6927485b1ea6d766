"""BAL (Bundle Adjustment in the Large): the 9-wide Snavely camera and the
BAL text format.

Counterpart of openslam_g2o_tpu/models/bal.py (g2o/examples/bal/
bal_example.cpp): the camera (Rodrigues axis-angle rotation, translation,
focal length, two radial distortion coefficients) with the negative-z
perspective convention, its projection edge, and the reader and writer of
the BAL text file. EDGE_PROJECT_BAL carries no closed-form Jacobian: the
reference differentiates the projection with ceres' forward-mode autodiff
(bal_example.cpp:261-268), the JAX package with jacfwd, and the port in
forward mode too (K17's `edge_lin_bal` on the card, torch.func.jvp on the
CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from openslam_g2o_torch.core.registry import (
    EdgeType, VertexType, register_edge_type, register_vertex_type)
from openslam_g2o_torch.ops import lie

__all__ = ["load_bal_problem", "save_bal_problem", "snavely_project"]


VERTEX_CAMERA_BAL = register_vertex_type(VertexType(
    name="bal_camera",
    tag="VERTEX_CAMERA_BAL",
    ambient_dim=9,          # (rodrigues 3, t 3, f, k1, k2)
    tangent_dim=9,
    retract=lambda p, d: p + d,   # the reference adds the 9-vector
    origin=lambda dtype: torch.tensor([0, 0, 0, 0, 0, 0, 1, 0, 0],
                                      dtype=dtype),
))


def snavely_project(cam, point):
    """BAL projection (bal_example.cpp:191-243), batched on the last axis:
    p = R x + t, proj = -p.xy / p.z, prediction = f (1 + k1 r^2 + k2 r^4)
    proj; cam [..., 9], point [..., 3] -> [..., 2]."""
    q = lie.so3_exp(cam[..., :3])
    p = lie.quat_rotate(q, point) + cam[..., 3:6]
    proj = -p[..., :2] / p[..., 2:3]
    r2 = proj[..., 0] * proj[..., 0] + proj[..., 1] * proj[..., 1]
    distortion = 1.0 + cam[..., 7] * r2 + cam[..., 8] * r2 * r2
    return (cam[..., 6] * distortion)[..., None] * proj


def _edge_bal_error(vparams, meas, pdata):
    point, cam = vparams
    return snavely_project(cam, point) - meas


EDGE_PROJECT_BAL = register_edge_type(EdgeType(
    name="edge_project_bal",
    tag="EDGE_PROJECT_BAL",
    vertex_types=("sba_point_xyz", "bal_camera"),
    error_dim=2,
    measurement_dim=2,
    error=_edge_bal_error,
))


def load_bal_problem(path: str, dtype=None, min_obs_per_point: int = 2,
                     device=None):
    """Read a BAL text file directly into a Problem on `device` (None:
    "cuda"; it raises where there is no GPU) in `dtype` (None: float64).

    Format: ``n_cams n_points n_obs`` then per observation
    ``cam_idx point_idx u v``, then 9 numbers per camera, 3 per point.
    The cameras are the first vertex group, the points the second; camera
    0 is fixed as the gauge, Omega is the identity, no robust kernel. As in
    the JAX package, `min_obs_per_point` is accepted and not applied.
    Returns (Problem, {"n_cams", "n_points", "n_obs"})."""
    from openslam_g2o_torch.core import problem as P
    from openslam_g2o_torch.core import registry, robust

    device = P.resolve_device(device)
    with open(path) as f:
        data = np.array(f.read().split(), dtype=np.float64)
    n_cams, n_points, n_obs = int(data[0]), int(data[1]), int(data[2])
    pos = 3
    obs = data[pos:pos + 4 * n_obs].reshape(n_obs, 4)
    pos += 4 * n_obs
    cams = data[pos:pos + 9 * n_cams].reshape(n_cams, 9)
    pos += 9 * n_cams
    points = data[pos:pos + 3 * n_points].reshape(n_points, 3)

    cam_idx = obs[:, 0].astype(np.int32)
    pt_idx = obs[:, 1].astype(np.int32)
    uv = np.ascontiguousarray(obs[:, 2:4])

    if dtype is None:
        dtype = torch.float64
    cam_vt = registry.vertex_type("bal_camera")
    pt_vt = registry.vertex_type("sba_point_xyz")
    et = registry.edge_type("edge_project_bal")

    free_cam = np.ones(n_cams)
    free_cam[0] = 0.0
    vg_cam = P.VGroup("bal_camera", cam_vt, n_cams, 0)
    vg_pt = P.VGroup("sba_point_xyz", pt_vt, n_points, n_cams * 9)
    eg = P.EGroup(et.name, et, robust.NONE_ID, n_obs)
    static = P.ProblemStatic((vg_cam, vg_pt), (eg,),
                             n_cams * 9 + n_points * 3, n_cams * 9)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    edges = {et.name: P.EdgeArrays(
        (torch.as_tensor(pt_idx, device=device),
         torch.as_tensor(cam_idx, device=device)),
        as_t(uv),
        as_t(np.broadcast_to(np.eye(2), (n_obs, 2, 2)).copy()),
        torch.ones((n_obs,), dtype=dtype, device=device),
        ())}
    prob = P.Problem(
        params={"bal_camera": as_t(cams), "sba_point_xyz": as_t(points)},
        free={"bal_camera": as_t(free_cam),
              "sba_point_xyz": torch.ones((n_points,), dtype=dtype,
                                          device=device)},
        edges=edges, static=static)
    meta = {"n_cams": n_cams, "n_points": n_points, "n_obs": n_obs}
    return prob, meta


def save_bal_problem(problem, path: str):
    """Write a Problem (bal_camera + sba_point_xyz + edge_project_bal) back
    to the BAL text format, in the JAX package's text."""
    host = lambda t: t.detach().cpu().numpy()
    cams = host(problem.params["bal_camera"]).astype(np.float64)
    points = host(problem.params["sba_point_xyz"]).astype(np.float64)
    ea = problem.edges["edge_project_bal"]
    pt_idx = host(ea.indices[0])
    cam_idx = host(ea.indices[1])
    uv = host(ea.measurement).astype(np.float64)
    with open(path, "w") as f:
        f.write(f"{len(cams)} {len(points)} {len(uv)}\n")
        for c, p, m in zip(cam_idx, pt_idx, uv):
            f.write(f"{c} {p} {float(m[0])!r} {float(m[1])!r}\n")
        for c in cams:
            f.write("\n".join(repr(float(v)) for v in c) + "\n")
        for p in points:
            f.write("\n".join(repr(float(v)) for v in p) + "\n")
