"""Batched SE2, quaternion, SO3 and SE3 manifold operations in PyTorch.

Counterpart of openslam_g2o_tpu/ops/lie.py:57-352 (Sim3 is not ported).
Every function takes tensors whose LAST axis holds the group element and
broadcasts over any leading batch axes, so one call covers a whole vertex or
edge table (the JAX package writes unbatched functions and vmaps them). The
arithmetic follows the JAX functions operation by operation, so float64
results agree to rounding, and the functions are differentiable in forward
mode (core/problem.py `forward_jacobians`): every small-angle branch guards
the INPUT of its square root, as the JAX functions do.

Conventions: SE2 params ``(x, y, theta)``; quaternions ``(qx, qy, qz, qw)``;
SE3 params ``(tx, ty, tz, qx, qy, qz, qw)``; the "MQT" minimal vector is
``(tx, ty, tz, qx, qy, qz)`` with the quaternion sign-normalized to qw >= 0
(isometry3d_mappings.cpp:94-106); the se3 exp/log tangent is ``(omega,
upsilon)``, rotation first (se3quat.h:223-258). Rotation matrices are
``[..., 3, 3]``.
"""
from __future__ import annotations

import math

import torch

__all__ = ["normalize_angle", "se2_compose", "se2_inverse", "se2_apply",
           "se2_retract", "se2_to_vector", "se2_error",
           "quat_identity", "quat_mul", "quat_conj", "quat_normalize",
           "quat_normalize_positive", "quat_rotate", "quat_to_matrix",
           "matrix_to_quat", "quat_from_compact", "quat_to_compact",
           "se3_identity", "se3_compose", "se3_inverse", "se3_apply",
           "se3_from_mqt", "se3_retract_mqt", "se3_error_mqt", "skew",
           "so3_exp", "so3_log", "se3_exp", "se3_log",
           "se3_retract_expmap_left"]

_EPS = 1e-10

_TWO_PI = 2.0 * math.pi


def normalize_angle(theta):
    """Wrap an angle to [-pi, pi) with the floor formula of
    openslam_g2o_tpu/ops/lie.py:60 (g2o/stuff/misc.h:94). atan2 or remainder
    would differ from it exactly at +-pi."""
    return theta - _TWO_PI * torch.floor((theta + math.pi) / _TWO_PI)


def se2_compose(a, b):
    """a * b (motion composition), theta renormalized (se2.h:66-72)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, normalize_angle(a[..., 2] + b[..., 2])], dim=-1)


def se2_inverse(a):
    """se2.h:80-90: R(-theta) * (-t)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return torch.stack([x, y, normalize_angle(-a[..., 2])], dim=-1)


def se2_apply(a, p):
    """Transform 2D points: t + R p (se2.h:74-77)."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([a[..., 0] + c * p[..., 0] - s * p[..., 1],
                        a[..., 1] + s * p[..., 0] + c * p[..., 1]], dim=-1)


def se2_retract(params, delta):
    """VertexSE2 oplus: additive update, then renormalize theta
    (vertex_se2.h:41)."""
    out = params + delta
    return torch.cat([out[..., :2], normalize_angle(out[..., 2:3])], dim=-1)


def se2_to_vector(p):
    return p


def se2_error(meas_inv, xi, xj):
    """EdgeSE2 error (Z^-1 * (Xi^-1 * Xj)).toVector() (edge_se2.h:46-52)."""
    return se2_compose(meas_inv, se2_compose(se2_inverse(xi), xj))


# ---------------------------------------------------------------------------
# Quaternions: (qx, qy, qz, qw)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(dim=-1)
    x2, y2, z2, w2 = q2.unbind(dim=-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_normalize(q):
    return q / torch.sqrt((q * q).sum(dim=-1, keepdim=True))


def quat_normalize_positive(q):
    """Normalize and force qw >= 0 (isometry3d_mappings.cpp:38-45)."""
    q = quat_normalize(q)
    return torch.where(q[..., 3:4] < 0, -q, q)


def _cross(a, b):
    a0, a1, a2 = a.unbind(dim=-1)
    b0, b1, b2 = b.unbind(dim=-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v by unit quaternions q (q * [v, 0] * q^-1), expanded
    form."""
    u = q[..., :3]
    w = q[..., 3:4]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def _rows(*rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def quat_to_matrix(q):
    x, y, z, w = q.unbind(dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _rows((1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)),
                 (2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)),
                 (2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)))


def matrix_to_quat(R):
    """Rotation matrices [..., 3, 3] -> (x, y, z, w), branch-free: selects
    among the four Shepperd constructions by the largest denominator. The
    square roots' inputs are clamped at 1e-10, so the derivative of the
    branches not taken stays finite."""
    d0, d1, d2 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    t = d0 + d1 + d2
    root = lambda v: torch.sqrt(torch.clamp_min(v, _EPS)) * 2.0
    s_w = root(1.0 + t)
    q_w = torch.stack([(R[..., 2, 1] - R[..., 1, 2]) / s_w,
                       (R[..., 0, 2] - R[..., 2, 0]) / s_w,
                       (R[..., 1, 0] - R[..., 0, 1]) / s_w,
                       0.25 * s_w], dim=-1)
    s_x = root(1.0 + d0 - d1 - d2)
    q_x = torch.stack([0.25 * s_x,
                       (R[..., 0, 1] + R[..., 1, 0]) / s_x,
                       (R[..., 0, 2] + R[..., 2, 0]) / s_x,
                       (R[..., 2, 1] - R[..., 1, 2]) / s_x], dim=-1)
    s_y = root(1.0 + d1 - d0 - d2)
    q_y = torch.stack([(R[..., 0, 1] + R[..., 1, 0]) / s_y,
                       0.25 * s_y,
                       (R[..., 1, 2] + R[..., 2, 1]) / s_y,
                       (R[..., 0, 2] - R[..., 2, 0]) / s_y], dim=-1)
    s_z = root(1.0 + d2 - d0 - d1)
    q_z = torch.stack([(R[..., 0, 2] + R[..., 2, 0]) / s_z,
                       (R[..., 1, 2] + R[..., 2, 1]) / s_z,
                       0.25 * s_z,
                       (R[..., 1, 0] - R[..., 0, 1]) / s_z], dim=-1)
    use_trace = (t > 0.0)[..., None]
    x_largest = (d0 >= d1) & (d0 >= d2)
    use_x = (~use_trace) & x_largest[..., None]
    use_y = (~use_trace) & ((~x_largest) & (d1 >= d2))[..., None]
    q = torch.where(use_trace, q_w,
                    torch.where(use_x, q_x, torch.where(use_y, q_y, q_z)))
    return quat_normalize(q)


def quat_from_compact(v):
    """(qx, qy, qz) -> full quaternion with qw = sqrt(max(0, 1 - |v|^2))
    (fromCompactQuaternion, isometry3d_mappings.cpp:86-92; clamped where the
    reference returns the identity: same fixed point, smooth for forward
    mode)."""
    n2 = (v * v).sum(dim=-1, keepdim=True)
    w = torch.sqrt(torch.clamp_min(1.0 - n2, 0.0))
    return torch.cat([v, w], dim=-1)


def quat_to_compact(q):
    """Full quaternion -> (qx, qy, qz), sign so that qw >= 0
    (toCompactQuaternion)."""
    return quat_normalize_positive(q)[..., :3]


# ---------------------------------------------------------------------------
# SE3: (tx, ty, tz, qx, qy, qz, qw)
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32):
    return torch.tensor([0, 0, 0, 0, 0, 0, 1], dtype=dtype)


def se3_compose(a, b):
    t = a[..., :3] + quat_rotate(a[..., 3:7], b[..., :3])
    q = quat_mul(a[..., 3:7], b[..., 3:7])
    return torch.cat([t, quat_normalize(q)], dim=-1)


def se3_inverse(a):
    qi = quat_conj(a[..., 3:7])
    return torch.cat([-quat_rotate(qi, a[..., :3]), qi], dim=-1)


def se3_apply(a, p):
    return a[..., :3] + quat_rotate(a[..., 3:7], p)


def se3_from_mqt(v):
    """(t, q_vec) -> SE3 params (fromVectorMQT,
    isometry3d_mappings.cpp:117)."""
    return torch.cat([v[..., :3], quat_from_compact(v[..., 3:6])], dim=-1)


def se3_retract_mqt(params, delta):
    """VertexSE3 oplus: T <- T * fromVectorMQT(delta), delta = (dt, dq_vec)
    (vertex_se3.h:100-116); the quaternion is renormalized every step."""
    return se3_compose(params, se3_from_mqt(delta))


def se3_error_mqt(meas_inv, xi, xj):
    """EdgeSE3 error: toVectorMQT(Z^-1 * Xi^-1 * Xj) (edge_se3.cpp:48-53)."""
    d = se3_compose(meas_inv, se3_compose(se3_inverse(xi), xj))
    return torch.cat([d[..., :3], quat_to_compact(d[..., 3:7])], dim=-1)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return _rows((z, -v[..., 2], v[..., 1]),
                 (v[..., 2], z, -v[..., 0]),
                 (-v[..., 1], v[..., 0], z))


def so3_exp(omega):
    """Rodrigues: rotation vectors -> unit quaternions (x, y, z, w). The
    small-angle branch guards the input of the square root, so the forward
    derivative at omega = 0 is exact and finite."""
    theta2 = (omega * omega).sum(dim=-1, keepdim=True)
    small = theta2 < 1e-12
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta2),
                                        theta2))
    half = 0.5 * safe_theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / safe_theta)
    w = torch.where(small, 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0,
                    torch.cos(half))
    return torch.cat([k * omega, w], dim=-1)


def so3_log(q):
    """Unit quaternions -> rotation vectors omega, |omega| in [0, pi]."""
    q = torch.where(q[..., 3:4] < 0, -q, q)
    v, w = q[..., :3], q[..., 3:4]
    nv2 = (v * v).sum(dim=-1, keepdim=True)
    small = nv2 < 1e-14
    safe_nv = torch.sqrt(torch.where(small, torch.ones_like(nv2), nv2))
    angle = 2.0 * torch.atan2(safe_nv, w)
    k = torch.where(small, 2.0 / torch.clamp_min(w, 1e-12), angle / safe_nv)
    return k * v


def _so3_left_jacobian_terms(theta2):
    """A = sin t / t, B = (1 - cos t) / t^2, C = (t - sin t) / t^3 with their
    Taylor fallbacks (the square root's input is guarded)."""
    small = theta2 < 1e-10
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe_t) / safe_t)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(safe_t)) / (safe_t * safe_t))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (safe_t - torch.sin(safe_t)) / (safe_t ** 3))
    return A, B, C


def _matvec(M, v):
    return (M * v[..., None, :]).sum(dim=-1)


def se3_exp(xi):
    """SE3Quat::exp, tangent (omega, upsilon), rotation first
    (se3quat.h:223-258)."""
    omega, upsilon = xi[..., :3], xi[..., 3:6]
    theta2 = (omega * omega).sum(dim=-1)
    _, B, C = _so3_left_jacobian_terms(theta2)
    Om = skew(omega)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    V = eye + B[..., None, None] * Om + C[..., None, None] * (Om @ Om)
    return torch.cat([_matvec(V, upsilon), so3_exp(omega)], dim=-1)


def se3_log(p):
    """SE3Quat::log (se3quat.h:178-215): (omega, upsilon)."""
    omega = so3_log(p[..., 3:7])
    theta2 = (omega * omega).sum(dim=-1)
    Om = skew(omega)
    small = theta2 < 1e-10
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    safe_t = torch.sqrt(safe_t2)
    # V^-1 = I - 0.5 Om + coef Om^2; coef = (1 - t / (2 tan(t / 2))) / t^2
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - safe_t / (2.0 * torch.tan(safe_t / 2.0))) / safe_t2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device)
    V_inv = eye - 0.5 * Om + coef[..., None, None] * (Om @ Om)
    return torch.cat([omega, _matvec(V_inv, p[..., :3])], dim=-1)


def se3_retract_expmap_left(params, delta):
    """VertexSE3Expmap oplus: T <- exp(delta) * T
    (types_six_dof_expmap.h:101-104)."""
    return se3_compose(se3_exp(delta), params)
