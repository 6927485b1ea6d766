"""Batched SE2 manifold operations in PyTorch.

Counterpart of openslam_g2o_tpu/ops/lie.py:57-116. Every function takes
tensors whose LAST axis holds the group element (SE2 params ``(x, y,
theta)``) and broadcasts over any leading batch axes, so one call covers a
whole vertex or edge table (the JAX package writes unbatched functions and
vmaps them). The arithmetic follows the JAX functions operation by
operation, so float64 results agree to rounding.
"""
from __future__ import annotations

import math

import torch

__all__ = ["normalize_angle", "se2_compose", "se2_inverse", "se2_apply",
           "se2_retract", "se2_to_vector", "se2_error"]

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
