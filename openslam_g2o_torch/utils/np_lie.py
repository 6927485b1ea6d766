"""Minimal numpy mirrors of the manifold ops for host-side graph algorithms
(spanning-tree initial guess, simulator, file I/O sanity checks).

The device path uses openslam_g2o_torch.ops.lie (torch); these run
per-element in Python loops where a device round-trip per edge would
dominate. A copy of openslam_g2o_tpu/utils/np_lie.py (with the cross
product written out), so that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import numpy as np


def normalize_angle(theta):
    return theta - 2 * np.pi * np.floor((theta + np.pi) / (2 * np.pi))


# -- SE2: (x, y, theta) -----------------------------------------------------

def se2_compose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * b[0] - s * b[1],
                     a[1] + s * b[0] + c * b[1],
                     normalize_angle(a[2] + b[2])])


def se2_inverse(a):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([-(c * a[0] + s * a[1]),
                     -(-s * a[0] + c * a[1]),
                     normalize_angle(-a[2])])


def se2_apply(a, p):
    c, s = np.cos(a[2]), np.sin(a[2])
    return np.array([a[0] + c * p[0] - s * p[1],
                     a[1] + s * p[0] + c * p[1]])


# -- quaternion (x, y, z, w) ------------------------------------------------

def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ])


def quat_conj(q):
    return np.array([-q[0], -q[1], -q[2], q[3]])


def cross3(a, b):
    """np.cross for two 3-vectors, written out: the same products and
    differences, so the same bits, without np.cross's per-call overhead
    (the generators call this a few times per pose)."""
    return np.array([a[1] * b[2] - a[2] * b[1],
                     a[2] * b[0] - a[0] * b[2],
                     a[0] * b[1] - a[1] * b[0]])


def quat_rotate(q, v):
    u, w = q[:3], q[3]
    uv = cross3(u, v)
    return v + 2.0 * (w * uv + cross3(u, uv))


# -- SE3: (t, q) ------------------------------------------------------------

def se3_compose(a, b):
    t = a[:3] + quat_rotate(a[3:7], b[:3])
    q = quat_mul(a[3:7], b[3:7])
    q = q / np.linalg.norm(q)
    return np.concatenate([t, q])


def se3_inverse(a):
    qi = quat_conj(a[3:7])
    return np.concatenate([-quat_rotate(qi, a[:3]), qi])


def se3_apply(a, p):
    return a[:3] + quat_rotate(a[3:7], p)
