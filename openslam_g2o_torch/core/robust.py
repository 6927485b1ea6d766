"""Robust kernels: rho(e2) -> (rho, rho', rho'').

Counterpart of openslam_g2o_tpu/core/robust.py:21-119 in PyTorch: the same
five kernels, the same ScaleDelta wrappers and the same integer kernel ids
(the CUDA edge linearizer, kernels/csrc/edge_se2_blocks.cu, switches on
these ids). The quadratic form is scaled by rho' and chi2 sums rho(e2)
(BaseEdge::robustInformation, base_edge.h:96-99).
"""
from __future__ import annotations

import torch

__all__ = ["ROBUST_KERNELS", "robustify", "NONE_ID", "kernel_id",
           "kernel_names"]


def _none(e2, delta):
    return e2, torch.ones_like(e2), torch.zeros_like(e2)


def _huber(e2, delta):
    """robust_kernel_impl.cpp:65-78."""
    dsqr = delta * delta
    sqrte = torch.sqrt(torch.clamp_min(e2, 1e-30))
    inlier = e2 <= dsqr
    rho0 = torch.where(inlier, e2, 2.0 * sqrte * delta - dsqr)
    rho1 = torch.where(inlier, torch.ones_like(e2), delta / sqrte)
    rho2 = torch.where(inlier, torch.zeros_like(e2),
                       -0.5 * (delta / sqrte) / torch.clamp_min(e2, 1e-30))
    return rho0, rho1, rho2


def _pseudo_huber(e2, delta):
    """robust_kernel_impl.cpp:80-90."""
    dsqr = delta * delta
    dsqr_reci = 1.0 / dsqr
    aux1 = dsqr_reci * e2 + 1.0
    aux2 = torch.sqrt(aux1)
    return (2.0 * dsqr * (aux2 - 1.0), 1.0 / aux2,
            -0.5 * dsqr_reci / (aux2 * aux1))


def _cauchy(e2, delta):
    """robust_kernel_impl.cpp:92-101."""
    dsqr = delta * delta
    dsqr_reci = 1.0 / dsqr
    aux = dsqr_reci * e2 + 1.0
    rho1 = 1.0 / aux
    return dsqr * torch.log(aux), rho1, -dsqr_reci * rho1 * rho1


def _saturated(e2, delta):
    """robust_kernel_impl.cpp:103-115."""
    dsqr = delta * delta
    inlier = e2 <= dsqr
    return (torch.where(inlier, e2, dsqr), inlier.to(e2.dtype),
            torch.zeros_like(e2))


def _dcs(e2, delta):
    """Dynamic Covariance Scaling; delta is phi (robust_kernel_impl.cpp:117-128)."""
    scale = torch.clamp_max((2.0 * delta) / (delta + e2), 1.0)
    return scale * e2 * scale, scale * scale, torch.zeros_like(e2)


def _make_scale_delta(inner):
    """RobustKernelScaleDelta (robust_kernel_impl.h:42-61): rho =
    inner(e2 / delta^2) with rho0 *= delta^2 and rho2 /= delta^2."""
    def fn(e2, delta):
        dsqr = delta * delta
        r0, r1, r2 = inner(e2 / dsqr, torch.ones_like(delta))
        return r0 * dsqr, r1, r2 / dsqr
    return fn


# Order defines the integer kernel ids (shared with the CUDA linearizer).
ROBUST_KERNELS = {
    "None": _none,
    "Huber": _huber,
    "PseudoHuber": _pseudo_huber,
    "Cauchy": _cauchy,
    "Saturated": _saturated,
    "DCS": _dcs,
    "ScaleDelta:Huber": _make_scale_delta(_huber),
    "ScaleDelta:PseudoHuber": _make_scale_delta(_pseudo_huber),
    "ScaleDelta:Cauchy": _make_scale_delta(_cauchy),
    "ScaleDelta:Saturated": _make_scale_delta(_saturated),
    "ScaleDelta:DCS": _make_scale_delta(_dcs),
}

NONE_ID = 0
_NAMES = list(ROBUST_KERNELS)


def kernel_id(name: str) -> int:
    if name not in ROBUST_KERNELS:
        raise ValueError(
            f"unknown robust kernel {name!r}; available: {', '.join(_NAMES)}")
    return _NAMES.index(name)


def kernel_names():
    return list(_NAMES)


def robustify(kid: int, e2, delta):
    """Apply kernel #kid elementwise to squared errors."""
    return ROBUST_KERNELS[_NAMES[kid]](e2, delta)
