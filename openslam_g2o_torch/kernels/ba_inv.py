"""K11: the damped small-block inverses of the Schur BA solve
(csrc/ba_inv.cu).

Replaces `_inv_lane` (openslam_g2o_tpu/core/ba_ell.py:376-417) with the
damping of `_solve` folded in (:686-688, :694-702). Blocks are lane-major
[D*D, N] tables (entry D a + b of block n), D in {2, 3, 4, 6, 9}. The
inverse is the JAX formula: the closed-form adjugate for D <= 3, the
2x2-block Schur inversion with 3x3 quadrants for D = 6, with 2x2 quadrants
for D = 4 (the intrinsics blocks of the general Schur path, core/ba.py,
where the JAX package calls jnp.linalg.inv: equal to rounding) and with
quadrants of 4 and 5 for D = 9 (the BAL camera, models/bal.py), split
again 2 + 2 and 2 + 3 as `_inv_lane` recurses. No Cholesky, so
an indefinite block gives the same values on both packages and the dense
factorization of S or PCG decides whether the solve is usable, as in the
JAX code. A block whose products overflow gives NaN where the plain
version does: the kernel rounds every product on its own (ba_inv.cu is
built without FMA contraction, kernels/build.py), so inf - inf stays NaN
and is not contracted into a finite value.
"""
from __future__ import annotations

import collections

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)

WIDTHS = (2, 3, 4, 6, 9)
PLAIN, LANDMARK, CAMERA = 0, 1, 2          # the damping modes


def _bmm_lane(A, B):
    """C[a, c, n] = sum_b A[a, b, n] B[b, c, n]."""
    return (A[:, :, None] * B[None]).sum(dim=1)


def inv_lane_plain(A):
    """`_inv_lane` on a [D, D, N] stack, the JAX formula line by line."""
    D = A.shape[0]
    if D == 1:
        return 1.0 / A
    if D == 2:
        a, b, c, d = A[0, 0], A[0, 1], A[1, 0], A[1, 1]
        inv_det = 1.0 / (a * d - b * c)
        return torch.stack([torch.stack([d, -b]),
                            torch.stack([-c, a])]) * inv_det[None, None]
    if D == 3:
        a, b, c = A[0, 0], A[0, 1], A[0, 2]
        d, e, f = A[1, 0], A[1, 1], A[1, 2]
        g, h, i = A[2, 0], A[2, 1], A[2, 2]
        A11, A12, A13 = e * i - f * h, c * h - b * i, b * f - c * e
        A21, A22, A23 = f * g - d * i, a * i - c * g, c * d - a * f
        A31, A32, A33 = d * h - e * g, b * g - a * h, a * e - b * d
        inv_det = 1.0 / (a * A11 + b * A21 + c * A31)
        adj = torch.stack([torch.stack([A11, A12, A13]),
                           torch.stack([A21, A22, A23]),
                           torch.stack([A31, A32, A33])])
        return adj * inv_det[None, None]
    k = D // 2
    P, Q = A[:k, :k], A[:k, k:]
    R, S = A[k:, :k], A[k:, k:]
    Pi = inv_lane_plain(P)
    PiQ = _bmm_lane(Pi, Q)
    Ti = inv_lane_plain(S - _bmm_lane(R, PiQ))
    RPi = _bmm_lane(R, Pi)
    TiRPi = _bmm_lane(Ti, RPi)
    return torch.cat([
        torch.cat([Pi + _bmm_lane(PiQ, TiRPi), -_bmm_lane(PiQ, Ti)], dim=1),
        torch.cat([-TiRPi, Ti], dim=1)], dim=0)


def ba_block_inv_plain(A, mode=PLAIN, free=None, lam=None, b=None,
                       want_inv=True):
    D = int(round(A.shape[0] ** 0.5))
    N = A.shape[1]
    M = A.view(D, D, N)
    eye = torch.eye(D, dtype=A.dtype, device=A.device)[:, :, None]
    if mode == LANDMARK:
        M = M + eye * (lam * free + (1.0 - free))[None, None]
    elif mode == CAMERA:
        f = free[None, None]
        M = (M + lam * eye) * f + (1.0 - f) * eye
    damped = M.reshape(D * D, N) if mode == CAMERA else None
    inv = hib = None
    if want_inv:
        X = inv_lane_plain(M)
        inv = X.reshape(D * D, N)
        if b is not None:
            hib = (X * b[None]).sum(dim=1)
    return damped, inv, hib


def ba_block_inv(A, mode: int = PLAIN, free=None, lam=None, b=None,
                 want_inv: bool = True):
    """(damped, inv, hib) for the lane-major blocks A [D*D, N]:

    mode PLAIN     inv = A^-1 (damped None);
    mode LANDMARK  inv = (A + I (lam free + (1 - free)))^-1 and, given b
                   [D, N], hib = inv b (damped None);
    mode CAMERA    damped = (A + lam I) free + (1 - free) I, and its inverse
                   if want_inv;

    free [N] and lam (a 0-dim tensor, read on the device) for the damped
    modes. Entries not asked for are None. K11 on CUDA tensors, the plain
    version on CPU tensors."""
    require(A.dim() == 2, "ba_block_inv: A must be [D*D, N]")
    D = int(round(A.shape[0] ** 0.5))
    N = A.shape[1]
    require(D in WIDTHS and D * D == A.shape[0],
            f"ba_block_inv: {A.shape[0]} rows is no D*D for D in {WIDTHS}")
    require(mode in (PLAIN, LANDMARK, CAMERA), f"ba_block_inv: mode {mode}")
    floats = {"A": A}
    if mode != PLAIN:
        require(free is not None and free.shape == (N,) and lam is not None
                and lam.dim() == 0,
                "ba_block_inv: the damped modes need free [N] and a 0-dim lam")
        floats.update(free=free, lam=lam)
    if b is not None:
        require(mode == LANDMARK and b.shape == (D, N) and want_inv,
                "ba_block_inv: b [D, N] goes with mode LANDMARK")
        floats["b"] = b
    check_tensors("ba_block_inv", A.device, A.dtype, floats, {})
    if not launch_device("ba_block_inv", A.device):
        return ba_block_inv_plain(A, mode, free, lam, b, want_inv)
    new = lambda *shape: torch.empty(shape, dtype=A.dtype, device=A.device)
    damped = new(D * D, N) if mode == CAMERA else None
    inv = new(D * D, N) if want_inv else None
    hib = new(D, N) if b is not None else None
    if N == 0:
        return damped, inv, hib
    ptr = lambda t: None if t is None else t.data_ptr()
    build.launch("g2o_ba_inv", A, A.data_ptr(), ptr(free), ptr(lam), ptr(b),
                 N, D, mode, ptr(damped), ptr(inv), ptr(hib))
    ba_block_inv.launches += 1
    ba_block_inv.launches_by_width[D] += 1
    return damped, inv, hib


ba_block_inv.launches = 0
ba_block_inv.launches_by_width = collections.Counter()
