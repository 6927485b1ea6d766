"""K3: LM damping, the closed-form 3x3 Cholesky factor and its inverse, and
the scaled right-hand side of one LM-PCG trial (csrc/damp_chol.cu).

Replaces `hot_diag_blocks` and the `extra` / `dblocks` lines of
`_pcg_trial` (openslam_g2o_tpu/core/sparse.py:1143,
core/algorithms.py:220-228), `batched_chol_inv_lower` and
`batched_chol_lower` (core/solvers.py:63-139) and `lane_block_mv(linv, bT)`
(core/sparse.py:871). The closed-form factor functions below are the plain
version's arithmetic and are what core/solvers.py exports.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)


def batched_chol_inv_lower(A):
    """L^-1 for a batch of small SPD matrices A = L L^T ([..., D, D]).

    D <= 3 uses the closed-form scalar Cholesky and forward solve of
    solvers.py:63-104: a non-SPD block takes the square root of a negative
    number and yields NaN, which fails the PCG solve and triggers the LM
    lambda retry. Larger D uses torch.linalg (which raises instead)."""
    D = A.shape[-1]
    if D == 1:
        return 1.0 / torch.sqrt(A)
    if D == 2:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m21 = -(l21 * m11) * m22
        z = torch.zeros_like(l11)
        return _rows((m11, z), (m21, m22))
    if D == 3:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        m11 = 1.0 / l11
        m22 = 1.0 / l22
        m33 = 1.0 / l33
        m21 = -(l21 * m11) * m22
        m31 = -(l31 * m11 + l32 * m21) * m33
        m32 = -(l32 * m22) * m33
        z = torch.zeros_like(l11)
        return _rows((m11, z, z), (m21, m22, z), (m31, m32, m33))
    L = torch.linalg.cholesky(A)
    eye = torch.eye(D, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def batched_chol_lower(A):
    """L for a batch of small SPD matrices A = L L^T (closed form for
    D <= 3, solvers.py:111-139; torch.linalg.cholesky beyond)."""
    D = A.shape[-1]
    if D == 1:
        return torch.sqrt(A)
    if D == 2:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        z = torch.zeros_like(l11)
        return _rows((l11, z), (l21, l22))
    if D == 3:
        l11 = torch.sqrt(A[..., 0, 0])
        l21 = A[..., 1, 0] / l11
        l31 = A[..., 2, 0] / l11
        l22 = torch.sqrt(A[..., 1, 1] - l21 * l21)
        l32 = (A[..., 2, 1] - l31 * l21) / l22
        l33 = torch.sqrt(A[..., 2, 2] - l31 * l31 - l32 * l32)
        z = torch.zeros_like(l11)
        return _rows((l11, z, z), (l21, l22, z), (l31, l32, l33))
    return torch.linalg.cholesky(A)


def _rows(*rows):
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)



def _lane(blocks):
    """[N, 3, 3] -> the lane-major [9, N] table (entry 3a+b of row n)."""
    return blocks.permute(1, 2, 0).reshape(9, -1).contiguous()


def damp_chol_plain(values, free, b, lam):
    """Plain PyTorch version of K3 (the lines of the trial it replaces,
    in their order)."""
    N = free.shape[0]
    extra = lam * free + (1.0 - free)
    eye = torch.eye(3, dtype=values.dtype, device=values.device)
    dblocks = (values[0].reshape(3, 3, N).permute(2, 0, 1)
               + extra[:, None, None] * eye[None])
    linv = batched_chol_inv_lower(dblocks)
    bhat = (linv.permute(1, 2, 0) * b[None]).sum(dim=1)
    return _lane(linv), _lane(batched_chol_lower(dblocks)), bhat, extra


def damp_chol(values, free, b, lam):
    """Damped diagonal blocks D_n + extra_n I of the block-ELL `values`
    [K, 9, N] (slot 0), with extra = lam free + (1 - free); their Cholesky
    factors A = L L^T and M = L^-1; and bhat = M b.

    free [N], b [3, N], lam a 0-dim tensor on the same device (it is read
    on the device, never on the host). Returns (linv [9, N], lchol [9, N],
    bhat [3, N], extra [N]). A non-SPD block yields NaN factors. K3 on CUDA
    tensors, the plain version on CPU tensors."""
    N = free.shape[0]
    require(values.dim() == 3 and values.shape[1:] == (9, N)
            and values.shape[0] >= 1,
            f"damp_chol: values shape {tuple(values.shape)} != [K, 9, {N}]")
    require(b.shape == (3, N), f"damp_chol: b shape {tuple(b.shape)} != "
            f"{(3, N)}")
    require(lam.dim() == 0, "damp_chol: lam must be a 0-dim tensor")
    check_tensors("damp_chol", values.device, values.dtype,
                  {"values": values, "free": free, "b": b, "lam": lam}, {})
    if not launch_device("damp_chol", values.device):
        return damp_chol_plain(values, free, b, lam)
    linv = torch.empty((9, N), dtype=values.dtype, device=values.device)
    lchol = torch.empty_like(linv)
    bhat = torch.empty_like(b)
    extra = torch.empty_like(free)
    if N == 0:
        return linv, lchol, bhat, extra
    build.launch("g2o_damp_chol", values, values.data_ptr(), free.data_ptr(),
                 b.data_ptr(), lam.data_ptr(), linv.data_ptr(),
                 lchol.data_ptr(), bhat.data_ptr(), extra.data_ptr(), N)
    damp_chol.launches += 1
    return linv, lchol, bhat, extra


damp_chol.launches = 0
