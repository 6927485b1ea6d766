"""K3: LM damping, the Cholesky factor of every DxD diagonal block (D = 2,
3 or 6) and its inverse, and the scaled right-hand side of one LM-PCG trial
(csrc/damp_chol.cu).

Replaces `hot_diag_blocks` and the `extra` / `dblocks` lines of
`_pcg_trial` (openslam_g2o_tpu/core/sparse.py:1143,
core/algorithms.py:220-228), `batched_chol_inv_lower` and
`batched_chol_lower` (core/solvers.py:63-139) and `lane_block_mv(linv, bT)`
(core/sparse.py:871). The factor functions below are the plain version's
arithmetic and are what core/solvers.py exports.
"""
from __future__ import annotations

import collections

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, pair_width, require)


def _chol_entries(A):
    """The lower Cholesky factor of a batch of small matrices [..., D, D] as
    a D x D list of [...] tensors (None above the diagonal), column by
    column: L_jj = sqrt(A_jj - sum_k L_jk^2), L_ij = (A_ij - sum_k L_ik
    L_jk) / L_jj. Unrolled at D <= 3 these are the closed forms of
    solvers.py:63-139, operation by operation. A non-SPD block takes the
    square root of a negative number; the NaN spreads through the entries
    computed after the bad pivot."""
    D = A.shape[-1]
    L = [[None] * D for _ in range(D)]
    for j in range(D):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s)
        for i in range(j + 1, D):
            t = A[..., i, j]
            for k in range(j):
                t = t - L[i][k] * L[j][k]
            L[i][j] = t / L[j][j]
    return L


def _lower(entries):
    D = len(entries)
    z = torch.zeros_like(entries[0][0])
    return torch.stack([torch.stack([entries[i][j] if j <= i else z
                                     for j in range(D)], dim=-1)
                        for i in range(D)], dim=-2)


def batched_chol_inv_lower(A):
    """L^-1 for a batch of small SPD matrices A = L L^T ([..., D, D]), by
    the scalar Cholesky recurrence and forward substitution (M_ii = 1 /
    L_ii, M_ij = -(sum_{j<=k<i} L_ik M_kj) M_ii). A non-SPD block yields
    NaN, which fails the PCG solve and triggers the LM lambda retry. The
    JAX package hands D > 3 to jnp.linalg.cholesky (solvers.py:105-108),
    which marks the whole block NaN; here only the entries after the bad
    pivot are, and the solve fails either way."""
    D = A.shape[-1]
    L = _chol_entries(A)
    M = [[None] * D for _ in range(D)]
    for i in range(D):
        M[i][i] = 1.0 / L[i][i]
    for j in range(D):
        for i in range(j + 1, D):
            s = L[i][j] * M[j][j]
            for k in range(j + 1, i):
                s = s + L[i][k] * M[k][j]
            M[i][j] = -s * M[i][i]
    return _lower(M)


def batched_chol_lower(A):
    """L for a batch of small SPD matrices A = L L^T (the same recurrence;
    solvers.py:111-139)."""
    return _lower(_chol_entries(A))


def _lane(blocks):
    """[N, D, D] -> the lane-major [D*D, N] table (entry D a + b of row n)."""
    D = blocks.shape[-1]
    return blocks.permute(1, 2, 0).reshape(D * D, -1).contiguous()


def damp_chol_plain(values, free, b, lam):
    """Plain PyTorch version of K3 (the lines of the trial it replaces,
    in their order)."""
    N = free.shape[0]
    D = b.shape[0]
    extra = lam * free + (1.0 - free)
    eye = torch.eye(D, dtype=values.dtype, device=values.device)
    dblocks = (values[0].reshape(D, D, N).permute(2, 0, 1)
               + extra[:, None, None] * eye[None])
    linv = batched_chol_inv_lower(dblocks)
    bhat = (linv.permute(1, 2, 0) * b[None]).sum(dim=1)
    return _lane(linv), _lane(batched_chol_lower(dblocks)), bhat, extra


def damp_chol(values, free, b, lam):
    """Damped diagonal blocks D_n + extra_n I of the block-ELL `values`
    [K, D*D, N] (slot 0; D = 2, 3 or 6, read from b), with extra = lam free +
    (1 - free); their Cholesky factors A = L L^T and M = L^-1; and bhat =
    M b.

    free [N], b [D, N], lam a 0-dim tensor on the same device (it is read
    on the device, never on the host). Returns (linv [D*D, N], lchol
    [D*D, N], bhat [D, N], extra [N]). A non-SPD block yields NaN factors.
    K3 on CUDA tensors, the plain version on CPU tensors."""
    N = free.shape[0]
    require(b.dim() == 2 and b.shape[1] == N,
            f"damp_chol: b shape {tuple(b.shape)} != [D, {N}]")
    D = pair_width("damp_chol", b.shape[0])
    require(values.dim() == 3 and values.shape[1:] == (D * D, N)
            and values.shape[0] >= 1,
            f"damp_chol: values shape {tuple(values.shape)} != "
            f"[K, {D * D}, {N}]")
    require(lam.dim() == 0, "damp_chol: lam must be a 0-dim tensor")
    check_tensors("damp_chol", values.device, values.dtype,
                  {"values": values, "free": free, "b": b, "lam": lam}, {})
    if not launch_device("damp_chol", values.device):
        return damp_chol_plain(values, free, b, lam)
    linv = torch.empty((D * D, N), dtype=values.dtype, device=values.device)
    lchol = torch.empty_like(linv)
    bhat = torch.empty_like(b)
    extra = torch.empty_like(free)
    if N == 0:
        return linv, lchol, bhat, extra
    build.launch("g2o_damp_chol", values, values.data_ptr(), free.data_ptr(),
                 b.data_ptr(), lam.data_ptr(), linv.data_ptr(),
                 lchol.data_ptr(), bhat.data_ptr(), extra.data_ptr(), N, D)
    damp_chol.launches += 1
    damp_chol.launches_by_width[D] += 1
    return linv, lchol, bhat, extra


damp_chol.launches = 0
damp_chol.launches_by_width = collections.Counter()
