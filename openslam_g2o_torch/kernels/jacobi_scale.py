"""K4: symmetric block-Jacobi scaling of the damped block-ELL Hessian, and
the per-row DxD block application around the CG solve, for D = 3 and D = 6
(csrc/jacobi_scale.cu).

`jacobi_scale` replaces `hot_add_diag` + `hot_scale_jacobi`
(openslam_g2o_tpu/core/sparse.py:1173-1247): S[k, :, n] = M_n (B[k, :, n] +
[k = 0] extra[n] I) M_{nb[k, n]}^T with M = L^-1 of the damped diagonal
blocks, so the scaled system has unit diagonal blocks. `lane_block_mv`
replaces `lane_block_mv` (core/sparse.py:871-880). Factor tables are
lane-major [D*D, N] (entry D a + b of row n), as K3 writes them.

`lane_block_mv_dot` is the preconditioner step of the Schur
routes' preconditioned CG: z = M r per row and the partial sums of r . z
in one launch, where `lane_block_mv` and cg_step's `dot_partials` were two
(the preconditioner step of openslam_g2o_tpu/core/solvers.py:246-251). Its
partials lie in dot_partials' layout, one per CHUNK values of the flat
[D, N] vector, and carry the bits of dot_partials(r, lane_block_mv(M, r)).

An off-diagonal slot whose D*D entries are all zero (every padding slot)
is exactly zero in the output whatever the factors hold. The JAX code
multiplies it out, so a NaN factor of row 0 turns the padding of every row
into NaN there; both ways the solve fails and LM retries, but here a NaN
stays where it arose.
"""
from __future__ import annotations

import collections

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    block_width, check_tensors, launch_device, require)
from openslam_g2o_torch.kernels.cg_step import CHUNK, dot_partials_plain

# the widths lane_block_mv serves (LM-PCG's groups), and those of
# lane_block_mv_dot (the Schur routes' preconditioners)
MV_WIDTHS = (2, 3, 6)
MV_DOT_WIDTHS = (2, 3, 4, 6, 9)


def add_diag_plain(values, extra):
    """values with `extra` [N] folded into the diagonal of every row's
    diagonal block (slot 0; sparse.py:1173-1201), as a damped copy."""
    D = block_width("add_diag", values.shape[1])
    out = values.clone()
    out[0, 0::D + 1] += extra[None]      # entries (0,0), (1,1), ...
    return out


def jacobi_scale_plain(nb, values, linv, extra):
    """Plain PyTorch version of K4 (sparse.py:1204-1247 on one layout)."""
    K, N = nb.shape
    D = block_width("jacobi_scale", linv.shape[0])
    B = add_diag_plain(values, extra).view(K, D, D, N)
    Li = linv.view(D, D, N)
    # C[k, a, c, n] = sum_b Li[a, b, n] B[k, b, c, n]
    C = (Li[None, :, :, None, :] * B[:, None]).sum(dim=2)
    Lj = linv[:, nb.long()]                               # [D*D, K, N]
    Lj = Lj.view(D, D, K, N).permute(2, 0, 1, 3)          # [K, d, c, N]
    # S[k, a, d, n] = sum_c C[k, a, c, n] Lj[k, d, c, n]
    S = (C[:, :, None] * Lj[:, None]).sum(dim=3).reshape(K, D * D, N)
    empty = (values == 0).all(dim=1, keepdim=True)        # [K, 1, N]
    empty[0] = False
    return torch.where(empty, torch.zeros((), dtype=S.dtype, device=S.device),
                       S)


def jacobi_scale(nb, values, linv, extra):
    """The Jacobi-scaled, damped values [K, D*D, N] from the undamped
    `values`, the inverse factors `linv` [D*D, N] (D = 3 or 6) and the
    damping `extra` [N]. K4 on CUDA tensors, the plain version on CPU
    tensors."""
    K, N = nb.shape
    require(linv.dim() == 2 and linv.shape[1] == N and extra.shape == (N,),
            f"jacobi_scale: linv must be [D*D, {N}] and extra [{N}]")
    D = block_width("jacobi_scale", linv.shape[0])
    require(linv.shape[0] == D * D and values.shape == (K, D * D, N),
            f"jacobi_scale: values shape {tuple(values.shape)} != "
            f"{(K, D * D, N)}")
    check_tensors("jacobi_scale", values.device, values.dtype,
                  {"values": values, "linv": linv, "extra": extra},
                  {"nb": nb})
    if not launch_device("jacobi_scale", values.device):
        return jacobi_scale_plain(nb, values, linv, extra)
    out = torch.empty_like(values)
    if N == 0:
        return out
    build.launch("g2o_jacobi_scale", values, nb.data_ptr(), values.data_ptr(),
                 linv.data_ptr(), extra.data_ptr(), out.data_ptr(), N, K, D)
    jacobi_scale.launches += 1
    return out


jacobi_scale.launches = 0


def lane_block_mv_plain(mats, x, transpose=False):
    """y[a, n] = sum_b M[a, b, n] x[b, n] (transpose: M^T x), M as the
    lane-major [D*D, N] table."""
    D = x.shape[0]
    M = mats.view(D, D, -1)
    if transpose:
        return (M * x[:, None, :]).sum(dim=0)
    return (M * x[None]).sum(dim=1)


def _check_mv(name, mats, x, widths):
    """(D, N) of a table and vector the kernels take, D in `widths`; called
    once per CG iteration, so the messages are built only when a check
    fails."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [D, N]")
    D, N = x.shape
    if D not in widths or mats.shape != (D * D, N):
        raise ValueError(f"{name}: mats must be [D*D, N] and x [D, N] with "
                         f"D in {widths}, got {tuple(mats.shape)} and "
                         f"{tuple(x.shape)}")
    if D * D * N >= 2 ** 31:
        raise ValueError(f"{name}: D*D*N must be below 2^31")
    check_tensors(name, x.device, x.dtype, {"mats": mats, "x": x}, {})
    return D, N


def lane_block_mv(mats, x, transpose=False):
    """Apply every row's DxD block to its D-vector: mats [D*D, N], x [D, N]
    -> [D, N], D in MV_WIDTHS: 2 (the point_xy group of LM-PCG over several
    vertex groups), 3 and 6 (the unscale and warm start of LM-PCG); the
    Schur routes' preconditioner runs `lane_block_mv_dot`. The kernel on
    CUDA tensors, the plain version on CPU tensors."""
    D, N = _check_mv("lane_block_mv", mats, x, MV_WIDTHS)
    if not launch_device("lane_block_mv", x.device):
        return lane_block_mv_plain(mats, x, transpose)
    y = torch.empty_like(x)
    if N == 0:
        return y
    build.launch("g2o_lane_block_mv", x, mats.data_ptr(), x.data_ptr(),
                 y.data_ptr(), N, int(bool(transpose)), D)
    lane_block_mv.launches += 1
    lane_block_mv.launches_by_width[D] += 1
    return y


lane_block_mv.launches = 0
lane_block_mv.launches_by_width = collections.Counter()


def lane_block_mv_dot_plain(mats, r):
    """Plain version of `lane_block_mv_dot`: lane_block_mv_plain, then
    cg_step's dot_partials_plain (one partial)."""
    z = lane_block_mv_plain(mats, r)
    return z, dot_partials_plain(r, z)


def lane_block_mv_dot(mats, r):
    """(z, partials): z = M r per row (mats [D*D, N], r [D, N], D in
    MV_DOT_WIDTHS) and the partial sums of r . z, one per cg_step.CHUNK
    values of the flat vector on the card (their sum, in order, is the dot
    product): the bits of cg_step.dot_partials(r, z), z summed as
    lane_block_mv sums a row, in one launch. The kernel on CUDA tensors,
    the plain version on CPU tensors."""
    D, N = _check_mv("lane_block_mv_dot", mats, r, MV_DOT_WIDTHS)
    if not launch_device("lane_block_mv_dot", r.device):
        return lane_block_mv_dot_plain(mats, r)
    z = torch.empty_like(r)
    partials = torch.empty(max((D * N + CHUNK - 1) // CHUNK, 1),
                           dtype=r.dtype, device=r.device)
    if N == 0:
        return z, partials.zero_()
    build.launch("g2o_lane_block_mv_dot", r, mats.data_ptr(), r.data_ptr(),
                 z.data_ptr(), partials.data_ptr(), N, D)
    lane_block_mv_dot.launches += 1
    lane_block_mv_dot.launches_by_width[D] += 1
    return z, partials


lane_block_mv_dot.launches = 0
lane_block_mv_dot.launches_by_width = collections.Counter()
