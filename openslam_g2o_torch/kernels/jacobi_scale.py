"""K4: symmetric block-Jacobi scaling of the damped block-ELL Hessian, and
the per-row 3x3 block application around the CG solve
(csrc/jacobi_scale.cu).

`jacobi_scale` replaces `hot_add_diag` + `hot_scale_jacobi`
(openslam_g2o_tpu/core/sparse.py:1173-1247): S[k, :, n] = M_n (B[k, :, n] +
[k = 0] extra[n] I) M_{nb[k, n]}^T with M = L^-1 of the damped diagonal
blocks, so the scaled system has unit diagonal blocks. `lane_block_mv`
replaces `lane_block_mv` (core/sparse.py:871-880). Factor tables are
lane-major [9, N] (entry 3a+b of row n), as K3 writes them.

An off-diagonal slot whose nine entries are all zero (every padding slot)
is exactly zero in the output whatever the factors hold. The JAX code
multiplies it out, so a NaN factor of row 0 turns the padding of every row
into NaN there; both ways the solve fails and LM retries, but here a NaN
stays where it arose.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)


def add_diag_plain(values, extra):
    """values with `extra` [N] folded into the diagonal of every row's
    diagonal block (slot 0; sparse.py:1173-1201), as a damped copy."""
    out = values.clone()
    out[0, 0::4] += extra[None]          # entries (0,0), (1,1), (2,2)
    return out


def jacobi_scale_plain(nb, values, linv, extra):
    """Plain PyTorch version of K4 (sparse.py:1204-1247 on one layout)."""
    K, N = nb.shape
    B = add_diag_plain(values, extra).view(K, 3, 3, N)
    Li = linv.view(3, 3, N)
    # C[k, a, c, n] = sum_b Li[a, b, n] B[k, b, c, n]
    C = (Li[None, :, :, None, :] * B[:, None]).sum(dim=2)
    Lj = linv[:, nb.long()]                               # [9, K, N]
    Lj = Lj.view(3, 3, K, N).permute(2, 0, 1, 3)          # [K, d, c, N]
    # S[k, a, d, n] = sum_c C[k, a, c, n] Lj[k, d, c, n]
    S = (C[:, :, None] * Lj[:, None]).sum(dim=3).reshape(K, 9, N)
    empty = (values == 0).all(dim=1, keepdim=True)        # [K, 1, N]
    empty[0] = False
    return torch.where(empty, torch.zeros((), dtype=S.dtype, device=S.device),
                       S)


def jacobi_scale(nb, values, linv, extra):
    """The Jacobi-scaled, damped values [K, 9, N] from the undamped
    `values`, the inverse factors `linv` [9, N] and the damping `extra`
    [N]. K4 on CUDA tensors, the plain version on CPU tensors."""
    K, N = nb.shape
    require(values.shape == (K, 9, N),
            f"jacobi_scale: values shape {tuple(values.shape)} != {(K, 9, N)}")
    require(linv.shape == (9, N) and extra.shape == (N,),
            f"jacobi_scale: linv must be [9, {N}] and extra [{N}]")
    check_tensors("jacobi_scale", values.device, values.dtype,
                  {"values": values, "linv": linv, "extra": extra},
                  {"nb": nb})
    if not launch_device("jacobi_scale", values.device):
        return jacobi_scale_plain(nb, values, linv, extra)
    out = torch.empty_like(values)
    if N == 0:
        return out
    build.launch("g2o_jacobi_scale", values, nb.data_ptr(), values.data_ptr(),
                 linv.data_ptr(), extra.data_ptr(), out.data_ptr(), N, K)
    jacobi_scale.launches += 1
    return out


jacobi_scale.launches = 0


def lane_block_mv_plain(mats, x, transpose=False):
    """y[a, n] = sum_b M[a, b, n] x[b, n] (transpose: M^T x), M as the
    lane-major [9, N] table."""
    M = mats.view(3, 3, -1)
    if transpose:
        return (M * x[:, None, :]).sum(dim=0)
    return (M * x[None]).sum(dim=1)


def lane_block_mv(mats, x, transpose=False):
    """Apply every row's 3x3 block to its 3-vector: mats [9, N], x [3, N]
    -> [3, N]. The kernel on CUDA tensors, the plain version on CPU
    tensors."""
    N = x.shape[1] if x.dim() == 2 else -1
    require(x.shape == (3, N) and mats.shape == (9, N),
            f"lane_block_mv: mats must be [9, N] and x [3, N], got "
            f"{tuple(mats.shape)} and {tuple(x.shape)}")
    check_tensors("lane_block_mv", x.device, x.dtype,
                  {"mats": mats, "x": x}, {})
    if not launch_device("lane_block_mv", x.device):
        return lane_block_mv_plain(mats, x, transpose)
    y = torch.empty_like(x)
    if N == 0:
        return y
    build.launch("g2o_lane_block_mv", x, mats.data_ptr(), x.data_ptr(),
                 y.data_ptr(), N, int(bool(transpose)))
    lane_block_mv.launches += 1
    return y


lane_block_mv.launches = 0
