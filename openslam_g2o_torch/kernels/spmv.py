"""Kernel A: DxD block-ELL SpMV, y = H x, for D = 3 (SE2 poses) and D = 6
(SE3 poses) (csrc/block_ell_spmv.cu).

Replaces the TPU probe kernel `spmv_kernel` (scripts/probe_pallas_gather.py
:77-97) and the JAX CG matvec `ell_matvec_lane(_kmajor_hot)`
(openslam_g2o_tpu/core/sparse.py:883-908, :1309-1354). Layout: nb [K, N]
int32, values [K, D*D, N] (block entry D s + t of slot k of row n), x and y
[D, N]; padding slots point at column 0 with zero values.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    BLOCK_WIDTHS, check_tensors, launch_device)


def block_ell_spmv_plain(nb, values, x):
    """y[s, n] = sum_k sum_t values[k, D s + t, n] * x[t, nb[k, n]]."""
    K, N = nb.shape
    D = x.shape[0]
    xg = x[:, nb.long()]                                  # [D, K, N]
    V = values.view(K, D, D, N)
    return (V * xg.permute(1, 0, 2)[:, None]).sum(dim=(0, 2))


def block_ell_spmv(nb, values, x):
    """y = H x on the block-ELL layout; kernel A on CUDA tensors, the plain
    version on CPU tensors."""
    K, N = nb.shape
    D = x.shape[0]
    if D not in BLOCK_WIDTHS or x.shape != (D, N):   # per CG matvec: no
        raise ValueError(f"block_ell_spmv: x shape "   # eager messages
                         f"{tuple(x.shape)} is not [D, {N}] with D in "
                         f"{BLOCK_WIDTHS}")
    if values.shape != (K, D * D, N):
        raise ValueError(f"block_ell_spmv: values shape "
                         f"{tuple(values.shape)} != {(K, D * D, N)}")
    check_tensors("block_ell_spmv", x.device, x.dtype,
                  {"values": values, "x": x}, {"nb": nb})
    if not launch_device("block_ell_spmv", x.device):
        return block_ell_spmv_plain(nb, values, x)
    y = torch.empty_like(x)
    if N == 0:
        return y
    build.launch("g2o_block_ell_spmv", x, nb.data_ptr(), values.data_ptr(),
                 x.data_ptr(), y.data_ptr(), N, K, D)
    block_ell_spmv.launches += 1
    return y


block_ell_spmv.launches = 0
