"""Kernel A: 3x3 block-ELL SpMV, y = H x (csrc/block_ell_spmv.cu).

Replaces the TPU probe kernel `spmv_kernel` (scripts/probe_pallas_gather.py
:77-97) and the JAX CG matvec `ell_matvec_lane(_kmajor_hot)`
(openslam_g2o_tpu/core/sparse.py:883-908, :1309-1354). Layout: nb [K, N]
int32, values [K, 9, N] (block entry 3s+t of slot k of row n), x and y
[3, N]; padding slots point at column 0 with zero values.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device)


def block_ell_spmv_plain(nb, values, x):
    """y[s, n] = sum_k sum_t values[k, 3s+t, n] * x[t, nb[k, n]]."""
    K, N = nb.shape
    xg = x[:, nb.long()]                                  # [3, K, N]
    V = values.view(K, 3, 3, N)
    return (V * xg.permute(1, 0, 2)[:, None]).sum(dim=(0, 2))


def block_ell_spmv(nb, values, x):
    """y = H x on the block-ELL layout; kernel A on CUDA tensors, the plain
    version on CPU tensors."""
    K, N = nb.shape
    if values.shape != (K, 9, N):      # per CG matvec: no eager messages
        raise ValueError(f"block_ell_spmv: values shape "
                         f"{tuple(values.shape)} != {(K, 9, N)}")
    if x.shape != (3, N):
        raise ValueError(f"block_ell_spmv: x shape {tuple(x.shape)} != "
                         f"{(3, N)}")
    check_tensors("block_ell_spmv", x.device, x.dtype,
                  {"values": values, "x": x}, {"nb": nb})
    if not launch_device("block_ell_spmv", x.device):
        return block_ell_spmv_plain(nb, values, x)
    y = torch.empty_like(x)
    if N == 0:
        return y
    build.launch("g2o_block_ell_spmv", x, nb.data_ptr(), values.data_ptr(),
                 x.data_ptr(), y.data_ptr(), N, K)
    block_ell_spmv.launches += 1
    return y


block_ell_spmv.launches = 0
