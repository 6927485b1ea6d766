"""Kernel C: deterministic contributor-gather assembly
(csrc/assemble_gather.cu).

Replaces `_assemble_pair` / `_assemble_b` (openslam_g2o_tpu/core/sparse.py
:646-678, :696-728), the gather form of `assemble_hot` (:1045-1140). It
sums the per-edge streams of the linearizer (kernel B for SE2, K16 for SE3)
into the block-ELL values [K, D*D, N] and the gradient b [D, N] (D = 3 or 6,
read from the streams' row counts) through the host-built destination-major
tables
hidx [mh, K*N] and bidx [mb, N] (column ids, -1 after the last
contribution; core/sparse.py build_ell_pattern).
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    block_width, check_tensors, launch_device, require)


def _gather_sum(stream, idx):
    """sum_m stream[:, idx[m, d]] over the valid (>= 0) entries of each
    destination d, in table order."""
    g = stream[:, idx.clamp_min(0).long()]                # [R, M, D]
    g = torch.where(idx[None] >= 0, g, torch.zeros((), dtype=g.dtype,
                                                     device=g.device))
    return g.sum(dim=1)


def assemble_gather_plain(hblk, bblk, hidx, bidx, k, n):
    """Plain PyTorch version of kernel C: (values [k, D*D, n], b [D, n])."""
    values = _gather_sum(hblk, hidx).view(hblk.shape[0], k, n).permute(1, 0, 2)
    return values.contiguous(), _gather_sum(bblk, bidx)


def assemble_gather(hblk, bblk, hidx, bidx, k, n):
    """Assemble H (block-ELL values [k, D*D, n]) and b [D, n] from the
    per-edge streams hblk [D*D, 4 T] and bblk [D, 2 T]; kernel C on CUDA
    tensors, the plain version on CPU tensors."""
    e_total = hblk.shape[1] // 4
    D = block_width("assemble_gather", bblk.shape[0])
    require(hblk.shape == (D * D, 4 * e_total)
            and bblk.shape == (D, 2 * e_total),
            "assemble_gather: hblk must be [D*D, 4 T] and bblk [D, 2 T]")
    require(hidx.dim() == 2 and hidx.shape[1] == k * n,
            f"assemble_gather: hidx must be [mh, {k * n}]")
    require(bidx.dim() == 2 and bidx.shape[1] == n,
            f"assemble_gather: bidx must be [mb, {n}]")
    check_tensors("assemble_gather", hblk.device, hblk.dtype,
                  {"hblk": hblk, "bblk": bblk}, {"hidx": hidx, "bidx": bidx})
    if not launch_device("assemble_gather", hblk.device):
        return assemble_gather_plain(hblk, bblk, hidx, bidx, k, n)
    values = torch.empty((k, D * D, n), dtype=hblk.dtype, device=hblk.device)
    b = torch.empty((D, n), dtype=hblk.dtype, device=hblk.device)
    if n == 0:
        return values, b
    build.launch("g2o_assemble_gather", hblk, hblk.data_ptr(), bblk.data_ptr(),
                 hidx.data_ptr(), bidx.data_ptr(), values.data_ptr(),
                 b.data_ptr(), n, k, hidx.shape[0], bidx.shape[0], e_total, D)
    assemble_gather.launches += 1
    return values, b


assemble_gather.launches = 0
