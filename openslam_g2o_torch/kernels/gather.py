"""Lane gather out[r, m] = x[r, idx[r, m]] (csrc/lane_gather.cu).

Replaces the TPU probe kernel `gather_kernel` / `pallas_gather`
(scripts/probe_pallas_gather.py:47-59). No path of the package calls it
(kernel A and the Jacobi scaling gather inside themselves); it is the
counterpart of the probe, which composes a block-ELL SpMV from this gather
and a multiply-sum and holds it against the fused kernel.
"""
from __future__ import annotations

import torch

from openslam_g2o_torch.kernels import build
from openslam_g2o_torch.kernels._checks import (
    check_tensors, launch_device, require)


def lane_gather_plain(x, idx):
    return torch.gather(x, 1, idx.long())


def lane_gather(x, idx):
    """x [R, N], idx [R, M] int32 with entries in [0, N) -> out [R, M]; the
    kernel on CUDA tensors, the plain version on CPU tensors. The indices
    are not range-checked on the card."""
    require(x.dim() == 2 and idx.dim() == 2 and idx.shape[0] == x.shape[0],
            f"lane_gather: x must be [R, N] and idx [R, M], got "
            f"{tuple(x.shape)} and {tuple(idx.shape)}")
    check_tensors("lane_gather", x.device, x.dtype, {"x": x}, {"idx": idx})
    if not launch_device("lane_gather", x.device):
        return lane_gather_plain(x, idx)
    R, N = x.shape
    M = idx.shape[1]
    out = torch.empty((R, M), dtype=x.dtype, device=x.device)
    if R * M == 0:
        return out
    build.launch("g2o_lane_gather", x, x.data_ptr(), idx.data_ptr(),
                 out.data_ptr(), R, N, M)
    lane_gather.launches += 1
    return out


lane_gather.launches = 0
