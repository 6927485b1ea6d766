"""Argument checks shared by the kernel wrappers: the CUDA kernels take raw
pointers, so device, dtype, shape and contiguity are validated here."""
from __future__ import annotations

import torch

FLOAT_TYPES = (torch.float32, torch.float64)


def require(cond: bool, what: str):
    if not cond:
        raise ValueError(what)


def check_tensors(name: str, device: torch.device, dtype: torch.dtype,
                  floats: dict, ints: dict):
    """All tensors on `device` and contiguous; floats in `dtype` (float32 or
    float64), ints int32; `floats`/`ints` map argument name -> tensor.
    The wrappers call this on every launch, in the CG loop too, so the
    messages are only built when a check fails."""
    if dtype not in FLOAT_TYPES:
        raise ValueError(f"{name}: dtype must be float32 or float64, got "
                         f"{dtype}")
    for group, want in ((floats, dtype), (ints, torch.int32)):
        for arg, t in group.items():
            if t.device != device:
                raise ValueError(f"{name}: {arg} is on {t.device}, expected "
                                 f"{device}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: {arg} must be contiguous")
            if t.dtype != want:
                raise ValueError(
                    f"{name}: {arg} has dtype {t.dtype}, expected {dtype}"
                    if want is dtype else
                    f"{name}: {arg} must be int32, got {t.dtype}")


def check_vectors(name: str, first: torch.Tensor, **others):
    """Vectors of one shape, device and dtype (that of `first`), contiguous;
    called per CG iteration, so the message is only built on failure."""
    for arg, t in others.items():
        if t.shape != first.shape:
            raise ValueError(f"{name}: {arg} shape {tuple(t.shape)} != "
                             f"{tuple(first.shape)}")
    check_tensors(name, first.device, first.dtype, others, {})


def launch_device(name: str, device: torch.device):
    """Raise unless the tensors are on the CPU (plain path) or a CUDA card
    (kernel path)."""
    require(device.type in ("cpu", "cuda"),
            f"{name}: unsupported device {device}")
    return device.type == "cuda"


BLOCK_WIDTHS = (3, 6)        # the instantiations of the block-ELL kernels


def block_width(name: str, rows: int) -> int:
    """The block width D of a lane-major table with D or D*D rows; raises
    unless a kernel is instantiated for it (3: SE2 poses, 6: SE3 poses)."""
    for d in BLOCK_WIDTHS:
        if rows in (d, d * d):
            return d
    raise ValueError(f"{name}: shape not served: a table of {rows} rows fits "
                     f"no block width in {BLOCK_WIDTHS} ([D, N] or "
                     "[D*D, N])")


# the block widths of the pair kernels (kernels/pair_ell.py) and of K3 and
# K4's `lane_block_mv` on LM-PCG over several vertex groups: point_xy (2),
# se2 / point_xyz (3), se3 / se3_expmap (6)
PAIR_WIDTHS = (2, 3, 6)


def pair_width(name: str, d: int) -> int:
    """d itself if the pair kernels are instantiated for block width d,
    else ValueError."""
    if d not in PAIR_WIDTHS:
        raise ValueError(f"{name}: block width {d} not served: the pair "
                         f"kernels are instantiated for {PAIR_WIDTHS}")
    return d
