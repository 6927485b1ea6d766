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
