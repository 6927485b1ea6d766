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
    float64), ints int32; `floats`/`ints` map argument name -> tensor."""
    require(dtype in FLOAT_TYPES,
            f"{name}: dtype must be float32 or float64, got {dtype}")
    for arg, t in {**floats, **ints}.items():
        require(t.device == device,
                f"{name}: {arg} is on {t.device}, expected {device}")
        require(t.is_contiguous(), f"{name}: {arg} must be contiguous")
    for arg, t in floats.items():
        require(t.dtype == dtype,
                f"{name}: {arg} has dtype {t.dtype}, expected {dtype}")
    for arg, t in ints.items():
        require(t.dtype == torch.int32,
                f"{name}: {arg} must be int32, got {t.dtype}")


def launch_device(name: str, device: torch.device):
    """Raise unless the tensors are on the CPU (plain path) or a CUDA card
    (kernel path)."""
    require(device.type in ("cpu", "cuda"),
            f"{name}: unsupported device {device}")
    return device.type == "cuda"
