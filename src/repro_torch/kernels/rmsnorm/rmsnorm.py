"""Launcher of the CUDA RMSNorm kernel (``csrc/rmsnorm.cu``, written
against the device runtime), and of its native twin's, which takes the
same arguments (``native.py``)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

KERNEL = CudaKernel(
    "rmsnorm", "rmsnorm.cu", "rmsnorm_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor, *, eps: float,
                weight_offset: float,
                kernel: CudaKernel = KERNEL) -> torch.Tensor:
    d = x.shape[-1]
    if w.shape != (d,) or w.dtype != x.dtype:
        raise ValueError(f"rmsnorm: w must be ({d},) {x.dtype}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    check_cuda("rmsnorm", x, w)
    y = torch.empty_like(x)
    kernel.launch(ptr(x), ptr(w), ptr(y), x.numel() // max(d, 1), d,
                  float(eps), float(weight_offset), dtype_code(x),
                  stream_of(x))
    return y
