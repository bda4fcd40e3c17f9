"""RMSNorm the pre-paper way, hard-coded against CUDA (B11a): the
counterpart of ``repro.kernels.rmsnorm.native``.

``csrc/native/rmsnorm_native.cu`` computes what ``csrc/rmsnorm.cu``
computes, in the same order, without the device runtime, so the two
give bit-identical outputs; ``repro_torch.bench.parity`` holds them so
and compares their SASS.  A CPU tensor takes the plain version
(``ref.py``), a CUDA tensor the kernel, which raises on what it cannot
take.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.build import CudaKernel
from repro_torch.kernels.rmsnorm import ref as _ref
from repro_torch.kernels.rmsnorm import rmsnorm as _kern

KERNEL = CudaKernel(
    "rmsnorm_native", "native/rmsnorm_native.cu", "rmsnorm_native_fwd",
    [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def rmsnorm_native(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                   weight_offset: float = 0.0) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (w + weight_offset)."""
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, w, eps=eps, weight_offset=weight_offset)
    return _kern.rmsnorm_fwd(x, w, eps=eps, weight_offset=weight_offset,
                             kernel=KERNEL)
