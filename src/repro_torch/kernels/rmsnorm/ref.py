"""Plain PyTorch RMSNorm (transcribed from ``repro.kernels.rmsnorm.ref``)."""
from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
                weight_offset: float = 0.0) -> torch.Tensor:
    """x: (..., D); w: (D,).  f32 math, cast back to x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * (w.float() + weight_offset)
    return y.to(x.dtype)
