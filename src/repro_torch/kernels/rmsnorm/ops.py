"""Public RMSNorm op: a CPU tensor takes the plain version, a CUDA
tensor the hand-written kernel (which raises on what it cannot take)."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import ref as _ref
from repro_torch.kernels.rmsnorm import rmsnorm as _kern
from repro_torch.obs.profile import device_op

#: Tolerance of the reference op (``repro.kernels.rmsnorm.ops``), f32.
TOL = {"atol": 1e-5, "rtol": 1e-5}


@device_op
def rmsnorm(x: torch.Tensor, w: torch.Tensor, *, eps: float = 1e-6,
            weight_offset: float = 0.0) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (w + weight_offset)."""
    if x.device.type == "cpu":
        return _ref.rmsnorm_ref(x, w, eps=eps, weight_offset=weight_offset)
    return _kern.rmsnorm_fwd(x, w, eps=eps, weight_offset=weight_offset)
