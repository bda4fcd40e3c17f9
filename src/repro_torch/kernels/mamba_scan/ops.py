"""Public selective-scan op (forward only: serving needs no backward).

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel (``csrc/mamba_scan.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mamba_scan import mamba_scan as _kern
from repro_torch.kernels.mamba_scan import ref as _ref
from repro_torch.obs.profile import device_op

#: Tolerance of the reference op (``repro.kernels.mamba_scan.ops``), f32.
TOL = {"atol": 1e-4, "rtol": 1e-4}


@device_op
def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor):
    """Selective scan; returns (y (B, S, d_inner) in x's dtype, h_T
    (B, d_inner, d_state) f32)."""
    if x.device.type == "cpu":
        return _ref.mamba_scan_ref(x, dt, A, Bm, Cm, D)
    return _kern.mamba_scan_fwd(x, dt, A, Bm, Cm, D)
