"""Public grouped-matmul op (forward only: serving needs no backward).

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel (``csrc/gmm.cu``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gmm import gmm as _kern
from repro_torch.kernels.gmm import ref as _ref
from repro_torch.obs.profile import device_op

#: Tolerance of the reference op (``repro.kernels.gmm.ops``), f32.
TOL = {"atol": 2e-4, "rtol": 2e-4}


@device_op
def gmm(lhs: torch.Tensor, rhs: torch.Tensor,
        group_sizes: torch.Tensor) -> torch.Tensor:
    """(E, C, K) @ (E, K, N) -> (E, C, N) in lhs's dtype, summed in f32,
    with rows >= ``group_sizes[e]`` of expert ``e`` written as 0."""
    if lhs.device.type == "cpu":
        return _ref.gmm_ref(lhs, rhs, group_sizes)
    return _kern.gmm_fwd(lhs, rhs, group_sizes)
