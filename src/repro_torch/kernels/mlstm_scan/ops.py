"""Public mLSTM scan op (forward only: serving and the loss need no
backward).

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel (``csrc/mlstm_scan.cu``).  ``return_state`` also returns the
final (C, n, m): the TPU kernel has no such output, so the reference's
serving prefill runs its plain scan for it; the port's kernel has one,
so its prefill on the card runs the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.mlstm_scan import mlstm_scan as _kern
from repro_torch.kernels.mlstm_scan import ref as _ref
from repro_torch.obs.profile import device_op

#: Tolerance of the reference op (``repro.kernels.mlstm_scan.ops``), f32.
TOL = {"atol": 2e-4, "rtol": 2e-4}


@device_op
def mlstm_scan(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               i_gate: torch.Tensor, f_gate: torch.Tensor, *,
               return_state: bool = False):
    """Stabilized mLSTM: q, k (B, H, S, Dk), v (B, H, S, Dv), gates
    (B, H, S) -> h (B, H, S, Dv), or (h, (C, n, m)) with
    ``return_state``."""
    if q.device.type == "cpu":
        return _ref.mlstm_scan_ref(q, k, v, i_gate, f_gate,
                                   return_state=return_state)
    return _kern.mlstm_scan_fwd(q, k, v, i_gate, f_gate,
                                return_state=return_state)
