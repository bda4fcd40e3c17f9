"""Plain PyTorch selective scan (transcribed from
``repro.kernels.mamba_scan.ref``): the diagonal SSM recurrence of mamba
layers.

    h_t = exp(A * dt_t) * h_{t-1} + (dt_t * x_t) B_t^T      (outer product)
    y_t = h_t C_t + D * x_t

with A (d_inner, d_state) the negative log-decay and dt already
softplus-activated by the caller.  Shapes: x/dt (B, S, d_inner); Bm/Cm
(B, S, d_state); D (d_inner,).
"""
from __future__ import annotations

from typing import Optional

import torch


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor, *,
                   h0: Optional[torch.Tensor] = None):
    """Exactly S steps in f32 from ``h0`` (zeros by default); returns
    (y (B, S, d_inner) in x's dtype, h_T (B, d_inner, d_state) f32)."""
    b, s, d_inner = x.shape
    d_state = A.shape[1]
    xf, dtf = x.float(), dt.float()
    bf, cf = Bm.float(), Cm.float()
    af, df = A.float(), D.float()
    h = (torch.zeros((b, d_inner, d_state), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        xt, dtt = xf[:, t], dtf[:, t]                     # (B, d)
        decay = torch.exp(af[None] * dtt[:, :, None])     # (B, d, n)
        h = decay * h + (dtt * xt)[:, :, None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]) + df[None] * xt)
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros((b, 0, d_inner))
    return y.to(x.dtype), h
