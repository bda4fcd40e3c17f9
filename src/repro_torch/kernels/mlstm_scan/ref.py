"""Plain PyTorch mLSTM matrix-memory recurrence, stabilized (transcribed
from ``repro.kernels.mlstm_scan.ref``).

Per head (xLSTM paper eqs. 19-27):
    m_t = max(log_sig(f_t) + m_{t-1}, i_t)                (stabilizer)
    i'  = exp(i_t - m_t);  f' = exp(log_sig(f_t) + m_{t-1} - m_t)
    C_t = f' C_{t-1} + i' k_t v_t^T
    n_t = f' n_{t-1} + i' k_t
    h_t = (C_t^T q_t) / max(|n_t . q_t|, exp(-m_t))

with q and k scaled by Dk^-0.5.  Shapes: q, k (B, H, S, Dk); v (B, H,
S, Dv); i, f (B, H, S) pre-activations.  The scan starts from C = 0,
n = 0 and m = -inf, as the reference's does (the first step then takes
f' = 0 and i' = 1 whatever its gates); a decode cache starts at m =
-1e30 instead (``models/xlstm.py::mlstm_cache``), as the reference's
does.  Both give the same first step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                   return_state: bool = False):
    """Exactly S steps in f32; returns h (B, H, S, Dv) in q's dtype, and
    with ``return_state`` also the final (C (B, H, Dk, Dv), n (B, H,
    Dk), m (B, H)), all f32."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    qf = q.float() * scale
    kf = k.float() * scale
    vf = v.float()
    ig = i_gate.float()
    fg = F.logsigmoid(f_gate.float())
    dev = q.device
    c = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=dev)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=dev)
    hs = []
    for t in range(s):
        qt, kt, vt = qf[:, :, t], kf[:, :, t], vf[:, :, t]
        it, ft = ig[:, :, t], fg[:, :, t]
        m_new = torch.maximum(ft + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + m - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            kt[..., :, None] * vt[..., None, :])
        n = f_p[..., None] * n + i_p[..., None] * kt
        num = torch.einsum("bhkv,bhk->bhv", c, qt)
        den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                            torch.exp(-m_new))
        hs.append(num / den[..., None])
        m = m_new
    out = (torch.stack(hs, dim=2) if hs
           else vf.new_zeros((b, h, 0, dv))).to(q.dtype)
    if return_state:
        return out, (c, n, m)
    return out
