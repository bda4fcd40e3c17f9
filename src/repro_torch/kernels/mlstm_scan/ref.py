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

``mlstm_scan_ref(..., chunk=L)`` is the chunkwise form the kernel's
bf16 body computes (xLSTM's parallel form within a chunk of L steps,
the recurrent one across chunks), its plain version at its chunk:
per chunk, with m walked step by step as above, F the cumulative
log_sig(f) from the chunk's first step and m_in the stabilizer carried
in,
    D[t, s] = exp(F_t - F_s + i_s - m_t)  (s <= t, else 0)
    g_t     = exp(F_t + m_in - m_t)
    h_t     = (sum_s D[t, s] (q_t . k_s) v_s + g_t C^T q_t)
              / max(|sum_s D[t, s] (q_t . k_s) + g_t n . q_t|, exp(-m_t))
    C      <- g_L C + sum_s exp(F_L - F_s + i_s - m_L) k_s v_s^T
and n in the same way (L the chunk's last step).  Every weight is at
most 1, by the definition of m.  q and k enter raw, and Dk^-0.5 (once
for C, n and the carried-in terms, twice for q . k) multiplies the f32
sums, as in the kernel.  The last chunk may be short.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def mlstm_scan_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                   return_state: bool = False, chunk: int | None = None):
    """Exactly S steps in f32; returns h (B, H, S, Dv) in q's dtype, and
    with ``return_state`` also the final (C (B, H, Dk, Dv), n (B, H,
    Dk), m (B, H)), all f32.  ``chunk``: the chunkwise form over chunks
    of that many steps instead of the step-by-step recurrence."""
    if chunk is not None:
        return _chunkwise(q, k, v, i_gate, f_gate, chunk, return_state)
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


def _chunkwise(q, k, v, i_gate, f_gate, chunk: int, return_state: bool):
    """The chunkwise form of the module docstring, in f32."""
    if chunk < 1:
        raise ValueError(f"mlstm_scan_ref: chunk must be >= 1, got {chunk}")
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    scale = dk ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    ig = i_gate.float()
    fg = F.logsigmoid(f_gate.float())
    dev = q.device
    c = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=dev)
    n = torch.zeros((b, h, dk), dtype=torch.float32, device=dev)
    m = torch.full((b, h), float("-inf"), dtype=torch.float32, device=dev)
    hs = []
    for t0 in range(0, s, chunk):
        t1 = min(t0 + chunk, s)
        ic, fc = ig[..., t0:t1], fg[..., t0:t1]
        # the stabilizer and the cumulative forget gate, step by step
        ms, fs = [], []
        mt, ft = m, torch.zeros_like(m)
        for t in range(t1 - t0):
            mt = torch.maximum(fc[..., t] + mt, ic[..., t])
            ft = ft + fc[..., t]
            ms.append(mt)
            fs.append(ft)
        mt, ft = torch.stack(ms, -1), torch.stack(fs, -1)     # (B, H, L)
        live = torch.ones(t1 - t0, t1 - t0, dtype=torch.bool,
                          device=dev).tril()
        expo = (ft[..., :, None] - ft[..., None, :] + ic[..., None, :]
                - mt[..., :, None])
        d = torch.where(live, torch.exp(torch.where(live, expo, 0.0)), 0.0)
        g = torch.exp(ft + m[..., None] - mt)                  # (B, H, L)
        qc, kc, vc = qf[..., t0:t1, :], kf[..., t0:t1, :], vf[..., t0:t1, :]
        ds = d * (qc @ kc.transpose(-1, -2)) * (scale * scale)
        gs = g * scale
        num = ds @ vc + gs[..., None] * (qc @ c)
        den = ds.sum(-1) + gs * (qc @ n[..., None])[..., 0]
        hs.append(num / torch.maximum(den.abs(), torch.exp(-mt))[..., None])
        w = torch.exp(ft[..., -1:] - ft + ic - mt[..., -1:]) * scale
        gl = g[..., -1]
        c = gl[..., None, None] * c + (kc * w[..., None]).transpose(-1, -2) @ vc
        n = gl[..., None] * n + (kc * w[..., None]).sum(-2)
        m = mt[..., -1]
    out = (torch.cat(hs, dim=2) if hs
           else vf.new_zeros((b, h, 0, dv))).to(q.dtype)
    if return_state:
        return out, (c, n, m)
    return out
