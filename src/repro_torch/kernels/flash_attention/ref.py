"""Plain PyTorch flash attention (transcribed from
``repro.kernels.flash_attention.ref``): causal, sliding-window and
softcap masks, GQA, f32 softmax."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: masked rows stay NaN-free


def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: Optional[int], q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; ``q_offset`` positions queries globally."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= q_pos >= k_pos
    if window is not None:
        m &= (q_pos - k_pos) < window
    return m


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv)
    -> (B, Hq, Sq, Dv)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)
