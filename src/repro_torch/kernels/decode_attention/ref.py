"""Plain PyTorch single-token decode attention over dense or paged KV
(transcribed from ``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         return_residuals: bool = False):
    """q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) int32.

    The query is the token at position ``lengths[b] - 1``.  Returns
    (B, Hq, D) in q's dtype, or the unnormalized f32 residuals
    (acc (B, Hq, D), m (B, Hq), l (B, Hq)).
    """
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    qf = q.float() * scale
    kf = k_cache.float().repeat_interleave(group, dim=1)
    vf = v_cache.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    k_pos = torch.arange(s, device=q.device)[None, None, :]
    lengths = lengths.long()
    mask = k_pos < lengths[:, None, None]
    if window is not None:
        q_pos = (lengths - 1)[:, None, None]
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))

    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhk,bhkd->bhd", p, vf)
    if return_residuals:
        return acc, m[..., 0], l[..., 0]
    return normalize(acc, l[..., 0], q.dtype)


def normalize(acc, l, dtype):
    """acc / l with the ``l == 0 -> 1`` guard: a row with no live key
    (length 0) comes out as 0."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).to(dtype)


def gather_pages(pages, block_tables):
    """(Hkv, P, ps, D) pool + (B, T) table -> dense (B, Hkv, T*ps, D)."""
    h, _, ps, d = pages.shape
    b, t = block_tables.shape
    gath = pages.index_select(1, block_tables.reshape(-1).long())
    return gath.reshape(h, b, t * ps, d).transpose(0, 1)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths, *,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None,
                               return_residuals: bool = False):
    """Gather the pages dense, then the dense plain version: paging is
    semantically invisible."""
    return decode_attention_ref(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), lengths, window=window,
        softcap=softcap, scale=scale, return_residuals=return_residuals)
