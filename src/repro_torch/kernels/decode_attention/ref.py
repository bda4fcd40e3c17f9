"""Plain PyTorch decode attention over dense, paged, quantized paged,
sliding-window paged and speculative paged KV (transcribed from
``repro.kernels.decode_attention.ref``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.paged import ring_walk

NEG_INF = -1e30


def decode_attention_ref(q, k_cache, v_cache, lengths, *,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         kv_offset=0,
                         chunk: Optional[int] = None,
                         return_residuals: bool = False):
    """q: (B, Hq, D); caches: (B, Hkv, S, D); lengths: (B,) int32.

    The query is the token at position ``lengths[b] - 1``;
    ``kv_offset`` is the global position of cache row 0 (an int, or a
    tensor that broadcasts against (B, 1, S)).  Returns (B, Hq, D) in
    q's dtype, or the unnormalized f32 residuals (acc (B, Hq, D),
    m (B, Hq), l (B, Hq)).

    ``chunk``: the split kernel's rounding model (B3, ``csrc/
    decode_attention.cu``): the residuals of each ``chunk`` cache rows
    on their own, merged by :func:`combine_partials` in chunk order.
    The scores are computed once for the whole cache, as the kernel
    computes each the same way whatever the split, so m equals the
    unsplit m bit for bit.
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
    k_pos = torch.arange(s, device=q.device)[None, None, :] + kv_offset
    lengths = lengths.long()
    mask = k_pos < lengths[:, None, None]
    if window is not None:
        q_pos = (lengths - 1)[:, None, None]
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    acc, m, l = _chunked_residuals(scores, vf, chunk)
    if return_residuals:
        return acc, m, l
    return normalize(acc, l, q.dtype)


def _residuals(scores, vf):
    """(acc, m, l) of masked scores (B, Hq, S), or (B, K1, Hq, S) for
    the speculative rows, over values (B, Hq, S, Dv), with the ``m >
    NEG_INF / 2`` guard of an all-masked row."""
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    p = torch.where(m > NEG_INF / 2, p, torch.zeros_like(p))
    l = p.sum(dim=-1, keepdim=True)
    eq = "bhk,bhkd->bhd" if scores.dim() == 3 else "bihk,bhkd->bihd"
    acc = torch.einsum(eq, p, vf)
    return acc, m[..., 0], l[..., 0]


def _chunked_residuals(scores, vf, chunk: Optional[int]):
    """:func:`_residuals` of the whole key axis, or (``chunk``: a
    split-KV kernel's rounding model) of each ``chunk`` keys on their own,
    merged by :func:`combine_partials` in chunk order.  The scores are
    computed once, as the kernels compute each the same way whatever the
    split, so m equals the unsplit m bit for bit."""
    if chunk is None:
        return _residuals(scores, vf)
    return combine_partials(*zip(*(
        _residuals(scores[..., j:j + chunk], vf[:, :, j:j + chunk])
        for j in range(0, scores.shape[-1], chunk))))


def combine_partials(accs, ms, ls):
    """Merge flash-decode partials (log-sum-exp), in residual form: the
    port's copy of ``repro.kernels.decode_attention.ref.
    combine_partials``, which returns the normalized output instead.

    accs: sequence of (B, Hq, D) f32 unnormalized; ms/ls: of (B, Hq).
    Returns (acc, m, l) with m = max_j m_j, acc = sum_j acc_j e^(m_j - m)
    and l = sum_j l_j e^(m_j - m), summed in order of j.  Where m is not
    live (every partial empty) the weights are 0, so such a row stays
    acc 0, m NEG_INF, l 0, as the kernel leaves it; NaN in a partial's
    acc still reaches the sum."""
    m = torch.stack(list(ms)).amax(dim=0)
    live = m > NEG_INF / 2
    acc = torch.zeros_like(accs[0])
    l = torch.zeros_like(ls[0])
    for acc_j, m_j, l_j in zip(accs, ms, ls):
        w = torch.where(live, torch.exp(m_j - m), torch.zeros_like(m))
        acc = acc + acc_j * w[..., None]
        l = l + l_j * w
    return acc, m, l


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
                               chunk: Optional[int] = None,
                               return_residuals: bool = False):
    """Gather the pages dense, then the dense plain version: paging is
    semantically invisible.  ``chunk``: the split paged kernel's
    rounding model (B4, ``csrc/paged_decode_attention.cu``), chunks of
    ``chunk`` logical rows of each table row merged in order, as
    :func:`decode_attention_ref` models B3's."""
    return decode_attention_ref(
        q, gather_pages(k_pages, block_tables),
        gather_pages(v_pages, block_tables), lengths, window=window,
        softcap=softcap, scale=scale, chunk=chunk,
        return_residuals=return_residuals)


def dequantize_pools(k_pages, v_pages, k_scales, v_scales):
    """int8/fp8 pools (Hkv, P, ps, D) and their (Hkv, P) f32 scales ->
    f32 pools, as ``f32(q) * scale``: the kernels' arithmetic, so kernel
    and plain version agree at float tolerances."""
    return (k_pages.float() * k_scales[:, :, None, None],
            v_pages.float() * v_scales[:, :, None, None])


def quant_paged_decode_attention_ref(q, k_pages, v_pages, k_scales, v_scales,
                                     block_tables, lengths, *,
                                     window: Optional[int] = None,
                                     softcap: Optional[float] = None,
                                     scale: Optional[float] = None,
                                     chunk: Optional[int] = None,
                                     return_residuals: bool = False):
    """Dequantize the pools densely, then the paged plain version
    (``chunk``: B5's split-KV rounding model, as B4's)."""
    k_dense, v_dense = dequantize_pools(k_pages, v_pages, k_scales, v_scales)
    return paged_decode_attention_ref(
        q, k_dense, v_dense, block_tables, lengths, window=window,
        softcap=softcap, scale=scale, chunk=chunk,
        return_residuals=return_residuals)


def window_paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                      lengths, *, window: int,
                                      softcap: Optional[float] = None,
                                      scale: Optional[float] = None,
                                      chunk: Optional[int] = None,
                                      return_residuals: bool = False):
    """Sliding-window decode over ring tables (B, T_w), global page
    ``g`` at column ``g % T_w``: gather the ring walk (``paged.
    ring_walk``) dense, so row 0 is the token at ``start``, then the
    dense plain version with the window mask and that offset.  Stale or
    null columns past the live window land past ``lengths`` and never
    count.  ``chunk``: the split kernel's rounding model (B7, ``csrc/
    window_paged_decode_attention.cu``): each ``chunk`` rows of the walk
    on their own, so the chunks count from ``start``, not from token 0,
    merged in order; a chunk wholly before the window or past the length
    adds nothing to the merge."""
    walk, start = ring_walk(block_tables, lengths, window,
                            k_pages.shape[2])
    return decode_attention_ref(
        q, gather_pages(k_pages, walk), gather_pages(v_pages, walk),
        lengths, window=window, softcap=softcap, scale=scale,
        kv_offset=start.long()[:, None, None], chunk=chunk,
        return_residuals=return_residuals)


def quant_window_paged_decode_attention_ref(q, k_pages, v_pages, k_scales,
                                            v_scales, block_tables, lengths,
                                            *, window: int,
                                            softcap: Optional[float] = None,
                                            scale: Optional[float] = None,
                                            chunk: Optional[int] = None,
                                            return_residuals: bool = False):
    """Dequantize the pools densely, then the window plain version
    (``chunk``: B7q's split-KV rounding model, as B7's)."""
    k_dense, v_dense = dequantize_pools(k_pages, v_pages, k_scales, v_scales)
    return window_paged_decode_attention_ref(
        q, k_dense, v_dense, block_tables, lengths, window=window,
        softcap=softcap, scale=scale, chunk=chunk,
        return_residuals=return_residuals)


def spec_paged_decode_attention_ref(q, k_pages, v_pages, block_tables,
                                    lengths, *,
                                    window: Optional[int] = None,
                                    softcap: Optional[float] = None,
                                    scale: Optional[float] = None,
                                    chunk: Optional[int] = None,
                                    return_residuals: bool = False):
    """Speculative (multi-query) paged decode.

    q: (B, K1, Hq, D), the K1 = k+1 window positions of each slot;
    lengths: (B,) the PRE-speculation prefix.  Position i sits at token
    ``lengths + i`` and attends causally to ``lengths + 1 + i`` tokens
    (the window's K/V rows are written before the verify).  Returns
    (B, K1, Hq, D) in q's dtype, or residuals acc (B, K1, Hq, D), m and
    l (B, K1, Hq).  ``chunk``: the split-KV kernel's rounding model
    (B6, ``csrc/spec_paged_decode_attention.cu``), each ``chunk``
    logical rows of a table row on their own, merged in chunk order; a
    position that sees no row of a chunk adds nothing to the merge."""
    b, k1, hq, d = q.shape
    hkv = k_pages.shape[0]
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    k_dense = gather_pages(k_pages, block_tables)       # (B, Hkv, S, D)
    v_dense = gather_pages(v_pages, block_tables)
    s = k_dense.shape[2]
    qf = q.float() * scale
    kf = k_dense.float().repeat_interleave(group, dim=1)
    vf = v_dense.float().repeat_interleave(group, dim=1)

    scores = torch.einsum("bihd,bhkd->bihk", qf, kf)     # (B, K1, Hq, S)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    k_pos = torch.arange(s, device=q.device)[None, None, None, :]
    row_len = (lengths.long()[:, None] + 1
               + torch.arange(k1, device=q.device)[None, :])
    mask = k_pos < row_len[:, :, None, None]
    if window is not None:
        q_pos = (row_len - 1)[:, :, None, None]
        mask &= (q_pos - k_pos) < window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    acc, m, l = _chunked_residuals(scores, vf, chunk)
    if return_residuals:
        return acc, m, l
    return normalize(acc, l, q.dtype)


def quant_spec_paged_decode_attention_ref(q, k_pages, v_pages, k_scales,
                                          v_scales, block_tables, lengths, *,
                                          window: Optional[int] = None,
                                          softcap: Optional[float] = None,
                                          scale: Optional[float] = None,
                                          chunk: Optional[int] = None,
                                          return_residuals: bool = False):
    """Dequantize the pools densely, then the speculative plain version
    (``chunk`` as there)."""
    k_dense, v_dense = dequantize_pools(k_pages, v_pages, k_scales, v_scales)
    return spec_paged_decode_attention_ref(
        q, k_dense, v_dense, block_tables, lengths, window=window,
        softcap=softcap, scale=scale, chunk=chunk,
        return_residuals=return_residuals)
