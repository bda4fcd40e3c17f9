"""Public decode-attention ops: dense, paged, quantized paged,
sliding-window paged over ring tables (bf16 and quantized),
speculative paged and quantized speculative paged.

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel (or the call raises).  Both return the unnormalized residuals
(acc, m, l) internally; the public functions normalize them with the
``l == 0 -> 1`` guard unless ``return_residuals`` asks for the raw
triple.  ``page_size`` (logical, divides the pool's), ``block_kv`` and
the split-KV kernels' ``splits`` (every one of them) are schedule
choices that change the result only by the
order of f32 sums; on the CPU they have no effect.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import tuning
from repro_torch.kernels.decode_attention import decode_attention as _kern
from repro_torch.kernels.decode_attention import paged as _paged
from repro_torch.kernels.decode_attention import quant as _quant
from repro_torch.kernels.decode_attention import ref as _ref
from repro_torch.kernels.decode_attention import spec as _spec
from repro_torch.obs.profile import device_op

#: Tolerance of the reference ops (``core/op.py`` default), f32.
TOL = {"atol": 2e-5, "rtol": 2e-5}


def _finish(q, res, return_residuals: bool):
    """The residuals, or the output normalized with ``l == 0 -> 1``."""
    acc, m, l = res
    if return_residuals:
        return acc, m, l
    return _ref.normalize(acc, l, q.dtype)


@device_op
def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     block_kv: Optional[int] = None,
                     splits: Optional[int] = None,
                     return_residuals: bool = False):
    """Single-token GQA decode.  q: (B, Hq, D); caches: (B, Hkv, S, D);
    lengths: (B,) int32, the valid prefix (the query is the newest
    token).  ``splits``: chunks of each cache the kernel walks in
    parallel and merges (None: ``decode_attention.decode_splits``, from
    the cache's length)."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.decode_attention_ref(
            q, k_cache, v_cache, lengths, return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size("decode_attention",
                                                 "block_kv")
        res = _kern.decode_attention_fwd(
            q, k_cache, v_cache, lengths, block_kv=block_kv, splits=splits,
            **kw)
    return _finish(q, res, return_residuals)


@device_op
def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           page_size: Optional[int] = None,
                           block_kv: Optional[int] = None,
                           splits: Optional[int] = None,
                           return_residuals: bool = False):
    """Single-token GQA decode over a paged pool.  q: (B, Hq, D); pools
    (Hkv, P, ps, D); block_tables (B, T) int32; lengths (B,) int32.
    ``page_size`` (logical, divides ps), ``block_kv`` and ``splits``
    (chunks of whole pages of each table row the kernel walks in
    parallel and merges; None: ``decode_attention.paged_splits``, from
    the table's reach) are schedule choices."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size("paged_decode_attention",
                                                 "block_kv")
        res = _paged.paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, splits=splits, **kw)
    return _finish(q, res, return_residuals)


@device_op
def quant_paged_decode_attention(q, k_pages, v_pages, k_scales, v_scales,
                                 block_tables, lengths, *,
                                 window: Optional[int] = None,
                                 softcap: Optional[float] = None,
                                 scale: Optional[float] = None,
                                 page_size: Optional[int] = None,
                                 block_kv: Optional[int] = None,
                                 splits: Optional[int] = None,
                                 return_residuals: bool = False):
    """Single-token GQA decode over a quantized paged pool: pools (Hkv,
    P, ps, D) int8/fp8-e4m3, scale pools (Hkv, P) f32.  Semantics of
    ``paged_decode_attention`` over the dequantized pools, ``splits``
    as there."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.quant_paged_decode_attention_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size(
            "quant_paged_decode_attention", "block_kv")
        res = _quant.quant_paged_decode_attention_fwd(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths,
            page_size=page_size, block_kv=block_kv, splits=splits, **kw)
    return _finish(q, res, return_residuals)


@device_op
def window_paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  lengths, *, window: int,
                                  softcap: Optional[float] = None,
                                  scale: Optional[float] = None,
                                  page_size: Optional[int] = None,
                                  block_kv: Optional[int] = None,
                                  splits: Optional[int] = None,
                                  return_residuals: bool = False):
    """Sliding-window GQA decode over ring block tables (B, T_w), global
    page ``g`` at column ``g % T_w``: ``decode_attention(window=window)``
    over the un-rung cache, read in O(window) however long the context
    ran.  q: (B, Hq, D); pools (Hkv, P, ps, D); lengths (B,) int32.
    ``splits``: chunks of whole pages of each slot's ring walk, counted
    from the window's first live page (None: ``decode_attention.
    paged_splits`` from the ring's width)."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.window_paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size(
            "window_paged_decode_attention", "block_kv")
        res = _paged.window_paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, splits=splits, **kw)
    return _finish(q, res, return_residuals)


@device_op
def quant_window_paged_decode_attention(q, k_pages, v_pages, k_scales,
                                        v_scales, block_tables, lengths, *,
                                        window: int,
                                        softcap: Optional[float] = None,
                                        scale: Optional[float] = None,
                                        page_size: Optional[int] = None,
                                        block_kv: Optional[int] = None,
                                        splits: Optional[int] = None,
                                        return_residuals: bool = False):
    """``window_paged_decode_attention`` over int8/fp8-e4m3 pools with
    (Hkv, P) f32 scale pools, dequantized before the dots; ``splits`` as
    there."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.quant_window_paged_decode_attention_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size(
            "quant_window_paged_decode_attention", "block_kv")
        res = _paged.window_paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, k_scales=k_scales, v_scales=v_scales,
            splits=splits, **kw)
    return _finish(q, res, return_residuals)


@device_op
def spec_paged_decode_attention(q, k_pages, v_pages, block_tables, lengths,
                                *, window: Optional[int] = None,
                                softcap: Optional[float] = None,
                                scale: Optional[float] = None,
                                page_size: Optional[int] = None,
                                block_kv: Optional[int] = None,
                                splits: Optional[int] = None,
                                return_residuals: bool = False):
    """Speculative (multi-query) GQA decode over a paged pool.  q: (B,
    K1, Hq, D), the committed token plus k drafts per slot; lengths:
    (B,) PRE-speculation prefix.  Position i attends causally to
    ``lengths + 1 + i`` tokens.  ``splits`` as ``paged_decode_attention``
    takes it.  Returns (B, K1, Hq, D) or residuals."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.spec_paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size(
            "spec_paged_decode_attention", "block_kv")
        res = _spec.spec_paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, splits=splits, **kw)
    return _finish(q, res, return_residuals)


@device_op
def quant_spec_paged_decode_attention(q, k_pages, v_pages, k_scales,
                                      v_scales, block_tables, lengths, *,
                                      window: Optional[int] = None,
                                      softcap: Optional[float] = None,
                                      scale: Optional[float] = None,
                                      page_size: Optional[int] = None,
                                      block_kv: Optional[int] = None,
                                      splits: Optional[int] = None,
                                      return_residuals: bool = False):
    """``spec_paged_decode_attention`` over quantized pools; on the card
    the same kernel in its quantized mode."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        res = _ref.quant_spec_paged_decode_attention_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size(
            "quant_spec_paged_decode_attention", "block_kv")
        res = _spec.spec_paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, k_scales=k_scales, v_scales=v_scales,
            splits=splits, **kw)
    return _finish(q, res, return_residuals)
