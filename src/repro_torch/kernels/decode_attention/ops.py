"""Public decode-attention ops, dense and paged.

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel.  Both return the unnormalized residuals (acc, m, l) internally;
the public functions normalize them with the ``l == 0 -> 1`` guard
unless ``return_residuals`` asks for the raw triple.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import tuning
from repro_torch.kernels.decode_attention import decode_attention as _kern
from repro_torch.kernels.decode_attention import paged as _paged
from repro_torch.kernels.decode_attention import ref as _ref

#: Tolerance of the reference ops (``core/op.py`` default), f32.
TOL = {"atol": 2e-5, "rtol": 2e-5}


def decode_attention(q, k_cache, v_cache, lengths, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None,
                     block_kv: Optional[int] = None,
                     return_residuals: bool = False):
    """Single-token GQA decode.  q: (B, Hq, D); caches: (B, Hkv, S, D);
    lengths: (B,) int32, the valid prefix (the query is the newest
    token)."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        acc, m, l = _ref.decode_attention_ref(
            q, k_cache, v_cache, lengths, return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size("decode_attention",
                                                 "block_kv")
        acc, m, l = _kern.decode_attention_fwd(
            q, k_cache, v_cache, lengths, block_kv=block_kv, **kw)
    if return_residuals:
        return acc, m, l
    return _ref.normalize(acc, l, q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None,
                           page_size: Optional[int] = None,
                           block_kv: Optional[int] = None,
                           return_residuals: bool = False):
    """Single-token GQA decode over a paged pool.  q: (B, Hq, D); pools
    (Hkv, P, ps, D); block_tables (B, T) int32; lengths (B,) int32.
    ``page_size`` (logical, divides ps) and ``block_kv`` are schedule
    choices that never change the result."""
    kw = dict(window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        acc, m, l = _ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths,
            return_residuals=True, **kw)
    else:
        block_kv = block_kv or tuning.block_size("paged_decode_attention",
                                                 "block_kv")
        acc, m, l = _paged.paged_decode_attention_fwd(
            q, k_pages, v_pages, block_tables, lengths, page_size=page_size,
            block_kv=block_kv, **kw)
    if return_residuals:
        return acc, m, l
    return _ref.normalize(acc, l, q.dtype)
