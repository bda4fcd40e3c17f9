"""Fused cache-write + decode attention: the no-mesh branches of
``repro.sharding.kernel_sharding`` (``sharded_decode_update_attend``
and ``sharded_paged_decode_update_attend``).  The mesh branches arrive
with the distribution slice.

The reference returns fresh caches (JAX arrays are immutable); the port
writes the new K/V row into the caller's cache tensors IN PLACE and
returns only the attention output.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ops import (
    decode_attention, paged_decode_attention)


def decode_update_attend(q, k_new, v_new, k_cache, v_cache, write_pos,
                         eff_len, *, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Hq, D); k_new/v_new: (B, Hkv, D) rope'd; caches (B, Hkv, S,
    D) updated in place at ``write_pos``; returns (B, Hq, D).  A position
    past the cache (a finished slot parked at ``cache_len``) writes
    nothing, as the reference's one-hot select does."""
    s = k_cache.shape[2]
    rows = torch.arange(q.shape[0], device=q.device)
    keep = (write_pos >= s)[:, None, None]
    pos = write_pos.long().clamp(max=s - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[rows, :, pos]
        cache[rows, :, pos] = torch.where(keep, cur, new.to(cache.dtype))
    return decode_attention(q, k_cache, v_cache, eff_len, window=window,
                            softcap=softcap, scale=scale)


def paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                               block_tables, write_page, write_off, eff_len,
                               *, window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None,
                               page_size: Optional[int] = None
                               ) -> torch.Tensor:
    """Write each slot's new K/V row into ``pools[:, write_page,
    write_off]`` in place, then paged decode.  Pools (Hkv, P, ps, D);
    freed slots write into the null page 0 (trash, never read)."""
    page, off = write_page.long(), write_off.long()
    k_pages[:, page, off] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, page, off] = v_new.transpose(0, 1).to(v_pages.dtype)
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  eff_len, window=window, softcap=softcap,
                                  scale=scale, page_size=page_size)
