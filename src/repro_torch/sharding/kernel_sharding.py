"""Fused cache-write + decode attention: the no-mesh branches of
``repro.sharding.kernel_sharding`` (``sharded_decode_update_attend``,
``sharded_paged_decode_update_attend``, their quantized, sliding-window
and speculative variants, ``sharded_mamba_scan`` and
``sharded_mlstm_scan``).  The mesh branches arrive with the
distribution slice.

The reference returns fresh caches (JAX arrays are immutable); the port
writes the new K/V rows (and scales) into the caller's tensors IN PLACE
and returns only the attention output.  The re-quantizing page write is
plain PyTorch, as it is plain ``jnp`` outside any kernel in the
reference; fusing it into a kernel is later work (ROADMAP.md).

``plain`` on the dense, the paged (bf16 and quantized) and the
speculative paths and on the scans takes the kernel's plain version on
any device: the replay that ``chip_smoke.py`` holds the served path
against.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.decode_attention.ops import (
    decode_attention, paged_decode_attention, quant_paged_decode_attention,
    quant_spec_paged_decode_attention, quant_window_paged_decode_attention,
    spec_paged_decode_attention, window_paged_decode_attention)
from repro_torch.kernels.mamba_scan import ref as scan_ref
from repro_torch.kernels.mamba_scan.ops import mamba_scan
from repro_torch.kernels.mlstm_scan import ref as mlstm_ref
from repro_torch.kernels.mlstm_scan.ops import mlstm_scan
from repro_torch.quant.blockwise import quantize_absmax
from repro_torch.serve.paging import raw_bytes


def last_writes(keys: torch.Tensor) -> torch.Tensor:
    """For the flat targets ``keys`` (N,) of one indexed write, the index
    of the last write to each one's target.  Dead slots' rows all land
    in the null page, often at one (page, row); on the card an
    ``index_put_`` with repeated targets keeps any one of their rows, and
    a dead slot's attention reads the null page, so which one would move
    its hidden state and, through MoE capacity, the live slots' routes.
    Giving every repeat the last one's row stores what a write in index
    order stores, whatever order the device writes in."""
    idx = torch.arange(keys.shape[0], device=keys.device)
    same = keys[:, None] == keys[None, :]
    return torch.where(same, idx[None, :], -1).amax(1)


def pool_write(page: torch.Tensor, off: torch.Tensor, *writes) -> None:
    """``pool[:, page, off] = rows`` in place for each (pool, rows) of
    ``writes`` (the K and V pools of one page size), repeated targets
    resolved as ``last_writes`` does: pools (H, P, ps, D); page, off
    (...) of any one shape; rows (H, ..., D) over the same shape."""
    page, off = page.reshape(-1).long(), off.reshape(-1).long()
    src = last_writes(page * writes[0][0].shape[2] + off)
    for pool, rows in writes:
        rows = rows.reshape(rows.shape[0], -1, rows.shape[-1])
        pool[:, page, off] = rows[:, src].to(pool.dtype)


def decode_update_attend(q, k_new, v_new, k_cache, v_cache, write_pos,
                         eff_len, *, window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         scale: Optional[float] = None,
                         plain: bool = False) -> torch.Tensor:
    """q: (B, Hq, Dk); k_new/v_new: (B, Hkv, Dk|Dv) rope'd; caches (B,
    Hkv, S, Dk|Dv) updated in place at ``write_pos``; returns (B, Hq,
    Dv).  A position past the cache (a finished slot parked at
    ``cache_len``) writes nothing, as the reference's one-hot select
    does."""
    s = k_cache.shape[2]
    rows = torch.arange(q.shape[0], device=q.device)
    keep = (write_pos >= s)[:, None, None]
    pos = write_pos.long().clamp(max=s - 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cur = cache[rows, :, pos]
        cache[rows, :, pos] = torch.where(keep, cur, new.to(cache.dtype))
    fn = dec_ref.decode_attention_ref if plain else decode_attention
    return fn(q, k_cache, v_cache, eff_len, window=window, softcap=softcap,
              scale=scale)


def paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                               block_tables, write_page, write_off, eff_len,
                               *, window: Optional[int] = None,
                               softcap: Optional[float] = None,
                               scale: Optional[float] = None,
                               page_size: Optional[int] = None,
                               plain: bool = False) -> torch.Tensor:
    """Write each slot's new K/V row into ``pools[:, write_page,
    write_off]`` in place, then paged decode.  Pools (Hkv, P, ps,
    Dk|Dv); freed slots write into the null page 0 (trash that only
    their own discarded rows read; ``pool_write``)."""
    pool_write(write_page, write_off, (k_pages, k_new.transpose(0, 1)),
               (v_pages, v_new.transpose(0, 1)))
    if plain:
        return dec_ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, eff_len, window=window,
            softcap=softcap, scale=scale)
    return paged_decode_attention(q, k_pages, v_pages, block_tables,
                                  eff_len, window=window, softcap=softcap,
                                  scale=scale, page_size=page_size)


def window_paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                                      block_tables, write_page, write_off,
                                      eff_len, *, window: int,
                                      softcap: Optional[float] = None,
                                      scale: Optional[float] = None,
                                      page_size: Optional[int] = None
                                      ) -> torch.Tensor:
    """``paged_decode_update_attend`` over a window pool and its (B, T_w)
    ring tables (``repro`` kernel_sharding.py:402): the caller resolved
    the write page from the ring, so the write is the same in-place row
    write; then the sliding-window kernel."""
    pool_write(write_page, write_off, (k_pages, k_new.transpose(0, 1)),
               (v_pages, v_new.transpose(0, 1)))
    return window_paged_decode_attention(
        q, k_pages, v_pages, block_tables, eff_len, window=window,
        softcap=softcap, scale=scale, page_size=page_size)


def requant_page_write(pool: torch.Tensor, scales: torch.Tensor,
                       new_row: torch.Tensor, page: torch.Tensor,
                       off: torch.Tensor) -> None:
    """Write one row per slot into a quantized pool, keeping each page
    consistent with its one scale, in place (``repro``
    kernel_sharding.py:357): gather the write page, dequantize it,
    splice the new row at ``off``, zero the rows past it (unwritten, or
    stale from an earlier tenant of a recycled page), take the absmax
    again and quantize again.  Exact when the page's scale does not
    change (``round(q * s / s) == q``).

    pool (H, P, ps, D) int8/fp8; scales (H, P) f32; new_row (B, H, D);
    page, off (B,).  Dead slots write into the null page 0 (trash)."""
    ps = pool.shape[2]
    page = page.long()
    new = new_row.transpose(0, 1).float()                    # (H, B, D)
    pg = raw_bytes(pool)[:, page].view(pool.dtype)           # (H, B, ps, D)
    pgf = pg.float() * scales[:, page][:, :, None, None]
    rows = torch.arange(ps, device=pool.device)[None, None, :, None]
    offb = off.long()[None, :, None, None]
    pgf = torch.where(rows == offb, new[:, :, None, :],
                      torch.where(rows < offb, pgf, torch.zeros_like(pgf)))
    q_pg, sc_new = quantize_absmax(pgf, dtype=pool.dtype, axis=(-2, -1))
    src = last_writes(page)           # dead slots share the null page
    raw_bytes(pool)[:, page] = raw_bytes(q_pg[:, src])
    scales[:, page] = sc_new[:, src].to(scales.dtype)


def quant_paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                                     k_scales, v_scales, block_tables,
                                     write_page, write_off, eff_len, *,
                                     window: Optional[int] = None,
                                     softcap: Optional[float] = None,
                                     scale: Optional[float] = None,
                                     page_size: Optional[int] = None,
                                     plain: bool = False) -> torch.Tensor:
    """Re-quantizing page write of each slot's new K/V row, then
    quantized paged decode.  Pools (Hkv, P, ps, Dk|Dv) int8/fp8 (MLA's V
    pool narrower), scale pools (Hkv, P) f32, all updated in place;
    returns (B, Hq, Dv)."""
    requant_page_write(k_pages, k_scales, k_new, write_page, write_off)
    requant_page_write(v_pages, v_scales, v_new, write_page, write_off)
    if plain:
        return dec_ref.quant_paged_decode_attention_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, eff_len,
            window=window, softcap=softcap, scale=scale)
    return quant_paged_decode_attention(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, eff_len,
        window=window, softcap=softcap, scale=scale, page_size=page_size)


def quant_window_paged_decode_update_attend(q, k_new, v_new, k_pages,
                                            v_pages, k_scales, v_scales,
                                            block_tables, write_page,
                                            write_off, eff_len, *,
                                            window: int,
                                            softcap: Optional[float] = None,
                                            scale: Optional[float] = None,
                                            page_size: Optional[int] = None
                                            ) -> torch.Tensor:
    """The re-quantizing page write over a window pool (``repro``
    kernel_sharding.py:458; ring columns recycle pages constantly, and
    zeroing the rows past the write keeps a recycled page's previous
    tenant out of its new absmax), then the quantized window kernel."""
    requant_page_write(k_pages, k_scales, k_new, write_page, write_off)
    requant_page_write(v_pages, v_scales, v_new, write_page, write_off)
    return quant_window_paged_decode_attention(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, eff_len,
        window=window, softcap=softcap, scale=scale, page_size=page_size)


def spec_paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                                    block_tables, write_pages, write_offs,
                                    base_len, *,
                                    window: Optional[int] = None,
                                    softcap: Optional[float] = None,
                                    scale: Optional[float] = None,
                                    page_size: Optional[int] = None,
                                    plain: bool = False) -> torch.Tensor:
    """Write the whole speculation window's K/V rows in one indexed
    write, then verify every position in one speculative launch.

    q (B, K1, Hq, Dk); k_new/v_new (B, Hkv, K1, Dk|Dv); write_pages/offs
    (B, K1), redirected to the null page past the table's reach;
    base_len (B,) the PRE-speculation prefix.  Returns (B, K1, Hq,
    Dv)."""
    pool_write(write_pages, write_offs, (k_pages, k_new.transpose(0, 1)),
               (v_pages, v_new.transpose(0, 1)))
    if plain:
        return dec_ref.spec_paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, base_len, window=window,
            softcap=softcap, scale=scale)
    return spec_paged_decode_attention(
        q, k_pages, v_pages, block_tables, base_len, window=window,
        softcap=softcap, scale=scale, page_size=page_size)


def quant_spec_paged_decode_update_attend(q, k_new, v_new, k_pages, v_pages,
                                          k_scales, v_scales, block_tables,
                                          write_pages, write_offs, base_len,
                                          *, window: Optional[int] = None,
                                          softcap: Optional[float] = None,
                                          scale: Optional[float] = None,
                                          page_size: Optional[int] = None,
                                          plain: bool = False
                                          ) -> torch.Tensor:
    """The window's rows written one after another in token order by the
    re-quantizing write, so each row sees the earlier ones already
    spliced, then the speculative kernel in its quantized mode."""
    for i in range(q.shape[1]):
        requant_page_write(k_pages, k_scales, k_new[:, :, i],
                           write_pages[:, i], write_offs[:, i])
        requant_page_write(v_pages, v_scales, v_new[:, :, i],
                           write_pages[:, i], write_offs[:, i])
    if plain:
        return dec_ref.quant_spec_paged_decode_attention_ref(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, base_len,
            window=window, softcap=softcap, scale=scale)
    return quant_spec_paged_decode_attention(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, base_len,
        window=window, softcap=softcap, scale=scale, page_size=page_size)


def sharded_mamba_scan(x, dt, A, Bm, Cm, D, *, plain: bool = False):
    """x/dt: (B, S, d_inner); A: (d_inner, n); Bm/Cm: (B, S, n); D:
    (d_inner,) -> (y, h_T) (``repro`` kernel_sharding.py:733, its
    no-mesh branch; on a mesh the scan is channel-parallel and needs no
    collective).  The kernel takes dense rows: strided slices of the
    projections are copied first."""
    args = tuple(t.contiguous() for t in (x, dt, A, Bm, Cm, D))
    if plain:
        return scan_ref.mamba_scan_ref(*args)
    return mamba_scan(*args)


def sharded_mlstm_scan(q, k, v, i_gate, f_gate, *, return_state: bool = False,
                       plain: bool = False):
    """q/k: (B, H, S, Dk); v: (B, H, S, Dv); gates: (B, H, S) -> h, or
    (h, (C, n, m)) with ``return_state`` (``repro``
    kernel_sharding.py:762, its no-mesh branch; on a mesh the value
    columns or the heads split, as the kernel's CTAs split the columns).
    The kernel takes dense rows: strided head views are copied first."""
    args = tuple(t.contiguous() for t in (q, k, v, i_gate, f_gate))
    fn = mlstm_ref.mlstm_scan_ref if plain else mlstm_scan
    return fn(*args, return_state=return_state)
