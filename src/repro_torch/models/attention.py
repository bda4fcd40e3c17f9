"""Attention blocks (``repro.models.attention``).

GQA (global and sliding-window local layers, with the attention
softcap and, where the config sets ``use_qk_norm``, q and k normed per
head before RoPE): prefill, one-token decode over dense caches, dense
rings, paged pools and ring-table window pools (each bf16 or
quantized), and the speculative K1-token verify over paged pools;
cross-attention over an encoder's K/V (``project_kv``), non-causal,
through the same prefill kernel at prefill and at decode.

DeepSeek MLA: prefill, one-token decode over a dense cache or paged
pools (bf16 or quantized), and the speculative K1-token verify over
paged pools, all of the *materialised* per-head K (nope | shared rope,
192 wide at full size) and V (128 wide), as the reference caches them.

Weights keep the reference's shapes flattened to 2-D matrices:
``wq`` (d, H*hd), ``wk``/``wv`` (d, Hkv*hd), ``wo`` (H*hd, d), which is
``(d, H, hd)`` / ``(H, hd, d)`` row-major, so conversion is a reshape
(and, with qk-norm, ``q_norm``/``k_norm`` (hd,), stored around 0);
MLA's ``wq_mla`` (d, H*qk), ``wkv_a`` (d, lora + rope), ``wkv_b``
(lora, H*(nope + v)) and ``wo_mla`` (H*v, d) likewise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import ref as flash_ref
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.sharding.kernel_sharding import (
    decode_update_attend, paged_decode_update_attend,
    quant_paged_decode_update_attend, quant_spec_paged_decode_update_attend,
    quant_window_paged_decode_update_attend, spec_paged_decode_update_attend,
    window_paged_decode_update_attend)

NULL_PAGE = 0


def _page_coords(block_tables: torch.Tensor, lengths: torch.Tensor,
                 page_size: int):
    """(write_page, write_off) for the token at position ``lengths``.

    A freed slot's table row is all null page, so its stale writes land
    in the trash page 0.  A position past the table (a finished slot
    parked at ``lengths == cache_len``) also resolves to page 0, where
    the reference's out-of-range gather drops the write.
    """
    t = block_tables.shape[1]
    page_idx = (lengths // page_size).long()
    gathered = block_tables.gather(1, page_idx.clamp(max=t - 1)[:, None])[:, 0]
    write_page = torch.where(page_idx < t, gathered,
                             torch.zeros_like(gathered))
    write_off = (lengths % page_size).to(torch.int32)
    return write_page, write_off


def _window_page_coords(block_tables: torch.Tensor, lengths: torch.Tensor,
                        page_size: int):
    """(write_page, write_off) against a (B, T_w) *ring* table: global
    page ``g`` sits at column ``g % T_w``, so the token at position
    ``lengths`` goes to column ``(lengths // ps) % T_w``.  The engine's
    eager prefix free ran before the step, so that column's previous
    tenant (page ``g - T_w``, behind the window) is already back in the
    pool; a freed slot's all-null row sends the write to page 0."""
    t = block_tables.shape[1]
    col = ((lengths // page_size) % t).long()
    write_page = block_tables.gather(1, col[:, None])[:, 0]
    write_off = (lengths % page_size).to(torch.int32)
    return write_page, write_off


def _spec_page_coords(block_tables: torch.Tensor, lengths: torch.Tensor,
                      k1: int, page_size: int):
    """(write_page, write_off), both (B, K1), for the speculation window
    at positions ``lengths .. lengths + k1 - 1``.  Positions past the
    table's reach (the engine caps speculation at ``cache_len``, the
    table covers ``pages_per_slot`` pages) go to the null page 0, as
    freed slots' writes do."""
    t = block_tables.shape[1]
    pos = lengths[:, None] + torch.arange(k1, dtype=lengths.dtype,
                                          device=lengths.device)[None, :]
    page_idx = (pos // page_size).clamp(max=t - 1).long()
    gathered = block_tables.gather(1, page_idx)
    write_page = torch.where(pos < t * page_size, gathered,
                             torch.zeros_like(gathered))
    write_off = (pos % page_size).to(torch.int32)
    return write_page, write_off


def init_attn(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": L.dense_init(gen, (d, h * hd), dtype=dtype, in_axis_size=d),
        "wk": L.dense_init(gen, (d, hkv * hd), dtype=dtype, in_axis_size=d),
        "wv": L.dense_init(gen, (d, hkv * hd), dtype=dtype, in_axis_size=d),
        "wo": L.dense_init(gen, (h * hd, d), dtype=dtype,
                           in_axis_size=h * hd),
    }
    if cfg.use_qk_norm:
        p["q_norm"] = L.norm_param(hd, device=gen.device, dtype=dtype)
        p["k_norm"] = L.norm_param(hd, device=gen.device, dtype=dtype)
    return p


def _qk_norm(p, q: torch.Tensor, k: torch.Tensor, cfg: ModelConfig,
             plain: bool):
    """q and k normed over each head's columns (B1 at rows of head_dim)
    where the config sets qk-norm, before RoPE (``repro``
    attention.py:107); unchanged otherwise."""
    if not cfg.use_qk_norm:
        return q, k
    return (L.apply_norm(p["q_norm"], q, plain=plain),
            L.apply_norm(p["k_norm"], k, plain=plain))


def _heads(y: torch.Tensor, n: int) -> torch.Tensor:
    """(B, S, n*hd) -> (B, n, S, hd), contiguous for the kernels."""
    b, s, _ = y.shape
    return y.view(b, s, n, -1).transpose(1, 2).contiguous()


def _qkv(p, x: torch.Tensor, cfg: ModelConfig, rope, plain: bool):
    xd = x.dtype
    q = _heads(x @ p["wq"].to(xd), cfg.num_heads)
    k = _heads(x @ p["wk"].to(xd), cfg.num_kv_heads)
    v = _heads(x @ p["wv"].to(xd), cfg.num_kv_heads)
    q, k = _qk_norm(p, q, k, cfg, plain)
    cos, sin = rope
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def apply_attn(p, x: torch.Tensor, cfg: ModelConfig, rope, *,
               kind: str = "global", causal: bool = True,
               kv_override=None, plain: bool = False):
    """Full-sequence attention (``repro`` attention.py:116).  x: (B, S,
    d); ``rope`` is ``L.rope_cache`` of the query's positions (0..S-1
    in every call the reference makes: a cross-attention query at
    decode sits at position 0); a ``local`` layer sees the config's
    window.  ``kv_override`` (k, v), an encoder's K/V from
    ``project_kv``, makes it cross-attention: only q is projected (and
    normed under qk-norm, and rotated).  Returns (y, k, v) with the
    rope'd K/V (B, Hkv, S, hd) for the prefill cache."""
    b, s, _ = x.shape
    if kv_override is None:
        q, k, v = _qkv(p, x, cfg, rope, plain)
    else:
        q = _heads(x @ p["wq"].to(x.dtype), cfg.num_heads)
        if cfg.use_qk_norm:
            q = L.apply_norm(p["q_norm"], q, plain=plain)
        q = L.apply_rope(q, *rope)
        k, v = kv_override
    fn = flash_ref.flash_attention_ref if plain else flash_attention
    out = fn(q, k, v, causal=causal, window=_window(cfg, kind),
             softcap=cfg.attn_softcap)
    y = out.transpose(1, 2).reshape(b, s, -1) @ p["wo"].to(x.dtype)
    return y, k, v


def project_kv(p, x_enc: torch.Tensor, cfg: ModelConfig, rope, *,
               plain: bool = False):
    """The encoder side of cross-attention (``repro`` attention.py:150):
    K and V (B, Hkv, S_enc, hd) of the encoder's output, K normed under
    qk-norm and rotated at the encoder's positions (``rope``)."""
    k = _heads(x_enc @ p["wk"].to(x_enc.dtype), cfg.num_kv_heads)
    v = _heads(x_enc @ p["wv"].to(x_enc.dtype), cfg.num_kv_heads)
    if cfg.use_qk_norm:
        k = L.apply_norm(p["k_norm"], k, plain=plain)
    return L.apply_rope(k, *rope), v


def _window(cfg: ModelConfig, kind: str):
    return cfg.window if kind == "local" else None


def decode_attn(p, x: torch.Tensor, cache_k: torch.Tensor,
                cache_v: torch.Tensor, lengths: torch.Tensor,
                cfg: ModelConfig, rope, *, kind: str = "global",
                ring: bool = False, block_tables=None, cache_scales=None,
                windowed: bool = False, plain: bool = False) -> torch.Tensor:
    """One-token decode.  x: (B, 1, d); ``rope`` is ``L.rope_cache`` of
    ``lengths``, shaped (B, 1, hd/2).  The new token's K/V is written
    into the cache IN PLACE, then the step attends over ``lengths + 1``
    tokens (a ``local`` layer over its window):

    * dense (B, Hkv, S, D): row ``lengths``; with ``ring`` the cache
      holds the window, written at ``lengths % W`` and read whole
      (``min(lengths + 1, W)`` rows, no window mask: every row in the
      ring is in the window);
    * paged, ``block_tables`` (B, T) over pools (Hkv, P, ps, D): the
      slot's page; with ``windowed`` the table is a (B, T_w) ring of a
      local layer's window pool and the step reads O(window) pages.

    ``cache_scales`` (ks, vs), the (Hkv, P) scale pools, marks the pools
    quantized: the write re-quantizes the page and the quantized kernel
    reads it.  ``plain`` takes the kernel's plain version on any device,
    over a dense cache or ring or a pool of the global group (bf16 or
    quantized).  Returns out (B, 1, d)."""
    if plain and windowed:
        raise ValueError("plain decode is built for dense caches and pools "
                         "of the global group")
    xd = x.dtype
    q = (x[:, 0] @ p["wq"].to(xd)).view(x.shape[0], cfg.num_heads, -1)
    k = (x[:, 0] @ p["wk"].to(xd)).view(x.shape[0], cfg.num_kv_heads, -1)
    v = (x[:, 0] @ p["wv"].to(xd)).view(x.shape[0], cfg.num_kv_heads, -1)
    q, k = _qk_norm(p, q, k, cfg, plain)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin)
    eff_len = (lengths + 1).to(torch.int32)
    kw = dict(softcap=cfg.attn_softcap)
    if block_tables is not None:
        if ring:
            raise ValueError(
                f"paged decode does not take ring caches (layer kind "
                f"{kind!r}, window={cfg.window}): local layers page "
                f"through ring tables (windowed=True), not dense rings")
        ps = cache_k.shape[2]
        if windowed:
            if kind != "local" or cfg.window is None:
                raise ValueError(
                    f"windowed paged decode needs a local layer with a "
                    f"window (got kind={kind!r}, window={cfg.window})")
            write_page, write_off = _window_page_coords(block_tables,
                                                        lengths, ps)
            fn = window_paged_decode_update_attend
            qfn = quant_window_paged_decode_update_attend
            kw["window"] = cfg.window
        else:
            write_page, write_off = _page_coords(block_tables, lengths, ps)
            fn = paged_decode_update_attend
            qfn = quant_paged_decode_update_attend
            kw["window"] = _window(cfg, kind)
        if plain:
            kw["plain"] = True
        if cache_scales is not None:
            out = qfn(q, k, v, cache_k, cache_v, cache_scales[0],
                      cache_scales[1], block_tables, write_page, write_off,
                      eff_len, page_size=ps, **kw)
        else:
            out = fn(q, k, v, cache_k, cache_v, block_tables, write_page,
                     write_off, eff_len, page_size=ps, **kw)
    elif ring:
        w = cache_k.shape[2]
        out = decode_update_attend(q, k, v, cache_k, cache_v, lengths % w,
                                   eff_len.clamp(max=w), plain=plain, **kw)
    else:
        out = decode_update_attend(q, k, v, cache_k, cache_v, lengths,
                                   eff_len, window=_window(cfg, kind),
                                   plain=plain, **kw)
    return (out.reshape(x.shape[0], -1) @ p["wo"].to(xd))[:, None, :]


def spec_decode_attn(p, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, lengths: torch.Tensor,
                     cfg: ModelConfig, rope, *, block_tables,
                     cache_scales=None, plain: bool = False) -> torch.Tensor:
    """Speculative K1-token decode over paged pools.  x: (B, K1, d), the
    slot's current token and K1-1 drafts; ``rope`` is ``L.rope_cache``
    of positions ``lengths + i``, shaped (B, K1, 1, hd/2); ``lengths``
    the PRE-speculation prefix.  All K1 rows' K/V are written into the
    pools IN PLACE, then row i attends to ``lengths + 1 + i`` tokens, so
    one call verifies the window.  ``plain`` takes the kernel's plain
    version on any device.  Returns out (B, K1, d)."""
    b, k1, _ = x.shape
    xd = x.dtype
    q = (x @ p["wq"].to(xd)).view(b, k1, cfg.num_heads, -1)
    k = (x @ p["wk"].to(xd)).view(b, k1, cfg.num_kv_heads, -1)
    v = (x @ p["wv"].to(xd)).view(b, k1, cfg.num_kv_heads, -1)
    q, k = _qk_norm(p, q, k, cfg, plain)
    cos, sin = rope
    q = L.apply_rope(q, cos, sin)
    k = L.apply_rope(k, cos, sin).transpose(1, 2)          # (B, Hkv, K1, hd)
    v = v.transpose(1, 2)
    out = _spec_update_attend(q, k, v, cache_k, cache_v, lengths,
                              block_tables, cache_scales, plain,
                              softcap=cfg.attn_softcap)
    return out.reshape(b, k1, -1) @ p["wo"].to(xd)


def _spec_update_attend(q, k, v, cache_k, cache_v, lengths, block_tables,
                        cache_scales, plain: bool, **kw) -> torch.Tensor:
    """The speculative window's K/V rows written at ``_spec_page_coords``
    and its K1 positions verified: q (B, K1, Hq, Dk), k/v (B, Hkv, K1,
    Dk|Dv), over bf16 pools or, with ``cache_scales``, quantized ones."""
    ps = cache_k.shape[2]
    write_page, write_off = _spec_page_coords(block_tables, lengths,
                                              q.shape[1], ps)
    base = lengths.to(torch.int32)
    if cache_scales is not None:
        return quant_spec_paged_decode_update_attend(
            q, k, v, cache_k, cache_v, cache_scales[0], cache_scales[1],
            block_tables, write_page, write_off, base, page_size=ps,
            plain=plain, **kw)
    return spec_paged_decode_update_attend(
        q, k, v, cache_k, cache_v, block_tables, write_page, write_off, base,
        page_size=ps, plain=plain, **kw)


# ------------------------------------------------------------- MLA ------

def init_mla(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    lora = m.kv_lora_rank
    return {
        "wq_mla": L.dense_init(gen, (d, h * qk), dtype=dtype, in_axis_size=d),
        "wkv_a": L.dense_init(gen, (d, lora + m.qk_rope_head_dim),
                              dtype=dtype, in_axis_size=d),
        "wkv_b": L.dense_init(gen, (lora, h * (m.qk_nope_head_dim
                                               + m.v_head_dim)),
                              dtype=dtype, in_axis_size=lora),
        "wo_mla": L.dense_init(gen, (h * m.v_head_dim, d), dtype=dtype,
                               in_axis_size=h * m.v_head_dim),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    return (cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim) ** -0.5


def _mla_qkv(p, x: torch.Tensor, cfg: ModelConfig, rope):
    """x (B, S, d) -> q (B, H, S, qk), K (B, H, S, qk) and V (B, H, S,
    v) per head: q = [nope | rope'd rope]; K = [up-projected nope |
    the shared rope'd key, broadcast over heads]; V up-projected from
    the latent c_kv.  ``rope`` is ``L.rope_cache`` at qk_rope_head_dim,
    broadcasting against (B, H, S, rope)."""
    m = cfg.mla
    b, s, _ = x.shape
    h, nope, lora = cfg.num_heads, m.qk_nope_head_dim, m.kv_lora_rank
    xd = x.dtype
    cos, sin = rope
    q = _heads(x @ p["wq_mla"].to(xd), h)
    q_rope = L.apply_rope(q[..., nope:], cos, sin)
    kv_a = x @ p["wkv_a"].to(xd)                        # (B, S, lora+rope)
    k_rope = L.apply_rope(kv_a[..., lora:][:, None], cos, sin)
    kv = _heads(kv_a[..., :lora] @ p["wkv_b"].to(xd), h)
    q_full = torch.cat([q[..., :nope], q_rope], dim=-1)
    k_full = torch.cat([kv[..., :nope],
                        k_rope.expand(b, h, s, m.qk_rope_head_dim)], dim=-1)
    return q_full, k_full, kv[..., nope:].contiguous()


def apply_mla(p, x: torch.Tensor, cfg: ModelConfig, rope, *,
              plain: bool = False):
    """Causal MLA over the full sequence.  x (B, S, d); ``rope`` is
    ``L.rope_cache`` of positions 0..S-1 at qk_rope_head_dim.  Returns
    (y, k, v) with the materialised K (B, H, S, qk) and V (B, H, S, v)
    for the prefill cache."""
    b, s, _ = x.shape
    q, k, v = _mla_qkv(p, x, cfg, rope)
    fn = flash_ref.flash_attention_ref if plain else flash_attention
    out = fn(q, k, v, causal=True, scale=_mla_scale(cfg))
    y = out.transpose(1, 2).reshape(b, s, -1) @ p["wo_mla"].to(x.dtype)
    return y, k, v


def decode_mla(p, x: torch.Tensor, cache_k: torch.Tensor,
               cache_v: torch.Tensor, lengths: torch.Tensor,
               cfg: ModelConfig, rope, *, block_tables=None,
               cache_scales=None, plain: bool = False) -> torch.Tensor:
    """One-token MLA decode.  x (B, 1, d); ``rope`` is ``L.rope_cache``
    of ``lengths`` at qk_rope_head_dim, shaped (B, 1, rope/2).  The new
    token's K and V are written into the cache IN PLACE (a dense cache
    (B, H, S, qk|v) at row ``lengths``, or with ``block_tables`` paged
    pools (H, P, ps, qk|v)), then the step attends over ``lengths + 1``
    tokens.  ``cache_scales`` (ks, vs), the (H, P) scale pools, marks the
    pools int8/fp8: the write re-quantizes the page and the quantized
    kernel (B5 at 192/128) reads it.  ``plain`` takes the kernel's plain
    version on any device.  Returns out (B, 1, d)."""
    if cache_scales is not None and block_tables is None:
        raise ValueError("quantized MLA caches are paged pools: pass "
                         "block_tables")
    # against (B, H, 1, rope): one more axis than decode_attn's heads
    q, k, v = _mla_qkv(p, x, cfg, tuple(t[:, None] for t in rope))
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]    # (B, H, qk|v)
    eff_len = (lengths + 1).to(torch.int32)
    kw = dict(scale=_mla_scale(cfg), plain=plain)
    if block_tables is not None:
        ps = cache_k.shape[2]
        write_page, write_off = _page_coords(block_tables, lengths, ps)
        if cache_scales is not None:
            out = quant_paged_decode_update_attend(
                q, k, v, cache_k, cache_v, cache_scales[0], cache_scales[1],
                block_tables, write_page, write_off, eff_len, page_size=ps,
                **kw)
        else:
            out = paged_decode_update_attend(q, k, v, cache_k, cache_v,
                                             block_tables, write_page,
                                             write_off, eff_len,
                                             page_size=ps, **kw)
    else:
        out = decode_update_attend(q, k, v, cache_k, cache_v, lengths,
                                   eff_len, **kw)
    return (out.reshape(x.shape[0], -1) @ p["wo_mla"].to(x.dtype))[:, None]


def spec_decode_mla(p, x: torch.Tensor, cache_k: torch.Tensor,
                    cache_v: torch.Tensor, lengths: torch.Tensor,
                    cfg: ModelConfig, rope, *, block_tables,
                    cache_scales=None, plain: bool = False) -> torch.Tensor:
    """Speculative K1-token MLA decode over paged pools (``repro``
    attention.py:428), bf16 or quantized (``cache_scales``): x (B, K1,
    d); ``rope`` is ``L.rope_cache`` of positions ``lengths + i`` at
    qk_rope_head_dim, shaped (B, K1, 1, rope/2), as ``spec_decode_attn``
    takes it; ``lengths`` the PRE-speculation prefix.  The window's K
    (192) and V (128) rows of every head are written into the pools IN
    PLACE, then position i attends to ``lengths + 1 + i`` tokens (B6 at
    192/128).  Returns out (B, K1, d)."""
    b, k1, _ = x.shape
    # (B, 1, K1, rope/2): against _mla_qkv's (B, H, K1, rope)
    q, k, v = _mla_qkv(p, x, cfg, tuple(t.transpose(1, 2) for t in rope))
    out = _spec_update_attend(q.transpose(1, 2).contiguous(), k, v,
                              cache_k, cache_v, lengths, block_tables,
                              cache_scales, plain, scale=_mla_scale(cfg))
    return out.reshape(b, k1, -1) @ p["wo_mla"].to(x.dtype)
