"""Paged decode: the logical-page and ring-walk helpers and the
launchers of the CUDA paged decode kernel
(``csrc/paged_decode_attention.cu``) and of its sliding-window twins
over ring block tables (``csrc/window_paged_decode_attention.cu``,
``csrc/quant_window_paged_decode_attention.cu``).

Layouts (as ``repro.kernels.decode_attention.paged``):
  q            (B, Hq, D)       one new token per slot
  k/v pools    (Hkv, P, ps, D)  head-major; page 0 is the null page
  block_tables (B, T) int32     page id per (slot, logical page)
  lengths      (B,)   int32     valid tokens per slot

A sliding-window layer's table is a *ring* (B, T_w), T_w =
``window_table_width(window, ps)``: global page ``g`` sits at column
``g % T_w``.  ``ring_walk`` lays each row out in timeline order from
the window's first live page, the walk the window kernels follow (they
index the ring so themselves) and the plain version gathers.

``repage``, ``repage_scales``, ``clamp_block_kv`` and ``ring_walk`` are
plain functions so that the CPU tests check the index math the kernel
launches rely on; ``paged_operands`` applies them for these launchers
and for the quantized (``quant.py``) and speculative (``spec.py``)
ones, and ``split_plan`` picks the split-KV launch of B4, B5, B6, B7
and B7q (chunks of whole pages of each table row, from the table's
reach; a ring walk's counted from its first token).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)
from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_BLOCK_KV, MAX_GROUP, MAX_SPLITS, check_decode_operands,
    merge_counters, paged_splits, residual_outputs, split_chunk)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "paged_decode_attention", "paged_decode_attention.cu",
    "paged_decode_attention_fwd",
    [_p] * 12 + [_i] * 10 + [_f, _i, _f, _i, _p])
# the window kernels over bf16/f32 pools (B7) and int8/fp8 pools with
# scale pools (B7q): one argument list (with B4's split fields), one
# launcher
_WINDOW_ARGS = [_p] * 14 + [_i] * 9 + [_f, _i, _f, _i, _i, _p]
WINDOW_KERNEL = CudaKernel(
    "window_paged_decode_attention", "window_paged_decode_attention.cu",
    "window_paged_decode_attention_fwd", _WINDOW_ARGS)
QUANT_WINDOW_KERNEL = CudaKernel(
    "quant_window_paged_decode_attention",
    "quant_window_paged_decode_attention.cu",
    "quant_window_paged_decode_attention_fwd", _WINDOW_ARGS)


def repage(pool: torch.Tensor, block_tables: torch.Tensor, page_size: int):
    """Re-view a ``(H, P, ps, D)`` pool and its table at a logical page
    size that divides ``ps``: each physical page becomes ``ps //
    page_size`` logical pages (a contiguous split, no copy) and the
    table expands to name them.  Identity when the sizes agree."""
    h, p, ps, d = pool.shape
    if page_size == ps:
        return pool, block_tables
    if page_size < 1 or ps % page_size:
        raise ValueError(f"logical page_size {page_size} must divide the "
                         f"pool's physical page size {ps}")
    r = ps // page_size
    pool = pool.reshape(h, p * r, page_size, d)
    bt = (block_tables[:, :, None] * r
          + torch.arange(r, dtype=block_tables.dtype,
                         device=block_tables.device)[None, None, :])
    return pool, bt.reshape(block_tables.shape[0], -1)


def repage_scales(scales: torch.Tensor, page_size: int, ps_phys: int):
    """Per-page (H, P) scales at a smaller logical page: every logical
    page carved from a physical page shares its scale (identity when
    the sizes agree)."""
    if page_size == ps_phys:
        return scales
    r = ps_phys // page_size
    h, p = scales.shape
    return scales.repeat_interleave(r, dim=1).reshape(h, p * r)


def clamp_block_kv(block_kv: int, page_size: int) -> int:
    """The largest block size <= ``block_kv`` that divides
    ``page_size``: a block may never span two non-contiguous pages
    (``repro`` paged.py:145-152)."""
    block_kv = min(block_kv, page_size)
    while page_size % block_kv:
        block_kv -= 1
    return block_kv


def ring_walk(block_tables: torch.Tensor, lengths: torch.Tensor,
              window: int, page_size: int):
    """(walk, start) of ring tables (B, T_w): ``walk[b, j]`` is the page
    at column ``(first + j) % T_w``, ``first = max(L - window, 0) //
    page_size`` the window's first live page, and ``start = first *
    page_size`` the token at the head of column 0 (``repro`` paged.py:
    301-305, where grid step ``ik`` reads column ``(first + ik // spp) %
    T_w``).  Columns past the live window come after it in the walk,
    and the kernels stop at ``L`` before reaching them.  The window
    kernels read their ring rows in this order on the card; the plain
    version gathers the walk."""
    t = block_tables.shape[1]
    first = (lengths.long() - window).clamp(min=0) // page_size
    cols = (first[:, None] + torch.arange(t, device=lengths.device)) % t
    walk = block_tables.gather(1, cols).to(torch.int32).contiguous()
    return walk, (first * page_size).to(torch.int32)


def paged_operands(name: str, q, k_pages, v_pages, block_tables, *,
                   page_size: Optional[int], block_kv: int,
                   k_scales=None, v_scales=None):
    """Check the paged operands of a launcher and re-view them at the
    logical page size.  q is (B, Hq, D) or (B, K1, Hq, D).  Returns
    (k_pages, v_pages, table, k_scales, v_scales, page_size, bk) ready
    to hand to a kernel: contiguous, int32 table, ``bk`` dividing the
    logical page."""
    b = q.shape[0]
    hkv, p_phys, ps_phys = k_pages.shape[:3]
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32):
        raise ValueError(f"{name}: block_tables must be ({b}, T) int32, got "
                         f"{tuple(block_tables.shape)} {block_tables.dtype}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: pass both scale pools or neither")
    page_size = ps_phys if page_size is None else page_size
    k_pages, bt = repage(k_pages, block_tables, page_size)
    v_pages, _ = repage(v_pages, block_tables, page_size)
    if k_scales is not None:
        for sc in (k_scales, v_scales):
            if sc.shape != (hkv, p_phys) or sc.dtype != torch.float32:
                raise ValueError(f"{name}: scale pools must be ({hkv}, "
                                 f"{p_phys}) float32, got {tuple(sc.shape)} "
                                 f"{sc.dtype}")
        k_scales = repage_scales(k_scales, page_size, ps_phys).contiguous()
        v_scales = repage_scales(v_scales, page_size, ps_phys).contiguous()
    bk = clamp_block_kv(min(block_kv, MAX_BLOCK_KV), page_size)
    return (k_pages, v_pages, bt.contiguous(), k_scales, v_scales, page_size,
            bk)


def split_plan(name: str, q, hkv: int, bt, page_size: int,
               splits: Optional[int], dv: Optional[int] = None):
    """(chunk, scratch) of a split-KV paged launch (B4, B5, B6; B7 and
    B7q with ``bt`` the ring tables, their chunks counted from the
    walk's first token): chunks of whole logical pages of each table
    row, ``splits`` of them (None: ``paged_splits`` from the table's
    reach, never from ``lengths``), and with several the partials'
    scratch for q's rows ``q.shape[:-1]``
    (acc (n, ..., dv), m and l (n, ...)) and the merge's zeroed (B x
    Hkv) counters; else four Nones."""
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"{name}: splits {splits} not in [1, {MAX_SPLITS}]")
    reach = max(bt.shape[1], 1) * page_size
    if splits is None:
        splits = paged_splits(reach, page_size)
    chunk = split_chunk(reach, splits, page_size)
    n = -(-reach // chunk)          # <= splits
    if n == 1:
        return chunk, (None,) * 4
    f32 = dict(dtype=torch.float32, device=q.device)
    rows = tuple(q.shape[:-1])
    dv = q.shape[-1] if dv is None else dv
    return chunk, (torch.empty(n, *rows, dv, **f32),
                   torch.empty(n, *rows, **f32), torch.empty(n, *rows, **f32),
                   merge_counters(q.device, q.shape[0] * hkv))


def scratch_ptrs(scratch):
    """The kernel arguments of ``split_plan``'s scratch (null where
    absent)."""
    return tuple(None if t is None else ptr(t) for t in scratch)


def paged_decode_attention_fwd(q, k_pages, v_pages, block_tables, lengths, *,
                               window: Optional[int],
                               softcap: Optional[float],
                               scale: Optional[float],
                               page_size: Optional[int], block_kv: int,
                               splits: Optional[int] = None):
    """Returns unnormalized f32 residuals (acc, m, l), as the dense
    decode kernel does; the V pool may be narrower than the K pool
    (MLA).  ``splits``: chunks of whole logical pages of each table row
    the kernel walks in parallel and merges (None: ``paged_splits``,
    from the table's reach); ``ref.paged_decode_attention_ref(chunk=
    ...)`` is its rounding model."""
    name = "paged_decode_attention"
    dv = check_decode_operands(name, q, k_pages, v_pages, lengths, mla=True)
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads "
                         f"(group <= {MAX_GROUP})")
    k_pages, v_pages, bt, _, _, page_size, bk = paged_operands(
        name, q, k_pages, v_pages, block_tables, page_size=page_size,
        block_kv=block_kv)
    chunk, scratch = split_plan(name, q, hkv, bt, page_size, splits, dv)
    check_cuda(name, q, k_pages, v_pages, bt, lengths)
    acc, m, l = residual_outputs(q, dv)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(bt), ptr(lengths),
                  ptr(acc), ptr(m), ptr(l), *scratch_ptrs(scratch),
                  b, hq, hkv, k_pages.shape[1], page_size, bt.shape[1], d,
                  dv, bk, chunk, float(d ** -0.5 if scale is None else scale),
                  int(window or 0), float(softcap or 0.0), dtype_code(q),
                  stream_of(q))
    return acc, m, l


def check_window(name: str, window) -> None:
    """The window kernels take a positive window (``repro`` refuses
    None: a full-context table goes to the prefix-table kernel)."""
    if window is None or int(window) < 1:
        raise ValueError(f"{name} requires a window >= 1, got {window!r} "
                         f"(use paged_decode_attention for full-context "
                         f"tables)")


def window_paged_decode_attention_fwd(q, k_pages, v_pages, block_tables,
                                      lengths, *, window: int,
                                      softcap: Optional[float],
                                      scale: Optional[float],
                                      page_size: Optional[int],
                                      block_kv: int, k_scales=None,
                                      v_scales=None,
                                      splits: Optional[int] = None):
    """Sliding-window decode over ring tables (B, T_w); lengths (B,)
    int32 count the new token.  With ``k_scales``/``v_scales`` the pools
    are int8/fp8 storage and the quantized kernel (B7q) dequantizes each
    block, else they hold q's dtype (B7).  The kernel walks each ring
    row from the window's first live page, as ``ring_walk`` lays it out.
    ``splits``: chunks of whole logical pages of that walk, counted from
    its first token, that the kernel walks in parallel and merges (None:
    ``paged_splits`` from the ring's width, T_w x page_size, never from
    ``lengths``); ``ref.window_paged_decode_attention_ref(chunk=...)``
    is its rounding model.  Returns unnormalized f32 residuals (acc, m,
    l), as the prefix-table kernel does."""
    quantized = k_scales is not None
    kern = QUANT_WINDOW_KERNEL if quantized else WINDOW_KERNEL
    name = kern.name
    check_window(name, window)
    check_decode_operands(name, q, k_pages, v_pages, lengths,
                          quantized=quantized)
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads "
                         f"(group <= {MAX_GROUP})")
    k_pages, v_pages, bt, ks, vs, page_size, bk = paged_operands(
        name, q, k_pages, v_pages, block_tables, page_size=page_size,
        block_kv=block_kv, k_scales=k_scales, v_scales=v_scales)
    chunk, scratch = split_plan(name, q, hkv, bt, page_size, splits)
    operands = [q, k_pages, v_pages, bt, lengths]
    if quantized:
        operands += [ks, vs]
    check_cuda(name, *operands)
    acc, m, l = residual_outputs(q)
    kern.launch(
        ptr(q), ptr(k_pages), ptr(v_pages), ptr(ks) if quantized else None,
        ptr(vs) if quantized else None, ptr(bt), ptr(lengths), ptr(acc),
        ptr(m), ptr(l), *scratch_ptrs(scratch), b, hq, hkv,
        k_pages.shape[1], page_size, bt.shape[1], d, bk, chunk,
        float(d ** -0.5 if scale is None else scale),
        int(window), float(softcap or 0.0), dtype_code(q),
        dtype_code(k_pages), stream_of(q))
    return acc, m, l
