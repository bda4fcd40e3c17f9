"""Paged decode: the logical-page helpers and the launcher of the CUDA
paged decode kernel (``csrc/paged_decode_attention.cu``).

Layouts (as ``repro.kernels.decode_attention.paged``):
  q            (B, Hq, D)       one new token per slot
  k/v pools    (Hkv, P, ps, D)  head-major; page 0 is the null page
  block_tables (B, T) int32     page id per (slot, logical page)
  lengths      (B,)   int32     valid tokens per slot

``repage`` and ``clamp_block_kv`` are plain functions so that the CPU
tests check the index math the kernel launch relies on.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)
from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_BLOCK_KV, MAX_GROUP, check_decode_operands, residual_outputs)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "paged_decode_attention", "paged_decode_attention.cu",
    "paged_decode_attention_fwd",
    [_p] * 8 + [_i] * 8 + [_f, _i, _f, _i, _p])


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


def clamp_block_kv(block_kv: int, page_size: int) -> int:
    """The largest block size <= ``block_kv`` that divides
    ``page_size``: a block may never span two non-contiguous pages
    (``repro`` paged.py:145-152)."""
    block_kv = min(block_kv, page_size)
    while page_size % block_kv:
        block_kv -= 1
    return block_kv


def paged_decode_attention_fwd(q, k_pages, v_pages, block_tables, lengths, *,
                               window: Optional[int],
                               softcap: Optional[float],
                               scale: Optional[float],
                               page_size: Optional[int], block_kv: int):
    """Returns unnormalized f32 residuals (acc, m, l), as the dense
    decode kernel does."""
    check_decode_operands("paged_decode_attention", q, k_pages, v_pages,
                          lengths)
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"paged_decode_attention: {hq} query heads over "
                         f"{hkv} kv heads (group <= {MAX_GROUP})")
    if (block_tables.dim() != 2 or block_tables.shape[0] != b
            or block_tables.dtype != torch.int32):
        raise ValueError(f"paged_decode_attention: block_tables must be "
                         f"({b}, T) int32, got {tuple(block_tables.shape)} "
                         f"{block_tables.dtype}")
    page_size = k_pages.shape[2] if page_size is None else page_size
    k_pages, bt = repage(k_pages, block_tables, page_size)
    v_pages, _ = repage(v_pages, block_tables, page_size)
    bk = clamp_block_kv(min(block_kv, MAX_BLOCK_KV), page_size)
    bt = bt.contiguous()
    check_cuda("paged_decode_attention", q, k_pages, v_pages, bt, lengths)
    acc, m, l = residual_outputs(q)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(bt), ptr(lengths),
                  ptr(acc), ptr(m), ptr(l), b, hq, hkv, k_pages.shape[1],
                  page_size, bt.shape[1], d, bk,
                  float(d ** -0.5 if scale is None else scale),
                  int(window or 0), float(softcap or 0.0), dtype_code(q),
                  stream_of(q))
    return acc, m, l
