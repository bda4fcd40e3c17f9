"""Speculative paged decode: the launcher of the CUDA kernel
``csrc/spec_paged_decode_attention.cu`` (``repro``'s
``kernels/decode_attention/spec.py``).

Self-speculative decoding verifies the committed token and k drafts of
each slot, K1 = k+1 query positions, in one paged-decode launch per
layer.  As in the reference, the positions are stacked into the rows
of a kv head position-major: row ``r = qi * group + gi`` is query head
``gi`` of the group at window position ``qi`` (``row_position``).
Position ``qi`` sits at token ``lengths + qi`` and sees ``lengths + 1 +
qi`` tokens, so row ``r`` sees ``lengths + 1 + r // group``
(``spec_row_lengths``): the window's K/V rows are written before the
verify.  Both helpers are plain torch, so the CPU tests check the index
math the kernel is handed.  Key and value head dims are equal, or
MLA's pair (``decode_attention.MLA_DIMS``).  The kernel is B4's
split-KV kernel at
``MAX_ROWS`` rows a CTA, each masked at its own horizon: it walks each
table row in ``splits`` chunks of whole pages (None: the rule of
``paged.split_plan``, from the table's reach, never from ``lengths``)
and merges their partials in chunk order; the plain version with
``chunk=`` is its rounding model.

Layouts
  q            (B, K1, Hq, Dk)  the speculation window per slot
  k/v pools    (Hkv, P, ps, Dk|Dv)  bf16/f32, or int8/fp8 with scales
  k/v scales   (Hkv, P) f32     per (head, page); None when unquantized
  block_tables (B, T) int32
  lengths      (B,) int32       PRE-speculation prefix

Returns unnormalized f32 residuals acc (B, K1, Hq, Dv), m and l
(B, K1, Hq), one triple per verified position.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)
from repro_torch.kernels.decode_attention.decode_attention import (
    check_decode_operands, residual_outputs)
from repro_torch.kernels.decode_attention.paged import (
    paged_operands, scratch_ptrs, split_plan)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "spec_paged_decode_attention", "spec_paged_decode_attention.cu",
    "spec_paged_decode_attention_fwd",
    [_p] * 14 + [_i] * 11 + [_f, _i, _f, _i, _i, _p])

MAX_ROWS = 32        # G_SPEC in csrc/decode_common.cuh: K1 * group


def row_position(r, group: int) -> Tuple:
    """(window position qi, group head gi) of stacked row ``r = qi *
    group + gi`` (the reference's stacking, ``repro`` spec.py:125-128)."""
    return r // group, r % group


def spec_row_lengths(lengths: torch.Tensor, k1: int,
                     group: int) -> torch.Tensor:
    """(B, K1 * group) int32 causal horizon of every stacked row: row
    ``r`` sees ``lengths + 1 + r // group`` tokens (``repro``
    spec.py:70-71)."""
    r = torch.arange(k1 * group, dtype=torch.int32, device=lengths.device)
    qi, _ = row_position(r, group)
    return (lengths.to(torch.int32)[:, None] + 1 + qi[None, :]).contiguous()


def spec_paged_decode_attention_fwd(q, k_pages, v_pages, block_tables,
                                    lengths, *, window: Optional[int],
                                    softcap: Optional[float],
                                    scale: Optional[float],
                                    page_size: Optional[int], block_kv: int,
                                    k_scales=None, v_scales=None,
                                    splits: Optional[int] = None):
    """Launch the speculative kernel; with ``k_scales``/``v_scales`` the
    pools are int8/fp8 storage and each block is dequantized in the
    kernel, else they hold q's dtype.  ``splits``: chunks of whole pages
    of each table row (None: the table's reach decides)."""
    name = "spec_paged_decode_attention"
    quantized = k_scales is not None
    dv = check_decode_operands(name, q, k_pages, v_pages, lengths,
                               quantized=quantized, mla=True)
    b, k1, hq, d = q.shape
    hkv = k_pages.shape[0]
    group = hq // hkv
    if hq % hkv or k1 * group > MAX_ROWS:
        raise ValueError(f"{name}: {k1} positions x {hq} query heads over "
                         f"{hkv} kv heads (K1 * group <= {MAX_ROWS})")
    k_pages, v_pages, bt, ks, vs, page_size, bk = paged_operands(
        name, q, k_pages, v_pages, block_tables, page_size=page_size,
        block_kv=block_kv, k_scales=k_scales, v_scales=v_scales)
    chunk, scratch = split_plan(name, q, hkv, bt, page_size, splits, dv)
    row_len = spec_row_lengths(lengths, k1, group)
    operands = [q, k_pages, v_pages, bt, row_len]
    if quantized:
        operands += [ks, vs]
    check_cuda(name, *operands)
    acc, m, l = residual_outputs(q, dv)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages),
                  ptr(ks) if quantized else None,
                  ptr(vs) if quantized else None, ptr(bt), ptr(row_len),
                  ptr(acc), ptr(m), ptr(l), *scratch_ptrs(scratch), b, k1,
                  hq, hkv, k_pages.shape[1], page_size, bt.shape[1], d, dv,
                  bk, chunk, float(d ** -0.5 if scale is None else scale),
                  int(window or 0), float(softcap or 0.0), dtype_code(q),
                  dtype_code(k_pages), stream_of(q))
    return acc, m, l
