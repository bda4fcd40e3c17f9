"""Quantized paged decode: the launcher of the CUDA kernel
``csrc/quant_paged_decode_attention.cu`` (``repro``'s
``kernels/decode_attention/quant.py``; its window twin over ring tables
launches through ``paged.window_paged_decode_attention_fwd``).

Layouts as the bf16 paged op, with the pools stored as int8 or
fp8-e4m3 and one f32 scale per (head, page) in the (Hkv, P) scale
pools.  The kernel is B4's split-KV kernel over the 1-byte pools: it
walks each table row in ``splits`` chunks of whole pages (None:
``paged.split_plan``'s rule from the table's reach) and dequantizes
each staged block as ``f32(x) * scale`` before any dot; logical
re-paging gives every logical page its physical page's scale
(``paged.repage_scales``).  ``ref.quant_paged_decode_attention_ref(
chunk=...)`` is its rounding model.  Key and value head dims are
equal, or MLA's pair (``decode_attention.MLA_DIMS``: the V pool
narrower than the K pool).  A pool type or head-dim pair the kernel
lacks is refused: there is no fall back to the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Optional

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)
from repro_torch.kernels.decode_attention.decode_attention import (
    MAX_GROUP, check_decode_operands, residual_outputs)
from repro_torch.kernels.decode_attention.paged import (
    paged_operands, scratch_ptrs, split_plan)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "quant_paged_decode_attention", "quant_paged_decode_attention.cu",
    "quant_paged_decode_attention_fwd",
    [_p] * 14 + [_i] * 10 + [_f, _i, _f, _i, _i, _p])


def quant_paged_decode_attention_fwd(q, k_pages, v_pages, k_scales, v_scales,
                                     block_tables, lengths, *,
                                     window: Optional[int],
                                     softcap: Optional[float],
                                     scale: Optional[float],
                                     page_size: Optional[int],
                                     block_kv: int,
                                     splits: Optional[int] = None):
    """q: (B, Hq, Dk); pools (Hkv, P, ps, Dk|Dv) int8/fp8; scale pools
    (Hkv, P) f32; block_tables (B, T) int32; lengths (B,) int32.  Returns
    unnormalized f32 residuals (acc (B, Hq, Dv), m, l (B, Hq))."""
    name = "quant_paged_decode_attention"
    dv = check_decode_operands(name, q, k_pages, v_pages, lengths,
                               quantized=True, mla=True)
    b, hq, d = q.shape
    hkv = k_pages.shape[0]
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"{name}: {hq} query heads over {hkv} kv heads "
                         f"(group <= {MAX_GROUP})")
    if k_scales is None or v_scales is None:
        raise ValueError(f"{name}: quantized pools need both scale pools")
    k_pages, v_pages, bt, ks, vs, page_size, bk = paged_operands(
        name, q, k_pages, v_pages, block_tables, page_size=page_size,
        block_kv=block_kv, k_scales=k_scales, v_scales=v_scales)
    chunk, scratch = split_plan(name, q, hkv, bt, page_size, splits, dv)
    check_cuda(name, q, k_pages, v_pages, ks, vs, bt, lengths)
    acc, m, l = residual_outputs(q, dv)
    KERNEL.launch(ptr(q), ptr(k_pages), ptr(v_pages), ptr(ks), ptr(vs),
                  ptr(bt), ptr(lengths), ptr(acc), ptr(m), ptr(l),
                  *scratch_ptrs(scratch), b, hq, hkv, k_pages.shape[1],
                  page_size, bt.shape[1], d, dv, bk, chunk,
                  float(d ** -0.5 if scale is None else scale),
                  int(window or 0), float(softcap or 0.0), dtype_code(q),
                  dtype_code(k_pages), stream_of(q))
    return acc, m, l
