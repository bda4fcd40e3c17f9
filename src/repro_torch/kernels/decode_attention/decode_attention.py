"""Launcher of the CUDA dense decode kernel (``csrc/decode_attention.cu``).

Returns the unnormalized residuals (acc, m, l) in f32, the contract of
``repro.kernels.decode_attention.decode_attention.decode_attention_fwd``.
Key and value head dims are equal (64, 128, 256), or MLA's 192 and 128.

The kernel splits each slot's cache into ``splits`` chunks of whole
blocks, one CTA each, and merges the chunks' partials in split order
inside the same launch (``ref.decode_attention_ref(chunk=...)`` is its
rounding model).  :func:`decode_splits` picks the count from the cache's
length alone, and :func:`paged_splits` the paged kernel's (B4, launched
from ``paged.py``) from its table's reach.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "decode_attention", "decode_attention.cu", "decode_attention_fwd",
    [_p] * 11 + [_i] * 8 + [_f, _i, _f, _i, _p])

HEAD_DIMS = (64, 128, 256)
#: (Dk, Dv) builds with values narrower than keys (MLA): B2, B3, B4, B5
#: and B6 have them; the window kernels (B7, B7q) none.
MLA_DIMS = ((192, 128),)
MAX_GROUP = 8        # G_DECODE in csrc/decode_common.cuh
MAX_BLOCK_KV = 64    # BK_MAX in csrc/decode_common.cuh
MAX_SPLITS = 64      # MAX_SPLITS in csrc/decode_common.cuh
#: Cache rows a split walks (before :func:`split_chunk` evens the
#: chunks out).  Of the candidates 256, 512 and 1024, in that order, the
#: first that kept every dense serving path's teacher-forced gap within
#: ``chip_smoke.py``'s TEACHER_GAP: gemma2-2b's was 0.0597 with 256
#: rows, 0.0608 with 512, and 0.0597 with a count that fills the card
#: (PERF.md §6; ``scripts/torch_decode_variants.py``).
SPLIT_ROWS = 1024
#: Logical rows a split of B4 walks (before :func:`split_chunk` evens the
#: chunks out in whole pages).  Of the same candidates, in the same order,
#: the first that kept every paged serving path's teacher-forced gap
#: within TEACHER_GAP: gemma2-2b's paged gap was 0.0408 with 256 rows,
#: and 0.0597 with 512, with 1024 and with the count that fills the card
#: (PERF.md §6; ``scripts/torch_decode_variants.py --paged``).
PAGED_SPLIT_ROWS = 256


def decode_splits(s: int, block_kv: int = MAX_BLOCK_KV) -> int:
    """Splits of each slot's cache of ``s`` rows for B3: chunks of
    SPLIT_ROWS rows (at least a ``block_kv``-token block), at most
    MAX_SPLITS.  From the cache's length alone: the slots' lengths live
    on the card, and reading them would cost a sync."""
    return min(-(-s // max(SPLIT_ROWS, block_kv)), MAX_SPLITS)


def paged_splits(reach: int, page_size: int) -> int:
    """Splits of each slot's block table for B4 (``csrc/
    paged_decode_attention.cu``): chunks of PAGED_SPLIT_ROWS logical rows
    (at least a page), at most MAX_SPLITS, from the table's reach
    (columns x ``page_size``) alone, never from ``lengths``.
    :func:`split_chunk` with ``block_kv=page_size`` evens them out in
    whole pages."""
    return min(-(-reach // max(PAGED_SPLIT_ROWS, page_size)), MAX_SPLITS)


def split_chunk(s: int, splits: int, block_kv: int = MAX_BLOCK_KV) -> int:
    """Cache rows a split: ``splits`` chunks of whole ``block_kv``-token
    blocks covering ``s`` rows (the last may be shorter, and fewer chunks
    may do: ``ceil(s / chunk)`` is the launch's count)."""
    if splits < 1:
        raise ValueError(f"decode_attention: splits {splits} < 1")
    blocks = -(-s // block_kv)
    return -(-blocks // min(splits, blocks)) * block_kv


#: device -> (B x Hkv,) int32 counters of the in-grid merge, zero
#: between launches (the last CTA of a row group resets its own); B3
#: and B4 share them, launching on one stream
_COUNTERS: Dict[torch.device, torch.Tensor] = {}


def merge_counters(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters on ``device``."""
    have = _COUNTERS.get(device)
    if have is None or have.numel() < n:
        have = torch.zeros(max(n, 2 * (0 if have is None else have.numel())),
                           dtype=torch.int32, device=device)
        _COUNTERS[device] = have
    return have


#: Pool element types of the quantized kernels (B5, B6's quantized mode).
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)


def check_decode_operands(name: str, q, k, v, lengths, *,
                          quantized: bool = False, mla: bool = False) -> int:
    """Shape/type checks shared by the decode launchers; ``k``/``v`` are
    caches (B, Hkv, S, D) or pools (Hkv, P, ps, D), ``v`` of its own
    width where ``mla`` allows a build of ``MLA_DIMS``.  Quantized pools
    must hold a storage type the kernels have (int8, fp8-e4m3);
    unquantized ones q's dtype.  Returns the value head dim."""
    b, hq, d = q.shape[0], q.shape[-2], q.shape[-1]
    dv = v.shape[-1]
    if k.shape[:-1] != v.shape[:-1] or k.shape[-1] != d:
        raise ValueError(f"{name}: k/v {tuple(k.shape)}/{tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if dv != d:
        if not mla or (d, dv) not in MLA_DIMS:
            raise NotImplementedError(
                f"{name} kernel: head dims ({d}, {dv}) (built for "
                f"{MLA_DIMS if mla else 'equal key and value widths'})")
    elif d not in HEAD_DIMS:
        raise NotImplementedError(f"{name} kernel: head dim {d} (built for "
                                  f"{HEAD_DIMS})")
    if quantized:
        if k.dtype != v.dtype or k.dtype not in QUANT_DTYPES:
            raise TypeError(f"{name}: quantized pools must be one of "
                            f"{QUANT_DTYPES}, got {k.dtype}, {v.dtype}")
    elif not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"{name}: mixed dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if lengths.shape != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"{name}: lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    return dv


def residual_outputs(q, dv: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Empty f32 (acc, m, l) for q (..., D): acc (..., dv) (dv = D by
    default), m/l without the head dim."""
    f32 = dict(dtype=torch.float32, device=q.device)
    dv = q.shape[-1] if dv is None else dv
    return (torch.empty(q.shape[:-1] + (dv,), **f32),
            torch.empty(q.shape[:-1], **f32),
            torch.empty(q.shape[:-1], **f32))


def decode_attention_fwd(q, k_cache, v_cache, lengths, *,
                         window: Optional[int], softcap: Optional[float],
                         scale: Optional[float], block_kv: int,
                         splits: Optional[int] = None):
    """q: (B, Hq, Dk); caches: (B, Hkv, S, Dk|Dv); lengths: (B,) int32.
    ``splits``: chunks of each cache (None: :func:`decode_splits`)."""
    dv = check_decode_operands("decode_attention", q, k_cache, v_cache,
                               lengths, mla=True)
    b, hq, d = q.shape
    hkv, s = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} vs cache "
                         f"{tuple(k_cache.shape)} (group <= {MAX_GROUP})")
    if not 1 <= block_kv <= MAX_BLOCK_KV:
        raise ValueError(f"decode_attention: block_kv {block_kv} not in "
                         f"[1, {MAX_BLOCK_KV}]")
    if splits is not None and not 1 <= splits <= MAX_SPLITS:
        raise ValueError(f"decode_attention: splits {splits} not in "
                         f"[1, {MAX_SPLITS}]")
    check_cuda("decode_attention", q, k_cache, v_cache, lengths)
    if splits is None:
        splits = decode_splits(s, block_kv)
    chunk = split_chunk(s, splits, block_kv)
    n = -(-s // chunk)              # <= splits
    acc, m, l = residual_outputs(q, dv)
    parts = (None,) * 4
    if n > 1:
        f32 = dict(dtype=torch.float32, device=q.device)
        parts = (torch.empty(n, b, hq, dv, **f32),
                 torch.empty(n, b, hq, **f32), torch.empty(n, b, hq, **f32),
                 merge_counters(q.device, b * hkv))
    KERNEL.launch(ptr(q), ptr(k_cache), ptr(v_cache), ptr(lengths), ptr(acc),
                  ptr(m), ptr(l), *(None if t is None else ptr(t)
                                    for t in parts),
                  b, hq, hkv, s, d, dv, block_kv, chunk,
                  float(d ** -0.5 if scale is None else scale),
                  int(window or 0), float(softcap or 0.0), dtype_code(q),
                  stream_of(q))
    return acc, m, l
