"""Launcher of the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

Head dims: equal key and value widths of 64, 128 or 256, or MLA's 192
query/key columns over 128 value columns.

Differences from the plain version that are by design: a row whose
every key is masked comes out as 0 (the reference kernel's ``l == 0``
guard), where the plain softmax spreads it uniformly; causal prefill
never produces such a row.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core import tuning
from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention", "flash_attention.cu", "flash_attention_fwd",
    [_p] * 4 + [_i] * 7 + [_f, _i, _i, _f, _i, _i, _i, _i, _p])

HEAD_DIMS = (64, 128, 256)
#: (Dk, Dv) builds with values narrower than keys (MLA).
MLA_DIMS = ((192, 128),)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: Optional[int],
                        softcap: Optional[float], scale: Optional[float],
                        q_offset: int) -> torch.Tensor:
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv)
    -> (B, Hq, Sq, Dv)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape[:3] != k.shape[:3]:
        raise ValueError(f"flash_attention: want q (B,Hq,Sq,Dk), k "
                         f"(B,Hkv,Skv,Dk) and v (B,Hkv,Skv,Dv), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, skv, dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != b or k.shape[3] != d or hq % hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} does not "
                         f"match k/v {tuple(k.shape)}")
    if dv != d and (d, dv) not in MLA_DIMS:
        raise NotImplementedError(f"flash_attention kernel: head dims "
                                  f"({d}, {dv}) (built for {MLA_DIMS})")
    if dv == d and d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention kernel: head dim {d} "
                                  f"(built for {HEAD_DIMS})")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    check_cuda("flash_attention", q, k, v)
    scale = d ** -0.5 if scale is None else scale
    o = q.new_empty((b, hq, sq, dv))
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), b, hq, hkv, sq, skv, d, dv,
                  float(scale), int(causal), int(window or 0),
                  float(softcap or 0.0), int(q_offset),
                  tuning.block_size("flash_attention", "block_q"),
                  tuning.block_size("flash_attention", "block_kv"),
                  dtype_code(q), stream_of(q))
    return o
