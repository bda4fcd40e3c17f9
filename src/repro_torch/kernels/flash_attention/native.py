"""Flash attention the pre-paper way, hard-coded against CUDA (B11b):
the counterpart of ``repro.kernels.flash_attention.native``.

``csrc/native/flash_attention_native.cu`` computes what
``csrc/flash_attention.cu`` computes, in the same order, without the
device runtime, so the two give bit-identical outputs;
``repro_torch.bench.parity`` holds them so and compares their SASS.
Like the reference's native kernel it takes causal, window, softcap
and GQA, but equal q and kv lengths, no q offset, and equal key and
value widths (64, 128 or 256).  A CPU tensor takes the plain version
(``ref.py``), a CUDA tensor the kernel, which raises on what it cannot
take.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.kernels.flash_attention.flash_attention import HEAD_DIMS

_i, _f, _p = ctypes.c_int, ctypes.c_float, ctypes.c_void_p
KERNEL = CudaKernel(
    "flash_attention_native", "native/flash_attention_native.cu",
    "flash_attention_native_fwd",
    [_p] * 4 + [_i] * 5 + [_f, _i, _i, _f, _i, _p])


def flash_attention_native(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """GQA attention.  q: (B, Hq, S, D); k, v: (B, Hkv, S, D) ->
    (B, Hq, S, D)."""
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, causal=causal,
                                        window=window, softcap=softcap,
                                        scale=scale)
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention_native: want q (B,Hq,S,D) and "
                         f"k, v (B,Hkv,S,D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d) or hq % hkv:
        raise ValueError(f"flash_attention_native: q {tuple(q.shape)} does "
                         f"not match k/v {tuple(k.shape)} (equal lengths "
                         f"and widths, Hq a multiple of Hkv)")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash_attention_native kernel: head dim "
                                  f"{d} (built for {HEAD_DIMS})")
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention_native: mixed dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    check_cuda("flash_attention_native", q, k, v)
    scale = d ** -0.5 if scale is None else scale
    o = torch.empty_like(q)
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(o), b, hq, hkv, s, d,
                  float(scale), int(causal), int(window or 0),
                  float(softcap or 0.0), dtype_code(q), stream_of(q))
    return o
