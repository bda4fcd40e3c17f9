"""Public flash-attention op (forward only: serving needs no backward).

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel.  The reference's traced ``q_offset`` (sequence-parallel shards)
and Dk != Dv (MLA) belong to later slices and raise here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kern
from repro_torch.kernels.flash_attention import ref as _ref

#: Tolerance of the reference op (``core/op.py`` default), f32.
TOL = {"atol": 2e-5, "rtol": 2e-5}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA attention.  q: (B, Hq, Sq, D); k, v: (B, Hkv, Skv, D)."""
    if not isinstance(q_offset, int):
        raise NotImplementedError("a traced q_offset (sequence-parallel "
                                  "shards) arrives with the distribution "
                                  "slice")
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError("Dk != Dv (MLA) arrives with the MoE/MLA "
                                  "slice")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, **kw)
    return _kern.flash_attention_fwd(q, k, v, **kw)
