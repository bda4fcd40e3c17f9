"""Public flash-attention op (forward only: serving needs no backward).

A CPU tensor takes the plain version, a CUDA tensor the hand-written
kernel.  Values may be narrower than keys (MLA: Dk 192, Dv 128).  The
reference's traced ``q_offset`` (sequence-parallel shards) belongs to
a later slice and raises here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention as _kern
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.obs.profile import device_op

#: Tolerance of the reference op (``core/op.py`` default), f32.
TOL = {"atol": 2e-5, "rtol": 2e-5}


@device_op
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """GQA attention.  q: (B, Hq, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B,
    Hkv, Skv, Dv) -> (B, Hq, Sq, Dv)."""
    if not isinstance(q_offset, int):
        raise NotImplementedError("a traced q_offset (sequence-parallel "
                                  "shards) arrives with the distribution "
                                  "slice")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset)
    if q.device.type == "cpu":
        return _ref.flash_attention_ref(q, k, v, **kw)
    return _kern.flash_attention_fwd(q, k, v, **kw)
