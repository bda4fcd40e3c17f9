"""Plain PyTorch flash attention (transcribed from
``repro.kernels.flash_attention.ref``): causal, sliding-window and
softcap masks, GQA, f32 softmax; and the operand-rounding model of the
kernel's bf16 body (:func:`flash_attention_bf16_operands`), which the
tests and ``chip_smoke.py`` hold the kernel to and the serving path
never calls."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large-negative instead of -inf: masked rows stay NaN-free


def attention_mask(q_len: int, kv_len: int, *, causal: bool,
                   window: Optional[int], q_offset: int = 0,
                   device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; ``q_offset`` positions queries globally."""
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    k_pos = torch.arange(kv_len, device=device)[None, :]
    m = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if causal:
        m &= q_pos >= k_pos
    if window is not None:
        m &= (q_pos - k_pos) < window
    return m


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        scale: Optional[float] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Sq, Dk); k: (B, Hkv, Skv, Dk); v: (B, Hkv, Skv, Dv)
    -> (B, Hq, Sq, Dv)."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale

    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    scores = torch.where(mask[None, None], scores,
                         torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)


#: The bf16 terms of P in the kernel's P V (``constexpr int P_TERMS`` in
#: ``csrc/flash_attention.cu`` and its twin): 2 keeps about 16 bits of p.
P_TERMS = 2
#: The largest share of bf16 outputs that may differ from the model's.
#: Kernel and model round the same operands and part only by their f32
#: summation orders, which flip an output's last bit where its f32 value
#: lies within a few f32 ulps of a bf16 rounding boundary: about 0.1% of
#: outputs.  One P term fewer moves each output by up to 2^-9 of |V|,
#: about an output's own bf16 ulp, and changes a third of them (both
#: measured on the model: tests/test_torch_flash_rounding.py).
MODEL_MISMATCH = 0.02


def model_mismatch(got: torch.Tensor, want: torch.Tensor) -> float:
    """The share of outputs whose bf16 values differ between ``got`` (the
    kernel's) and ``want`` (:func:`flash_attention_bf16_operands`)."""
    assert got.shape == want.shape, (got.shape, want.shape)
    return float((got.bfloat16() != want.bfloat16()).float().mean())


def flash_attention_bf16_operands(q, k, v, *, causal: bool = True,
                                  window: Optional[int] = None,
                                  softcap: Optional[float] = None,
                                  scale: Optional[float] = None,
                                  q_offset: int = 0, block_kv: int = 64,
                                  p_terms: int = P_TERMS) -> torch.Tensor:
    """What ``csrc/flash_attention.cu``'s bf16 body computes, rounding
    where it rounds: Q, K and V in bf16; S = Q K^T summed in f32, then
    multiplied by the scale in f32; the online softmax over kv tiles of
    ``block_kv`` keys in f32, with P carried into P V as ``p_terms`` bf16
    terms (the first rounds p, each next one the remainder the earlier
    left, each multiplied by V; the kernel's is :data:`P_TERMS`) and l
    summing p in f32; an exact division by l (0 for a row with no live
    key).  Shapes as :func:`flash_attention_ref`; the output in q's
    dtype."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    assert hq % hkv == 0, (hq, hkv)
    group = hq // hkv
    scale = (d ** -0.5) if scale is None else scale
    bf = torch.bfloat16
    qf = q.to(bf).float()
    kf = k.to(bf).float().repeat_interleave(group, dim=1)
    vf = v.to(bf).float().repeat_interleave(group, dim=1)
    mask = attention_mask(sq, skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    m = torch.full((b, hq, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hq, sq, 1), device=q.device)
    acc = torch.zeros((b, hq, sq, v.shape[3]), device=q.device)
    for k0 in range(0, skv, block_kv):
        k1 = min(k0 + block_kv, skv)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k1]) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        s = torch.where(mask[None, None, :, k0:k1], s,
                        torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        live = m_new > NEG_INF / 2
        alpha = torch.where(live, torch.exp(m - m_new), torch.zeros_like(m))
        p = torch.where(live, torch.exp(s - m_new), torch.zeros_like(s))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha
        rest = p
        for _ in range(p_terms):
            term = rest.to(bf).float()
            rest = rest - term
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", term,
                                     vf[:, :, k0:k1])
        m = m_new
    l = torch.where(l == 0, torch.ones_like(l), l)
    return (acc / l).to(q.dtype)
