"""The operand-rounding model of B2's bf16 tensor-core body
(``repro_torch.kernels.flash_attention.ref.flash_attention_bf16_operands``)
against the reference's float32 attention (``repro.kernels.
flash_attention.ref``, JAX on the CPU), on the same numpy inputs.

The inputs are drawn from a seed and rounded to bf16, so both sides
start from the same values: the model differs from the reference only
by what the kernel rounds beyond its inputs, P to bf16 before P V (and
the scale applied after the f32 dot, a few f32 ulps).  With P as one
bf16 term each weight p / l moves by at most 2^-9 of itself (round to
nearest; l sums p unrounded), so an output, a combination of V's rows
with weights summing to 1, moves by at most 2^-9 sum |v| p / l <= 2^-9
max |v|; with two terms (P_hi + P_lo: the remainder p - P_hi rounded
too) by 2^-18, with three by 2^-27, under the two sides' f32
summation orders.  Each case is held at that bound (``_bound``) plus
1e-5 for those orders, and must differ from the reference somewhere
(a model that forgot to round P would not).  The
kernel itself is held to this model on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``) by the share of its
bf16 outputs that differ (``ref.MODEL_MISMATCH``); the last test shows
on the model that this share tells one P term fewer from another
summation order.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ref as jflash_ref
from repro_torch.kernels.flash_attention import ref as fa_ref

#: (Dk, Dv): the four builds of the kernel
DIMS = [(64, 64), (128, 128), (256, 256), (192, 128)]
#: (label, Sq, Skv, causal, window, softcap, q_offset)
MASKS = [
    ("causal", 128, 128, True, None, None, 0),
    ("window 32, softcap 30", 130, 130, True, 32, 30.0, 0),
    ("ragged, no mask", 37, 100, False, None, None, 0),
    ("q offset 63", 37, 100, True, None, None, 63),
]


def _bf16_values(shape, seed):
    """Standard normal draws rounded to bf16, held as float32."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).bfloat16().float().numpy()


def _bound(v, p_terms: int = 1) -> float:
    return 2.0 ** (-9 * p_terms) * float(np.abs(v).max()) + 1e-5


@pytest.mark.parametrize("p_terms", [1, 2, 3])
@pytest.mark.parametrize("mask", MASKS, ids=[m[0] for m in MASKS])
@pytest.mark.parametrize("dk,dv", DIMS, ids=[f"{a}-{b}" for a, b in DIMS])
def test_rounding_model_matches_reference(dk, dv, mask, p_terms):
    _, sq, skv, causal, window, softcap, q_offset = mask
    q = _bf16_values((2, 4, sq, dk), 0)
    k = _bf16_values((2, 2, skv, dk), 1)
    v = _bf16_values((2, 2, skv, dv), 2)
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=dk ** -0.5, q_offset=q_offset)
    want = np.asarray(jflash_ref.flash_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw))
    got = fa_ref.flash_attention_bf16_operands(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        p_terms=p_terms, **kw).numpy()
    assert got.shape == want.shape == (2, 4, sq, dv)
    err = np.abs(got - want).max()
    assert 0 < err <= _bound(v, p_terms), (err, _bound(v, p_terms))


def test_rounding_model_without_live_keys_gives_zero():
    """A row with no live key (every key ahead of it, causal, with a
    negative q offset) comes out as 0, as the kernel's l == 0 guard
    gives, where a plain softmax would spread it."""
    q, k, v = (torch.from_numpy(_bf16_values(s, i)) for i, s in
               enumerate([(1, 2, 8, 64), (1, 1, 8, 64), (1, 1, 8, 64)]))
    got = fa_ref.flash_attention_bf16_operands(q, k, v, q_offset=-4)
    assert torch.equal(got[:, :, :4], torch.zeros_like(got[:, :, :4]))
    assert got[:, :, 4:].abs().sum() > 0


def test_rounding_model_keeps_bf16_outputs():
    q, k, v = (torch.from_numpy(_bf16_values((1, 2, 70, 64), i)).bfloat16()
               for i in range(3))
    got = fa_ref.flash_attention_bf16_operands(q, k, v)
    assert got.dtype == torch.bfloat16
    want = fa_ref.flash_attention_bf16_operands(q.float(), k.float(),
                                                v.float())
    assert torch.equal(got, want.bfloat16())


@pytest.mark.parametrize("mask", MASKS[:2], ids=[m[0] for m in MASKS[:2]])
@pytest.mark.parametrize("dk,dv", DIMS, ids=[f"{a}-{b}" for a, b in DIMS])
def test_model_mismatch_sees_one_p_term_fewer(dk, dv, mask):
    """The card's check of the kernel against the model (the share of
    bf16 outputs that differ, at most ``MODEL_MISMATCH``), shown on the
    model itself: another f32 summation order (kv tiles of 32 in place
    of 64) stays far inside the limit, and so does a third P term, while
    one term fewer than the kernel's (the control ``chip_smoke.py``
    builds) lies far past it."""
    _, sq, skv, causal, window, softcap, q_offset = mask
    q, k, v = (torch.from_numpy(_bf16_values(s, i)).bfloat16() for i, s in
               enumerate([(2, 4, 4 * sq, dk), (2, 2, 4 * skv, dk),
                          (2, 2, 4 * skv, dv)]))
    kw = dict(causal=causal, window=window, softcap=softcap,
              scale=dk ** -0.5, q_offset=q_offset)
    model = fa_ref.flash_attention_bf16_operands
    want = model(q, k, v, **kw)
    limit = fa_ref.MODEL_MISMATCH
    reordered = fa_ref.model_mismatch(model(q, k, v, block_kv=32, **kw),
                                      want)
    assert 0 < reordered <= limit / 4, reordered
    more = fa_ref.model_mismatch(
        model(q, k, v, p_terms=fa_ref.P_TERMS + 1, **kw), want)
    assert more <= limit / 4, more
    fewer = fa_ref.model_mismatch(
        model(q, k, v, p_terms=fa_ref.P_TERMS - 1, **kw), want)
    assert fewer >= 4 * limit, fewer
