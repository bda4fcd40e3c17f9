"""B10's chunkwise form on the CPU: its plain version against repro's.

The kernel (``csrc/mlstm_scan.cu``) runs the mLSTM recurrence chunk by
chunk in its parallel form (xLSTM's chunkwise mLSTM): within a chunk
the scores Q K^T, the decay matrix D and the state carried in, across
chunks the state (C, n, m).  ``mlstm_scan_ref(chunk=L)`` is its plain
version.  Here it is held, h and the final (C, n, m), to repro's
recurrent ``mlstm_scan_ref`` on the same numpy inputs at the op's
tolerance (2e-4), for f32 and bf16 activations, key head dims of 32
(the registry example) and 8, one step, fewer steps than a chunk, whole
chunks and a short last chunk, and gates that drive the stabilizer far
below and far above 0.  The kernel itself runs only on the card
(tests/test_torch_gpu.py).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm_scan import ref as jref
from repro_torch.core import tuning
from repro_torch.kernels.mlstm_scan import ops as mlstm_ops
from repro_torch.kernels.mlstm_scan import ref as mlstm_ref

#: the kernel's chunk (its bf16 body's L), and half of it
CHUNKS = (tuning.block_size("mlstm_scan", "chunk"),
          tuning.block_size("mlstm_scan", "chunk") // 2)

#: i and f pre-activations: (i mean, i std, f mean, f std).  "neutral"
#: as the gpu tests draw them; "m_low" holds i far below 0 with a
#: forget gate near 1, so m sits near -40 and exp(-m) beats |n . q|;
#: "m_high" holds i far above 0, so m sits near +40; "forgetful" makes
#: log_sig(f) near -6 a step, so the cumulative forget gate spans
#: hundreds within a chunk
GATES = {"neutral": (0.0, 1.0, 2.0, 1.0),
         "m_low": (-40.0, 2.0, 8.0, 1.0),
         "m_high": (40.0, 2.0, 2.0, 1.0),
         "forgetful": (0.0, 3.0, -6.0, 1.0)}


def _inputs(b, h, s, dk, dv, gates, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32)
               for d in (dk, dk, dv))
    im, isd, fm, fsd = GATES[gates]
    ig = (im + isd * rng.standard_normal((b, h, s))).astype(np.float32)
    fg = (fm + fsd * rng.standard_normal((b, h, s))).astype(np.float32)
    return q, k, v, ig, fg


def _both(arrays, dtype):
    """The inputs as torch tensors (q/k/v in ``dtype``, gates f32) and as
    jax arrays holding the same values."""
    q, k, v, ig, fg = (torch.from_numpy(a) for a in arrays)
    q, k, v = (t.to(dtype) for t in (q, k, v))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jdt)
                  for t in (q, k, v))
    return (q, k, v, ig, fg), (jq, jk, jv, jnp.asarray(ig.numpy()),
                               jnp.asarray(fg.numpy()))


def _np(x):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("dk", [32, 8])
@pytest.mark.parametrize("s", [1, 7, 32, 64, 45], ids=lambda s: f"S{s}")
@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"L{c}")
def test_chunkwise_matches_reference(chunk, s, dk, dtype):
    """h and (C, n, m) of the chunkwise plain version against repro's
    recurrence at 2e-4: one step, S < L, S a multiple of L (one chunk
    and two), S off a multiple of L; h in the activations' dtype (bf16
    h at one rounding of bf16)."""
    arrays = _inputs(2, 2, s, dk, 16, "neutral", seed=s + dk)
    (q, k, v, ig, fg), jargs = _both(arrays, dtype)
    got, (c, n, m) = mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg,
                                              return_state=True, chunk=chunk)
    want, (wc, wn, wm) = jref.mlstm_scan_ref(*jargs, return_state=True)
    assert got.dtype == dtype and got.shape == (2, 2, s, 16)
    tol = mlstm_ops.TOL if dtype == torch.float32 \
        else dict(atol=1e-2, rtol=1e-2)
    torch.testing.assert_close(got.float(), _np(want), **tol)
    for a, w in ((c, wc), (n, wn), (m, wm)):
        torch.testing.assert_close(a, _np(w), **mlstm_ops.TOL)


def _recurrence_f64(q, k, v, ig, fg):
    """The recurrence of the module docstring in float64 (the accuracy
    both f32 forms are measured against)."""
    b, h, s, dk = q.shape
    scale = dk ** -0.5
    q, k, v = q.double() * scale, k.double() * scale, v.double()
    ig, fg = ig.double(), torch.nn.functional.logsigmoid(fg.double())
    c = torch.zeros(b, h, dk, v.shape[-1], dtype=torch.float64)
    n = torch.zeros(b, h, dk, dtype=torch.float64)
    m = torch.full((b, h), float("-inf"), dtype=torch.float64)
    hs = []
    for t in range(s):
        m_new = torch.maximum(fg[..., t] + m, ig[..., t])
        i_p, f_p = torch.exp(ig[..., t] - m_new), torch.exp(fg[..., t] + m
                                                            - m_new)
        c = f_p[..., None, None] * c + i_p[..., None, None] * (
            k[..., t, :, None] * v[..., t, None, :])
        n = f_p[..., None] * n + i_p[..., None] * k[..., t, :]
        den = torch.maximum((n * q[..., t, :]).sum(-1).abs(),
                            torch.exp(-m_new))
        hs.append(torch.einsum("bhkv,bhk->bhv", c, q[..., t, :])
                  / den[..., None])
        m = m_new
    return torch.stack(hs, 2), (c, n, m)


def _excess(got, want):
    """max |got - want| / (2e-4 + 2e-4 |want|): above 1 misses TOL."""
    return float(((got.double() - want.double()).abs()
                  / (2e-4 + 2e-4 * want.double().abs())).max())


@pytest.mark.parametrize("gates", sorted(GATES))
@pytest.mark.parametrize("chunk", CHUNKS, ids=lambda c: f"L{c}")
def test_chunkwise_holds_far_stabilizers(chunk, gates):
    """At S 70 (chunks past the first carry a state in), f32, for gates
    that push m far below or above 0, or forget fast: (C, n, m) within
    2e-4 of repro's recurrence, and h and (C, n) within 2e-4 of the
    recurrence in float64.  h is held to repro's at 2e-4 too, except
    where repro's own f32 h misses float64 by more than the tolerance:
    with m near +40, exp(-m) no longer bounds the denominator, and a
    step whose n . q nearly cancels is ill-conditioned (at this seed
    repro's f32 recurrence misses float64 there by 5.6 times 2e-4, the
    chunkwise form by 0.4 times); that row's h is then held to float64
    alone, and the chunkwise form must be the nearer of the two."""
    arrays = _inputs(1, 3, 70, 32, 32, gates, seed=11)
    (q, k, v, ig, fg), jargs = _both(arrays, torch.float32)
    got, (c, n, m) = mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg,
                                              return_state=True, chunk=chunk)
    want, (wc, wn, wm) = jref.mlstm_scan_ref(*jargs, return_state=True)
    want = _np(want)
    exact, (ec, en, _) = _recurrence_f64(q, k, v, ig, fg)
    assert torch.isfinite(got).all() and torch.isfinite(c).all()
    for a, w in ((c, wc), (n, wn), (m, wm)):
        torch.testing.assert_close(a, _np(w), **mlstm_ops.TOL)
    for a, w in ((got, exact), (c, ec), (n, en)):
        assert _excess(a, w) <= 1.0
    if _excess(want, exact) <= 1.0:
        torch.testing.assert_close(got, want, **mlstm_ops.TOL)
    else:
        assert gates == "m_high"
        assert _excess(got, exact) < _excess(want, exact)


@pytest.mark.parametrize("chunk", [1, 5, 16, 100])
def test_chunkwise_matches_recurrent_plain_version(chunk):
    """Any chunk, the port's recurrent plain version (the CPU path of
    ``ops.mlstm_scan``) within 2e-4, and m bit for bit: both walk the
    same max-plus recurrence in the same order."""
    q, k, v, ig, fg = (torch.from_numpy(a)
                       for a in _inputs(2, 2, 50, 32, 32, "neutral", 3))
    got, (c, n, m) = mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg,
                                              return_state=True, chunk=chunk)
    want, (wc, wn, wm) = mlstm_ops.mlstm_scan(q, k, v, ig, fg,
                                              return_state=True)
    for a, w in ((got, want), (c, wc), (n, wn)):
        torch.testing.assert_close(a, w, **mlstm_ops.TOL)
    assert torch.equal(m, wm)


def test_chunkwise_refuses_a_chunk_below_one():
    q, k, v, ig, fg = (torch.from_numpy(a)
                       for a in _inputs(1, 1, 4, 8, 8, "neutral", 0))
    with pytest.raises(ValueError, match="chunk"):
        mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg, chunk=0)


def test_chunkwise_of_no_steps_is_the_zero_state():
    q, k, v, ig, fg = (torch.from_numpy(a)
                       for a in _inputs(1, 2, 0, 8, 16, "neutral", 0))
    out, (c, n, m) = mlstm_ref.mlstm_scan_ref(q, k, v, ig, fg,
                                              return_state=True, chunk=4)
    assert out.shape == (1, 2, 0, 16)
    assert not c.any() and not n.any() and torch.isneginf(m).all()
