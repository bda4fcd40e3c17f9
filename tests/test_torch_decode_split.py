"""B3's split-KV decode on the CPU: its rounding model and its split rule.

The kernel (``csrc/decode_attention.cu``) splits each slot's cache into
chunks of whole blocks and merges the chunks' partials in chunk order;
``decode_attention_ref(chunk=c)`` is its plain version and
``combine_partials`` the merge.  Here both are held to ``repro``: the
port's merge against ``repro``'s ``combine_partials`` on the same numpy
partials, the chunked plain version against ``repro``'s
``decode_attention_ref`` run chunk by chunk and merged by ``repro``'s
``combine_partials`` (under ``target("generic")``), and the chunked
plain version against the unsplit one (m exactly: a max has no order).
The split rule ``decode_splits`` is pinned at the served shapes, and
the launcher is shown to pick its chunk without reading ``lengths``.
The kernel itself runs only on the card (tests/test_torch_gpu.py).
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ctx
from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import decode_attention as dk
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref

NEG_INF = dec_ref.NEG_INF


def _rand(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _partials(rng, b=3, hq=4, d=16, n=4):
    """n partials (acc, m, l) of (b, hq): partial 1 empty in every row,
    row (0, 0) empty in every partial, the rest live."""
    accs, ms, ls = [], [], []
    for j in range(n):
        m = _rand((b, hq), rng) * 3.0
        l = np.abs(_rand((b, hq), rng)) + 0.5
        acc = _rand((b, hq, d), rng) * l[..., None]
        empty = np.zeros((b, hq), bool)
        empty[0, 0] = True
        if j == 1:
            empty[:] = True
        m[empty], l[empty], acc[empty] = NEG_INF, 0.0, 0.0
        accs.append(acc), ms.append(m), ls.append(l)
    return accs, ms, ls


@pytest.mark.parametrize("n", [1, 2, 4, 7])
def test_combine_partials_matches_reference(n):
    """The port's merge, normalized, equals repro's combine_partials on
    the same partials; a row empty in every partial stays acc 0, m
    NEG_INF, l 0 exactly; m is the partials' max."""
    rng = np.random.default_rng(n)
    accs, ms, ls = _partials(rng, n=n)
    acc, m, l = dec_ref.combine_partials(
        *(tuple(torch.from_numpy(x) for x in xs) for xs in (accs, ms, ls)))
    want = jref.combine_partials([jnp.asarray(a) for a in accs],
                                 [jnp.asarray(x) for x in ms],
                                 [jnp.asarray(x) for x in ls])
    np.testing.assert_allclose(dec_ref.normalize(acc, l, torch.float32),
                               np.asarray(want), **dec_ops.TOL)
    assert (acc[0, 0] == 0).all() and l[0, 0] == 0 and m[0, 0] == NEG_INF
    assert torch.equal(m, torch.from_numpy(np.max(np.stack(ms), axis=0)))


def test_combine_partials_carries_nan():
    """NaN in one partial's acc reaches the merged row (NaN in a V row
    propagates to its slot), even where that partial's weight is 0."""
    rng = np.random.default_rng(9)
    accs, ms, ls = _partials(rng, n=3)
    accs[1][2, 1, 5] = np.nan            # partial 1 is empty: weight 0
    acc, _, _ = dec_ref.combine_partials(
        *(tuple(torch.from_numpy(x) for x in xs) for xs in (accs, ms, ls)))
    assert torch.isnan(acc[2, 1, 5]) and not torch.isnan(acc[2, 0]).any()


# (name, B, Hq, Hkv, S, Dk, Dv, lengths, chunk, window, softcap)
CASES = [
    ("group 4, lengths 0, 1, S", 3, 8, 2, 96, 32, 32, (0, 1, 96), 32,
     None, None),
    ("chunk edge +-1", 4, 8, 2, 96, 32, 32, (31, 32, 33, 64), 32, None,
     None),
    ("window across a chunk edge", 3, 8, 2, 96, 32, 32, (40, 70, 96), 32,
     20, None),
    ("softcap", 3, 8, 2, 96, 32, 32, (5, 63, 96), 32, None, 20.0),
    ("window and softcap, ragged last chunk", 3, 4, 4, 100, 32, 32,
     (1, 65, 100), 64, 40, 30.0),
    ("group 1", 2, 4, 4, 64, 16, 16, (17, 64), 16, None, None),
    ("group 2", 2, 4, 2, 64, 16, 16, (16, 49), 16, None, None),
    ("group 8", 2, 16, 2, 64, 16, 16, (15, 64), 16, None, None),
    ("MLA 192/128", 2, 4, 4, 64, 192, 128, (33, 64), 32, None, None),
    ("one chunk", 2, 8, 2, 48, 16, 16, (0, 48), 64, None, None),
]


def _case(b, hq, hkv, s, dk_, dv, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return (_rand((b, hq, dk_), rng), _rand((b, hkv, s, dk_), rng),
            _rand((b, hkv, s, dv), rng), np.array(lengths, np.int32))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_plain_matches_reference_per_chunk(case):
    """decode_attention_ref(chunk=c) against repro's decode_attention_ref
    on each chunk (its kv_offset), merged by repro's combine_partials,
    under target("generic"): the normalized outputs within the op's
    tol."""
    _, b, hq, hkv, s, dk_, dv, lengths, chunk, window, softcap = case
    q, kc, vc, ln = _case(b, hq, hkv, s, dk_, dv, lengths)
    kw = dict(window=window, softcap=softcap)
    with ctx.target("generic"):
        parts = [jref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kc[:, :, j:j + chunk]),
            jnp.asarray(vc[:, :, j:j + chunk]), jnp.asarray(ln),
            kv_offset=j, return_residuals=True, **kw)
            for j in range(0, s, chunk)]
        want = jref.combine_partials(*(list(x) for x in zip(*parts)))
    got = dec_ref.decode_attention_ref(
        *map(torch.from_numpy, (q, kc, vc, ln)), chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **dec_ops.TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_plain_matches_unsplit(case):
    """The chunked plain version against the unsplit one: m bit for bit,
    acc and l within the op's f32 tol; an empty slot stays acc 0, m
    NEG_INF, l 0."""
    _, b, hq, hkv, s, dk_, dv, lengths, chunk, window, softcap = case
    args = tuple(map(torch.from_numpy, _case(b, hq, hkv, s, dk_, dv,
                                             lengths, seed=1)))
    kw = dict(window=window, softcap=softcap, return_residuals=True)
    acc, m, l = dec_ref.decode_attention_ref(*args, chunk=chunk, **kw)
    want = dec_ref.decode_attention_ref(*args, **kw)
    assert torch.equal(m, want[1])
    torch.testing.assert_close(acc, want[0], **dec_ops.TOL)
    torch.testing.assert_close(l, want[2], **dec_ops.TOL)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not acc[i].any() and not l[i].any()
            assert (m[i] == NEG_INF).all()


@pytest.mark.parametrize("name,s,splits,chunk", [
    ("granite-8b, jamba-1.5-large-398b, deepseek-v2-lite-16b", 1024, 1,
     1024),
    ("gemma2-2b global", 8192, 8, 1024),
    ("gemma2-2b ring", 4096, 4, 1024),
    ("a cache between chunks", 1500, 2, 768),
    ("a short cache", 100, 1, 128),
    ("a cache past MAX_SPLITS chunks", 1 << 17, 64, 2048),
])
def test_decode_splits_pinned(name, s, splits, chunk):
    """The split rule at the served dense shapes (chunks of SPLIT_ROWS
    rows) and at the edges: whole blocks, evened out, at most
    MAX_SPLITS."""
    assert dk.decode_splits(s) == splits
    assert dk.split_chunk(s, splits) == chunk
    assert -(-s // chunk) == splits


def test_split_chunk_whole_blocks():
    """Chunks are whole blocks, cover the cache, and a launch never has
    more splits than asked."""
    for s in (1, 63, 64, 65, 300, 1024, 8192):
        for bk in (16, 64):
            for splits in (1, 2, 3, 5, 8, 64):
                chunk = dk.split_chunk(s, splits, bk)
                assert chunk % bk == 0 and chunk >= bk
                assert 1 <= -(-s // chunk) <= splits
            assert dk.split_chunk(s, 1, bk) >= s
            assert 1 <= dk.decode_splits(s, bk) <= dk.MAX_SPLITS


def test_launcher_picks_its_split_without_reading_lengths(monkeypatch):
    """The launcher's chunk comes from the cache's length alone: calls
    whose lengths differ (all empty, all full) launch with the same
    chunk, scratch only for several splits, and the rule's signature has
    no lengths."""
    assert "lengths" not in inspect.signature(dk.decode_splits).parameters
    launches = []
    monkeypatch.setattr(dk, "check_cuda", lambda *a: None)
    monkeypatch.setattr(dk, "stream_of", lambda t: None)
    monkeypatch.setattr(dk.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(dk, "_COUNTERS", {})
    q = torch.zeros(8, 8, 256, dtype=torch.bfloat16)
    cache = torch.zeros(8, 4, 8192, 256, dtype=torch.bfloat16)
    for n in (0, 8192):
        ln = torch.full((8,), n, dtype=torch.int32)
        for splits in (None, 1):
            dk.decode_attention_fwd(q, cache, cache, ln, window=None,
                                    softcap=None, scale=None, block_kv=64,
                                    splits=splits)
    # (..., parts x 4, b, hq, hkv, s, d, dv, bk, chunk, ...)
    assert [a[18] for a in launches] == [1024, 8192, 1024, 8192]
    assert all(p is not None for p in launches[0][7:11])
    assert all(p is None for p in launches[1][7:11])
    assert dk._COUNTERS[q.device].numel() >= 8 * 4
    with pytest.raises(ValueError, match="splits"):
        dk.decode_attention_fwd(q, cache, cache, ln, window=None,
                                softcap=None, scale=None, block_kv=64,
                                splits=dk.MAX_SPLITS + 1)


def test_splits_is_a_schedule_choice_on_the_cpu():
    """On the CPU ops.decode_attention takes the plain version whatever
    ``splits`` asks."""
    q, kc, vc, ln = map(torch.from_numpy,
                        _case(2, 8, 2, 64, 16, 16, (9, 64), seed=2))
    base = dec_ops.decode_attention(q, kc, vc, ln)
    for splits in (1, 3):
        assert torch.equal(dec_ops.decode_attention(q, kc, vc, ln,
                                                    splits=splits), base)
