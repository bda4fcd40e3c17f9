"""B4's split-KV paged decode on the CPU: its rounding model and its rule.

The kernel (``csrc/paged_decode_attention.cu``) splits each slot's
block-table row into chunks of whole logical pages and merges the
chunks' partials in chunk order; ``paged_decode_attention_ref(chunk=c)``
is its plain version.  Here it is held to ``repro``: against
``repro``'s paged reference run on each chunk's columns of the table
(the lengths shifted back by the chunk's first row, which keeps every
query-to-key distance) and merged by ``repro``'s ``combine_partials``,
under ``target("generic")``; and against the port's unsplit plain
version (m exactly: a max has no order).  The tables are scrambled,
with null-page tails, an empty slot, a window, and logical pages of 16
carved from physical pages of 64 (``paged.repage``).  The split rule
``paged_splits`` is pinned at the served shapes, and the launcher is
shown to pick its chunk without reading ``lengths``.  The kernel itself
runs only on the card (tests/test_torch_gpu.py).
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
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.decode_attention import ref as dec_ref

NEG_INF = dec_ref.NEG_INF

# (name, B, Hq, Hkv, T columns, page, logical page, Dk, Dv, lengths,
#  chunk, window, softcap)
CASES = [
    ("group 4, lengths 0, 1, full", 3, 8, 2, 6, 16, 16, 32, 32,
     (0, 1, 96), 32, None, None),
    ("chunk edge +-1", 4, 8, 2, 6, 16, 16, 32, 32, (31, 32, 33, 64), 32,
     None, None),
    ("window across a chunk edge", 3, 8, 2, 6, 16, 16, 32, 32,
     (40, 70, 96), 32, 20, None),
    ("softcap, ragged last chunk", 3, 4, 4, 7, 16, 16, 32, 32,
     (5, 63, 112), 48, None, 20.0),
    ("logical pages of 16 in pages of 64", 3, 8, 2, 2, 64, 16, 32, 32,
     (0, 70, 128), 48, None, None),
    ("logical 16 of 64, window and softcap", 2, 8, 2, 3, 64, 16, 16, 16,
     (150, 192), 32, 40, 30.0),
    ("group 8", 2, 16, 2, 4, 16, 16, 16, 16, (15, 64), 16, None, None),
    ("MLA 192/128", 2, 4, 4, 4, 16, 16, 192, 128, (33, 64), 32, None,
     None),
    ("one chunk", 2, 8, 2, 3, 16, 16, 16, 16, (0, 48), 64, None, None),
]


def _rand(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _case(b, hq, hkv, t, ps, dk_, dv, lengths, seed=0):
    """q, pools (Hkv, 1 + B * T, ps, D) and a scrambled table (B, T)
    whose columns past each slot's length are the null page 0."""
    rng = np.random.default_rng(seed)
    n_pages = 1 + b * t
    table = (rng.permutation(b * t).reshape(b, t) + 1).astype(np.int32)
    for i, n in enumerate(lengths):
        table[i, -(-n // ps):] = 0
    return (_rand((b, hq, dk_), rng), _rand((hkv, n_pages, ps, dk_), rng),
            _rand((hkv, n_pages, ps, dv), rng), table,
            np.array(lengths, np.int32))


def _logical(kp, vp, table, logical):
    """The pools and table re-viewed at a smaller logical page."""
    kp, bt = pg.repage(torch.from_numpy(kp), torch.from_numpy(table),
                       logical)
    vp, _ = pg.repage(torch.from_numpy(vp), torch.from_numpy(table),
                      logical)
    return kp.numpy(), vp.numpy(), bt.to(torch.int32).numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_paged_plain_matches_reference_per_chunk(case):
    """paged_decode_attention_ref(chunk=c) against repro's paged
    reference on each chunk's table columns (lengths shifted back by the
    chunk's first row), merged by repro's combine_partials, under
    target("generic"): the normalized outputs within the op's tol."""
    (_, b, hq, hkv, t, ps, lps, dk_, dv, lengths, chunk, window,
     softcap) = case
    q, kp, vp, table, ln = _case(b, hq, hkv, t, ps, dk_, dv, lengths)
    kp, vp, table = _logical(kp, vp, table, lps)
    cols = chunk // lps
    kw = dict(window=window, softcap=softcap)
    with ctx.target("generic"):
        parts = [jref.paged_decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(table[:, c:c + cols]),
            jnp.asarray(ln - np.int32(c * lps)), return_residuals=True,
            **kw) for c in range(0, table.shape[1], cols)]
        want = jref.combine_partials(*(list(x) for x in zip(*parts)))
    got = dec_ref.paged_decode_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, table, ln)), chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **dec_ops.TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_split_paged_plain_matches_unsplit(case):
    """The chunked paged plain version against the unsplit one, and at
    the logical page against the physical: m bit for bit, acc and l
    within the op's f32 tol; an empty slot stays acc 0, m NEG_INF, l 0."""
    (_, b, hq, hkv, t, ps, lps, dk_, dv, lengths, chunk, window,
     softcap) = case
    q, kp, vp, table, ln = _case(b, hq, hkv, t, ps, dk_, dv, lengths, seed=1)
    kw = dict(window=window, softcap=softcap, return_residuals=True)
    want = dec_ref.paged_decode_attention_ref(
        *map(torch.from_numpy, (q, kp, vp, table, ln)), **kw)
    lkp, lvp, ltable = _logical(kp, vp, table, lps)
    acc, m, l = dec_ref.paged_decode_attention_ref(
        *map(torch.from_numpy, (q, lkp, lvp, ltable, ln)), chunk=chunk, **kw)
    assert torch.equal(m, want[1])
    torch.testing.assert_close(acc, want[0], **dec_ops.TOL)
    torch.testing.assert_close(l, want[2], **dec_ops.TOL)
    for i, n in enumerate(lengths):
        if n == 0:
            assert not acc[i].any() and not l[i].any()
            assert (m[i] == NEG_INF).all()


@pytest.mark.parametrize("name,reach,page,splits,chunk", [
    ("granite-8b, deepseek-v2-lite-16b, jamba-1.5-large-398b", 1024, 64, 4,
     256),
    ("gemma2-2b global", 8192, 64, 32, 256),
    ("gemma2-2b global, logical pages of 16", 8192, 16, 32, 256),
    ("a table between chunks", 1000, 8, 4, 256),
    ("a table of a page", 64, 64, 1, 64),
    ("pages wider than a chunk", 8192, 2048, 4, 2048),
    ("a table past MAX_SPLITS chunks", 1 << 15, 64, 64, 512),
])
def test_paged_splits_pinned(name, reach, page, splits, chunk):
    """The paged split rule at the served shapes (tables of 16 and 128
    pages of 64: chunks of PAGED_SPLIT_ROWS rows) and at the edges: whole
    pages, evened out, at most MAX_SPLITS."""
    assert dk.paged_splits(reach, page) == splits
    assert dk.split_chunk(reach, splits, page) == chunk
    assert chunk % page == 0 and -(-reach // chunk) == splits


def _launch_args(monkeypatch):
    launches = []
    monkeypatch.setattr(pg, "check_cuda", lambda *a: None)
    monkeypatch.setattr(pg, "stream_of", lambda t: None)
    monkeypatch.setattr(pg.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(dk, "_COUNTERS", {})
    return launches


def test_launcher_picks_its_split_without_reading_lengths(monkeypatch):
    """The launcher's chunk comes from the table's reach alone: calls
    whose lengths differ (all empty, all full) launch with the same
    chunk, scratch only for several splits, one launch a call, and the
    rule's signature has no lengths."""
    assert "lengths" not in inspect.signature(dk.paged_splits).parameters
    launches = _launch_args(monkeypatch)
    q = torch.zeros(8, 8, 256, dtype=torch.bfloat16)
    pool = torch.zeros(4, 1 + 8 * 128, 64, 256, dtype=torch.bfloat16)
    table = torch.arange(1, 1 + 8 * 128, dtype=torch.int32).reshape(8, 128)
    for n in (0, 8192):
        ln = torch.full((8,), n, dtype=torch.int32)
        for splits in (None, 1):
            pg.paged_decode_attention_fwd(
                q, pool, pool, table, ln, window=None, softcap=None,
                scale=None, page_size=None, block_kv=64, splits=splits)
    assert len(launches) == 4
    # (q, kp, vp, bt, lengths, acc, m, l, parts x 4, b, hq, hkv, n_pages,
    #  page_size, t_cols, d, dv, bk, chunk, ...)
    assert [a[21] for a in launches] == [256, 8192, 256, 8192]
    assert all(p is not None for p in launches[0][8:12])
    assert all(p is None for p in launches[1][8:12])
    assert dk._COUNTERS[q.device].numel() >= 8 * 4
    with pytest.raises(ValueError, match="splits"):
        pg.paged_decode_attention_fwd(
            q, pool, pool, table, ln, window=None, softcap=None, scale=None,
            page_size=None, block_kv=64, splits=dk.MAX_SPLITS + 1)


def test_launcher_chunks_whole_logical_pages(monkeypatch):
    """At a logical page of 16 of 64, the reach counts logical pages and
    the chunk is a whole number of them, and the table handed to the
    kernel names them."""
    launches = _launch_args(monkeypatch)
    q = torch.zeros(2, 8, 128, dtype=torch.bfloat16)
    pool = torch.zeros(2, 1 + 2 * 5, 64, 128, dtype=torch.bfloat16)
    table = torch.arange(1, 11, dtype=torch.int32).reshape(2, 5)
    ln = torch.tensor([3, 320], dtype=torch.int32)
    pg.paged_decode_attention_fwd(q, pool, pool, table, ln, window=None,
                                  softcap=None, scale=None, page_size=16,
                                  block_kv=64, splits=3)
    (a,) = launches
    page_size, t_cols, bk, chunk = a[16], a[17], a[20], a[21]
    assert (page_size, t_cols, bk) == (16, 20, 16)
    assert chunk == dk.split_chunk(320, 3, 16) == 112 and chunk % 16 == 0


def test_splits_is_a_schedule_choice_on_the_cpu():
    """On the CPU ops.paged_decode_attention takes the plain version
    whatever ``splits`` asks."""
    q, kp, vp, table, ln = map(torch.from_numpy, _case(
        2, 8, 2, 4, 16, 16, 16, (9, 64), seed=2))
    base = dec_ops.paged_decode_attention(q, kp, vp, table, ln)
    for splits in (1, 3):
        assert torch.equal(dec_ops.paged_decode_attention(
            q, kp, vp, table, ln, splits=splits), base)
