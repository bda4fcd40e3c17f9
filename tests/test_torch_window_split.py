"""B7's and B7q's split-KV ring walks on the CPU: their rounding model and
their rule.

The sliding-window kernels (``csrc/window_paged_decode_attention.cu``,
``csrc/quant_window_paged_decode_attention.cu``) run B4's split-KV
kernel in its RING form: each slot's ring table is laid out as a walk in
timeline order from the window's first live page (``paged.ring_walk``),
the walk is cut into chunks of whole logical pages counted from that
page's first token ``start``, and the chunks' partials are merged in
chunk order.  ``window_paged_decode_attention_ref(chunk=c)`` and its
quantized twin are their plain versions.  Here they are held to
``repro``: to its window kernel (``window_paged_decode_attention_fwd``,
and ``quant_window_paged_decode_attention_fwd`` over int8 and fp8 pools)
under ``target("generic")``, and to its dense reference run on each
chunk's rows of the walk (the chunk's first token as ``kv_offset``) and
merged by its ``combine_partials``; and to the port's unchunked plain
version (m exactly: a max has no order).  The rings have wrapped, their
dead columns hold null or stale pages, a window starts inside a chunk,
``start`` is not a multiple of the chunk, a slot is empty, and logical
pages of 16 are carved from pages of 32 (``paged.repage``).  The split
plan is pinned on ring widths, and the launchers are shown to pick their
chunk without reading ``lengths`` and to refuse a split count outside
[1, MAX_SPLITS].  The kernels themselves run only on the card
(tests/test_torch_gpu.py).
"""
from __future__ import annotations

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ctx
from repro.kernels.decode_attention import paged as jpaged
from repro.kernels.decode_attention import quant as jquant
from repro.kernels.decode_attention import ref as jref
from repro_torch.kernels.decode_attention import decode_attention as dk
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as pg
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.serve import paging

NEG_INF = dec_ref.NEG_INF

# (name, window, page, logical page, Hq, Hkv, D, lengths, chunk, softcap,
#  stale dead columns)
CASES = [
    ("start off the chunk grid, an empty slot", 96, 32, 32, 4, 2, 32,
     (0, 1, 95, 96, 130, 450), 64, None, False),
    ("window mid-split, stale dead columns", 96, 32, 32, 8, 2, 32,
     (40, 97, 161, 290, 481), 64, None, True),
    ("a chunk of a page, softcap", 96, 32, 32, 8, 2, 16,
     (3, 130, 200, 333), 32, 30.0, True),
    ("ragged last chunk", 96, 32, 32, 4, 4, 32, (0, 96, 129, 450), 96,
     None, False),
    ("logical pages of 16 in pages of 32", 96, 32, 16, 8, 2, 16,
     (17, 130, 177, 450), 48, None, True),
    ("group 8, window of a page", 32, 32, 32, 16, 2, 16, (1, 33, 70, 95),
     32, 20.0, False),
]


def _ids(cases):
    return [c[0] for c in cases]


def _ring(lengths, window, ps, hkv, d, seed, stale):
    """Pools (Hkv, 1 + B T_w, ps, D) and ring tables (B, T_w): each slot's
    live window pages at column g % T_w on scrambled pages; dead columns
    hold the null page 0, or (``stale``) pages of another slot."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    tw = paging.window_table_width(window, ps)
    n_pages = 1 + b * tw
    perm = list(rng.permutation(np.arange(1, n_pages)))
    bt = np.zeros((b, tw), np.int32)
    for i, n in enumerate(lengths):
        live = paging.live_window_pages(n, window, ps)
        for g in live:
            bt[i, g % tw] = perm.pop()
        if stale:
            cols = {g % tw for g in live}
            for c in range(tw):
                if c not in cols:
                    bt[i, c] = rng.integers(1, n_pages)
    kp = rng.standard_normal((hkv, n_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((hkv, n_pages, ps, d)).astype(np.float32)
    return kp, vp, bt, np.array(lengths, np.int32)


def _case(case, seed=0):
    (_, window, ps, lps, hq, hkv, d, lengths, chunk, softcap,
     stale) = case
    kp, vp, bt, ln = _ring(lengths, window, ps, hkv, d, seed, stale)
    q = np.random.default_rng(seed + 7).standard_normal(
        (len(lengths), hq, d)).astype(np.float32)
    return q, kp, vp, bt, ln, dict(window=window, softcap=softcap), lps, chunk


def _logical(kp, vp, table, lps):
    kp_, bt = pg.repage(torch.from_numpy(kp), torch.from_numpy(table), lps)
    vp_, _ = pg.repage(torch.from_numpy(vp), torch.from_numpy(table), lps)
    return kp_.numpy(), vp_.numpy(), bt.to(torch.int32).numpy()


def _normalized(res):
    acc, _, l = (np.asarray(x) for x in res)
    return acc / np.where(l == 0.0, 1.0, l)[..., None]


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_window_plain_chunked_matches_reference_kernel(case):
    """window_paged_decode_attention_ref(chunk=c) against repro's window
    kernel under target("generic"), at the logical page: the normalized
    outputs and m within the op's tol."""
    q, kp, vp, bt, ln, kw, lps, chunk = _case(case)
    with ctx.target("generic"):
        want = jpaged.window_paged_decode_attention_fwd(
            *(jnp.asarray(a) for a in (q, kp, vp, bt, ln)), page_size=lps,
            **kw)
    lkp, lvp, lbt = _logical(kp, vp, bt, lps)
    got = dec_ref.window_paged_decode_attention_ref(
        *_t(q, lkp, lvp, lbt, ln), chunk=chunk, return_residuals=True, **kw)
    np.testing.assert_allclose(_normalized(got), _normalized(want),
                               **dec_ops.TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               **dec_ops.TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_window_plain_chunked_matches_reference_per_chunk(case):
    """The chunks count from the walk's start, not from token 0: the
    model against repro's dense reference run on each chunk's rows of the
    walk (``kv_offset`` the chunk's first token, start + j c) and merged
    by repro's combine_partials, under target("generic"), within the op's
    tol."""
    q, kp, vp, bt, ln, kw, lps, chunk = _case(case, seed=1)
    kp, vp, bt = _logical(kp, vp, bt, lps)
    walk, start = pg.ring_walk(torch.from_numpy(bt), torch.from_numpy(ln),
                               kw["window"], lps)
    kd = dec_ref.gather_pages(torch.from_numpy(kp), walk).numpy()
    vd = dec_ref.gather_pages(torch.from_numpy(vp), walk).numpy()
    off = start.numpy().astype(np.int32)[:, None, None]
    with ctx.target("generic"):
        parts = [jref.decode_attention_ref(
            jnp.asarray(q), jnp.asarray(kd[:, :, j:j + chunk]),
            jnp.asarray(vd[:, :, j:j + chunk]), jnp.asarray(ln),
            kv_offset=jnp.asarray(off + j), return_residuals=True, **kw)
            for j in range(0, kd.shape[2], chunk)]
        want = jref.combine_partials(*(list(x) for x in zip(*parts)))
    got = dec_ref.window_paged_decode_attention_ref(
        *_t(q, kp, vp, bt, ln), chunk=chunk, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **dec_ops.TOL)


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", CASES[:2] + CASES[4:5],
                         ids=_ids(CASES[:2] + CASES[4:5]))
def test_quant_window_plain_chunked_matches_reference_kernel(case, kv_dtype):
    """quant_window_paged_decode_attention_ref(chunk=c) against repro's
    quantized window kernel under target("generic") on the same
    quantized bytes and scales, within the op's tol."""
    from repro.quant import spec_for_storage
    q, kp, vp, bt, ln, kw, lps, chunk = _case(case, seed=2)
    s = spec_for_storage({"int8": jnp.int8,
                          "fp8_e4m3": jnp.float8_e4m3fn}[kv_dtype])
    kq, ks = s.quantize_pages(jnp.asarray(kp))
    vq, vs = s.quantize_pages(jnp.asarray(vp))
    with ctx.target("generic"):
        want = jquant.quant_window_paged_decode_attention_fwd(
            jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(bt), jnp.asarray(ln),
            page_size=lps, **kw)

    def torch_of(x):
        a = np.asarray(x)
        if a.dtype == jnp.float8_e4m3fn:
            return torch.from_numpy(a.view(np.uint8).copy()).view(
                torch.float8_e4m3fn)
        return torch.from_numpy(np.array(a))

    kq_t, vq_t, ks_t, vs_t = map(torch_of, (kq, vq, ks, vs))
    kq_l, bt_l = pg.repage(kq_t, torch.from_numpy(bt), lps)
    vq_l, _ = pg.repage(vq_t, torch.from_numpy(bt), lps)
    ps = kp.shape[2]
    got = dec_ref.quant_window_paged_decode_attention_ref(
        torch.from_numpy(q), kq_l, vq_l, pg.repage_scales(ks_t, lps, ps),
        pg.repage_scales(vs_t, lps, ps), bt_l.to(torch.int32),
        torch.from_numpy(ln), chunk=chunk, return_residuals=True, **kw)
    np.testing.assert_allclose(_normalized(got), _normalized(want),
                               **dec_ops.TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_window_chunked_m_is_unchunked_m(case):
    """The chunked window plain version against the unchunked one: m bit
    for bit, acc and l within the op's f32 tol; an empty slot stays acc
    0, m NEG_INF, l 0."""
    q, kp, vp, bt, ln, kw, lps, chunk = _case(case, seed=3)
    kp, vp, bt = _logical(kp, vp, bt, lps)
    args = _t(q, kp, vp, bt, ln)
    want = dec_ref.window_paged_decode_attention_ref(
        *args, return_residuals=True, **kw)
    acc, m, l = dec_ref.window_paged_decode_attention_ref(
        *args, chunk=chunk, return_residuals=True, **kw)
    assert torch.equal(m, want[1])
    torch.testing.assert_close(acc, want[0], **dec_ops.TOL)
    torch.testing.assert_close(l, want[2], **dec_ops.TOL)
    for i, n in enumerate(ln):
        if n == 0:
            assert not acc[i].any() and not l[i].any()
            assert (m[i] == NEG_INF).all()


@pytest.mark.parametrize("case", CASES, ids=_ids(CASES))
def test_window_chunk_past_the_reach_is_unchunked(case):
    """A chunk at least the walk's reach (T_w x page) is one split: its
    residuals equal the unchunked ones bit for bit."""
    q, kp, vp, bt, ln, kw, lps, _ = _case(case, seed=4)
    kp, vp, bt = _logical(kp, vp, bt, lps)
    args = _t(q, kp, vp, bt, ln)
    want = dec_ref.window_paged_decode_attention_ref(
        *args, return_residuals=True, **kw)
    reach = bt.shape[1] * lps
    for chunk in (reach, reach + lps):
        got = dec_ref.window_paged_decode_attention_ref(
            *args, chunk=chunk, return_residuals=True, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("name,window,page,logical,splits,chunk", [
    ("gemma2-2b local (window 4096, pages of 64)", 4096, 64, 64, 17, 256),
    ("gemma2-2b local, logical pages of 16", 4096, 64, 16, 17, 256),
    ("the smoke window (16, pages of 4)", 16, 4, 4, 1, 20),
    ("a window of a page", 64, 64, 64, 1, 128),
    ("a window of 300 in pages of 32", 300, 32, 32, 2, 192),
    ("a ring past MAX_SPLITS chunks", 1 << 15, 64, 64, 57, 576),
])
def test_split_plan_on_ring_widths(name, window, page, logical, splits,
                                   chunk):
    """split_plan on a ring walk's width, T_w = (window - 1) // ps + 2
    physical pages: chunks of whole logical pages, at most MAX_SPLITS,
    from the width alone; scratch only for several."""
    tw = paging.window_table_width(window, page) * (page // logical)
    q = torch.zeros(2, 8, 64)
    walk = torch.zeros(2, tw, dtype=torch.int32)
    got, scratch = pg.split_plan("window", q, 4, walk, logical, None)
    reach = tw * logical
    n = -(-reach // got)
    assert (n, got) == (splits, chunk)
    assert got % logical == 0 and n <= dk.MAX_SPLITS
    assert (scratch[0] is None) == (n == 1)
    if n > 1:
        assert scratch[0].shape == (n, 2, 8, 64)
        assert scratch[1].shape == scratch[2].shape == (n, 2, 8)


def _launch_args(monkeypatch):
    launches = []
    monkeypatch.setattr(pg, "check_cuda", lambda *a: None)
    monkeypatch.setattr(pg, "stream_of", lambda t: None)
    for kern in (pg.WINDOW_KERNEL, pg.QUANT_WINDOW_KERNEL):
        monkeypatch.setattr(kern, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(dk, "_COUNTERS", {})
    return launches


def _gemma2_operands(n):
    """gemma2-2b's local-layer shapes: 8 slots, 8/4 heads of 256, ring
    tables of 65 pages of 64, every slot at length ``n``."""
    tw = paging.window_table_width(4096, 64)
    q = torch.zeros(8, 8, 256, dtype=torch.bfloat16)
    pool = torch.zeros(4, 1 + 8 * tw, 64, 256, dtype=torch.bfloat16)
    table = torch.arange(1, 1 + 8 * tw, dtype=torch.int32).reshape(8, tw)
    return q, pool, table, torch.full((8,), n, dtype=torch.int32)


def test_window_launcher_picks_its_split_without_reading_lengths(
        monkeypatch):
    """The window launchers' chunk comes from the ring's width alone:
    calls whose lengths differ (empty, inside the window, wrapped) launch
    with the same chunk, 17 splits of 256 rows at gemma2's shapes,
    scratch only for several splits, one launch a call."""
    assert "lengths" not in inspect.signature(pg.split_plan).parameters
    launches = _launch_args(monkeypatch)
    kw = dict(window=4096, softcap=50.0, scale=None, page_size=None,
              block_kv=64)
    for n in (0, 1000, 8192):
        q, pool, table, ln = _gemma2_operands(n)
        for splits in (None, 1):
            pg.window_paged_decode_attention_fwd(q, pool, pool, table, ln,
                                                 splits=splits, **kw)
        qpool = torch.zeros(pool.shape, dtype=torch.int8)
        sc = torch.ones(4, pool.shape[1])
        pg.window_paged_decode_attention_fwd(
            q, qpool, qpool, table, ln, k_scales=sc, v_scales=sc, **kw)
    assert len(launches) == 9
    # (q, kp, vp, ks, vs, ring tables, lengths, acc, m, l, parts x 4, b,
    #  hq, hkv, n_pages, page_size, t_cols, d, bk, chunk, ...)
    assert [a[22] for a in launches] == [256, 4160, 256] * 3
    assert all(a[18] == 64 and a[19] == 65 for a in launches)
    for a in launches:
        assert all((p is None) == (a[22] == 4160) for p in a[10:14])


@pytest.mark.parametrize("splits", [0, -1, dk.MAX_SPLITS + 1])
def test_window_launchers_refuse_splits_outside_the_range(splits):
    """Both window launchers refuse a split count outside [1,
    MAX_SPLITS] on CPU tensors, before any launch."""
    q, pool, table, ln = _gemma2_operands(100)
    kw = dict(window=4096, softcap=None, scale=None, page_size=None,
              block_kv=64, splits=splits)
    with pytest.raises(ValueError, match="splits"):
        pg.window_paged_decode_attention_fwd(q, pool, pool, table, ln, **kw)
    qpool = torch.zeros(pool.shape, dtype=torch.int8)
    sc = torch.ones(4, pool.shape[1])
    with pytest.raises(ValueError, match="splits"):
        pg.window_paged_decode_attention_fwd(q, qpool, qpool, table, ln,
                                             k_scales=sc, v_scales=sc, **kw)
    assert pg.WINDOW_KERNEL.launches == 0
    assert pg.QUANT_WINDOW_KERNEL.launches == 0


def test_splits_is_a_schedule_choice_on_the_cpu():
    """On the CPU the window ops take the plain version whatever
    ``splits`` asks."""
    q, kp, vp, bt, ln, kw, _, _ = _case(CASES[0], seed=5)
    args = _t(q, kp, vp, bt, ln)
    base = dec_ops.window_paged_decode_attention(*args, **kw)
    for splits in (1, 3):
        assert torch.equal(dec_ops.window_paged_decode_attention(
            *args, splits=splits, **kw), base)
    kq = torch.from_numpy(kp).clamp(-1, 1).mul(127).to(torch.int8)
    sc = torch.full(kq.shape[:2], 1 / 127)
    qbase = dec_ops.quant_window_paged_decode_attention(
        args[0], kq, kq, sc, sc, args[3], args[4], **kw)
    assert torch.equal(dec_ops.quant_window_paged_decode_attention(
        args[0], kq, kq, sc, sc, args[3], args[4], splits=2, **kw), qbase)
