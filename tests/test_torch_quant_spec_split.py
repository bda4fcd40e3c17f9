"""B5's and B6's split-KV paged decode on the CPU: their rounding models
and their rule.

B5 (``csrc/quant_paged_decode_attention.cu``, int8/fp8 pools) and B6
(``csrc/spec_paged_decode_attention.cu``, K1 query positions a slot,
each row with its own causal horizon, over bf16 pools or int8/fp8 ones)
run B4's split-KV kernel: each slot's block-table row is cut into chunks
of whole logical pages whose partials are merged in chunk order.
``quant_paged_decode_attention_ref(chunk=c)``,
``spec_paged_decode_attention_ref(chunk=c)`` and
``quant_spec_paged_decode_attention_ref(chunk=c)`` are their plain
versions.  Here they are held to ``repro``: its reference run on each
chunk's columns of the table (the lengths shifted back by the chunk's
first row, which keeps every query-to-key distance) and merged by its
``combine_partials``, under ``target("generic")``; and to the port's
unsplit plain versions (m exactly: a max has no order).  The tables are
scrambled, with null-page tails, an empty slot, windows across chunk
edges, a softcap, and logical pages of 16 carved from pages of 64
(``paged.repage``); the speculative cases put a chunk edge between two
rows' horizons, so that some row sees nothing in the last live split.
The launchers are shown to pick their chunk from the table's reach,
without reading ``lengths``.  The kernels themselves run only on the
card (tests/test_torch_gpu.py).
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
from repro_torch.kernels.decode_attention import quant as qk
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.decode_attention import spec as sk

NEG_INF = dec_ref.NEG_INF
_STORAGE = {"int8": torch.int8, "fp8_e4m3": torch.float8_e4m3fn,
            "bf16": torch.bfloat16}

# B5: (name, B, Hq, Hkv, T columns, page, logical page, D, lengths,
#  chunk, window, softcap)
QUANT_CASES = [
    ("group 4, an empty slot, null tails", 3, 8, 2, 6, 16, 16, 32,
     (0, 1, 96), 32, None, None),
    ("window across a chunk edge", 3, 8, 2, 6, 16, 16, 32, (40, 70, 96), 32,
     20, None),
    ("group 8, softcap", 2, 16, 2, 4, 16, 16, 16, (15, 64), 16, None, 30.0),
    ("logical pages of 16 in pages of 64", 3, 8, 2, 2, 64, 16, 32,
     (0, 70, 128), 48, None, None),
    ("logical 16 of 64, window and softcap", 2, 8, 2, 3, 64, 16, 16,
     (150, 192), 32, 40, 30.0),
]

# B6: (name, B, K1, Hq, Hkv, T columns, page, logical page, D,
#  pre-speculation prefixes, chunk, window, softcap)
SPEC_CASES = [
    ("K1 5, group 4, a chunk edge between horizons", 3, 5, 8, 2, 6, 16, 16,
     32, (0, 30, 60), 32, None, None),
    ("K1 3, group 8, window across a chunk edge", 3, 3, 16, 2, 6, 16, 16,
     16, (10, 40, 90), 32, 20, None),
    ("K1 1, group 8, softcap", 2, 1, 16, 2, 4, 16, 16, 16, (15, 63), 16,
     None, 30.0),
    ("logical 16 of 64, K1 5, window and softcap", 2, 5, 8, 2, 3, 64, 16,
     16, (120, 180), 32, 40, 30.0),
    ("horizons past the reach, a slot that sees nothing", 2, 5, 8, 2, 2, 16,
     16, 16, (29, 60), 16, 8, None),
]


def _table(rng, b, t, ps, needed):
    """A scrambled (B, T) table whose columns past each slot's
    ``needed`` tokens are the null page 0."""
    table = (rng.permutation(b * t).reshape(b, t) + 1).astype(np.int32)
    for i, n in enumerate(needed):
        table[i, -(-n // ps):] = 0
    return table


def _pools(rng, hkv, n_pages, ps, d, kv):
    """K and V pools (Hkv, P, ps, D) in the storage of ``kv`` and their
    (Hkv, P) f32 scales (None for bf16), values near unit size."""
    pools = []
    for _ in range(2):
        if kv == "int8":
            x = torch.from_numpy(rng.integers(
                -127, 128, (hkv, n_pages, ps, d)).astype(np.int8))
            sc = rng.uniform(0.5, 1.5, (hkv, n_pages)) / 64
        else:
            x = torch.from_numpy(rng.standard_normal(
                (hkv, n_pages, ps, d)).astype(np.float32)).to(_STORAGE[kv])
            sc = rng.uniform(0.5, 1.5, (hkv, n_pages))
        pools.append((x, None if kv == "bf16" else
                      torch.from_numpy(sc.astype(np.float32))))
    (kp, ks), (vp, vs) = pools
    return kp, vp, ks, vs


def _logical(kp, vp, ks, vs, table, logical):
    """The pools, scales and table re-viewed at a smaller logical page."""
    ps = kp.shape[2]
    kp, bt = pg.repage(kp, table, logical)
    vp, _ = pg.repage(vp, table, logical)
    if ks is not None:
        ks, vs = (pg.repage_scales(s, logical, ps) for s in (ks, vs))
    return kp, vp, ks, vs, bt.to(torch.int32)


def _jax(t):
    """A CPU tensor as a JAX array of the same values and storage (fp8
    through its bytes, bf16 exactly)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(t.view(torch.uint8).numpy().view(
            jnp.float8_e4m3fn))
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _quant_case(case, kv, seed):
    (_, b, hq, hkv, t, ps, lps, d, lengths, chunk, window,
     softcap) = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((b, hq, d)).astype(np.float32))
    kp, vp, ks, vs = _pools(rng, hkv, 1 + b * t, ps, d, kv)
    table = torch.from_numpy(_table(rng, b, t, ps, lengths))
    ln = torch.tensor(lengths, dtype=torch.int32)
    return q, kp, vp, ks, vs, table, ln, lps, chunk, dict(
        window=window, softcap=softcap)


def _spec_case(case, kv, seed):
    (_, b, k1, hq, hkv, t, ps, lps, d, bases, chunk, window,
     softcap) = case
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal(
        (b, k1, hq, d)).astype(np.float32))
    if kv == "bf16":
        q = q.bfloat16()
    kp, vp, ks, vs = _pools(rng, hkv, 1 + b * t, ps, d, kv)
    table = torch.from_numpy(_table(rng, b, t, ps, [n + k1 for n in bases]))
    ln = torch.tensor(bases, dtype=torch.int32)
    return q, kp, vp, ks, vs, table, ln, lps, chunk, dict(
        window=window, softcap=softcap)


def _port(args, chunk=None, **kw):
    """The port's plain version of B5 (q (B, Hq, D)) or B6 (q (B, K1,
    Hq, D)), quantized where there are scales."""
    q, kp, vp, ks, vs, table, ln = args
    if q.dim() == 3:
        return dec_ref.quant_paged_decode_attention_ref(
            q, kp, vp, ks, vs, table, ln, chunk=chunk, **kw)
    if ks is None:
        return dec_ref.spec_paged_decode_attention_ref(
            q, kp, vp, table, ln, chunk=chunk, **kw)
    return dec_ref.quant_spec_paged_decode_attention_ref(
        q, kp, vp, ks, vs, table, ln, chunk=chunk, **kw)


def _reference_by_chunk(args, lps, chunk, **kw):
    """repro's plain version of each chunk's table columns (lengths
    shifted back by the chunk's first row), merged by repro's
    combine_partials, under target("generic")."""
    q, kp, vp, ks, vs, table, ln = args
    cols = chunk // lps
    with ctx.target("generic"):
        jq, jkp, jvp = map(_jax, (q, kp, vp))
        parts = []
        for c in range(0, table.shape[1], cols):
            jt = jnp.asarray(table[:, c:c + cols].numpy())
            jl = jnp.asarray(ln.numpy() - np.int32(c * lps))
            if q.dim() == 3:
                res = jref.quant_paged_decode_attention_ref(
                    jq, jkp, jvp, _jax(ks), _jax(vs), jt, jl,
                    return_residuals=True, **kw)
            elif ks is None:
                res = jref.spec_paged_decode_attention_ref(
                    jq, jkp, jvp, jt, jl, return_residuals=True, **kw)
            else:
                res = jref.quant_spec_paged_decode_attention_ref(
                    jq, jkp, jvp, _jax(ks), _jax(vs), jt, jl,
                    return_residuals=True, **kw)
            parts.append(res)
        want = jref.combine_partials(*(list(x) for x in zip(*parts)))
    return np.asarray(want.astype(jnp.float32))


def _check_reference(make, case, kv):
    q, kp, vp, ks, vs, table, ln, lps, chunk, kw = make(case, kv, seed=0)
    kp, vp, ks, vs, table = _logical(kp, vp, ks, vs, table, lps)
    args = (q, kp, vp, ks, vs, table, ln)
    want = _reference_by_chunk(args, lps, chunk, **kw)
    acc, _, l = _port(args, chunk=chunk, return_residuals=True, **kw)
    got = dec_ref.normalize(acc, l, torch.float32)   # as repro's merge
    np.testing.assert_allclose(got.numpy(), want, **dec_ops.TOL)


def _check_unsplit(make, case, kv):
    """The chunked plain version at the logical page against the unsplit
    one at the pool's: m bit for bit, acc and l within the op's f32 tol;
    a row that sees nothing stays acc 0, m NEG_INF, l 0."""
    q, kp, vp, ks, vs, table, ln, lps, chunk, kw = make(case, kv, seed=1)
    want = _port((q, kp, vp, ks, vs, table, ln), return_residuals=True, **kw)
    lkp, lvp, lks, lvs, ltable = _logical(kp, vp, ks, vs, table, lps)
    acc, m, l = _port((q, lkp, lvp, lks, lvs, ltable, ln), chunk=chunk,
                      return_residuals=True, **kw)
    assert torch.equal(m, want[1])
    torch.testing.assert_close(acc, want[0], **dec_ops.TOL)
    torch.testing.assert_close(l, want[2], **dec_ops.TOL)
    empty = m == NEG_INF
    assert not acc[empty].any() and not l[empty].any()
    return empty


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", QUANT_CASES, ids=[c[0] for c in QUANT_CASES])
def test_split_quant_plain_matches_reference_per_chunk(case, kv):
    """quant_paged_decode_attention_ref(chunk=c) against repro's on each
    chunk's table columns, merged by repro's combine_partials."""
    _check_reference(_quant_case, case, kv)


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", QUANT_CASES, ids=[c[0] for c in QUANT_CASES])
def test_split_quant_plain_matches_unsplit(case, kv):
    empty = _check_unsplit(_quant_case, case, kv)
    for i, n in enumerate(case[8]):
        assert bool(empty[i].all()) == (n == 0)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_split_spec_plain_matches_reference_per_chunk(case, kv):
    """spec_paged_decode_attention_ref(chunk=c) (and its quantized mode)
    against repro's on each chunk's table columns, merged by repro's
    combine_partials: every row masked at its own horizon in every
    chunk."""
    _check_reference(_spec_case, case, kv)


@pytest.mark.parametrize("kv", ["bf16", "int8", "fp8_e4m3"])
@pytest.mark.parametrize("case", SPEC_CASES, ids=[c[0] for c in SPEC_CASES])
def test_split_spec_plain_matches_unsplit(case, kv):
    _check_unsplit(_spec_case, case, kv)


def test_spec_rows_see_nothing_in_the_last_live_split():
    """The chunk edge at 32 falls between the horizons of slot 1's rows
    (31..35): the rows of its first two positions see no token of the
    last live chunk, whose partial is then m NEG_INF, l 0, and weighs 0
    in the merge.  The slot whose prefix is past the reach with a window
    of 8 sees nothing at all."""
    case = SPEC_CASES[0]
    q, kp, vp, _, _, table, ln, _, chunk, kw = _spec_case(case, "bf16", 0)
    assert chunk == 32 and case[6] == 16   # the last live chunk: columns 2-3
    _, m_last, l_last = dec_ref.spec_paged_decode_attention_ref(
        q, kp, vp, table[:, 2:4], ln - 32, return_residuals=True, **kw)
    group = case[3] // case[4]
    assert (m_last[1, :2] == NEG_INF).all() and not l_last[1, :2].any()
    assert (m_last[1, 2:] > NEG_INF).all()
    rows = sk.spec_row_lengths(ln, case[2], group)
    assert rows[1].tolist() == [31] * group + [32] * group + [33] * group + \
        [34] * group + [35] * group
    case = SPEC_CASES[4]
    q, kp, vp, ks, vs, table, ln, _, chunk, kw = _spec_case(case, "bf16", 0)
    acc, m, l = _port((q, kp, vp, ks, vs, table, ln), chunk=chunk,
                      return_residuals=True, **kw)
    assert (m[1] == NEG_INF).all() and not acc[1].any() and not l[1].any()
    assert (m[0] > NEG_INF).all()


def _recording(monkeypatch, mod):
    launches = []
    monkeypatch.setattr(mod, "check_cuda", lambda *a: None)
    monkeypatch.setattr(mod, "stream_of", lambda t: None)
    monkeypatch.setattr(mod.KERNEL, "launch", lambda *a: launches.append(a))
    monkeypatch.setattr(dk, "_COUNTERS", {})
    return launches


def _served_operands(kv, k1=None):
    """granite-8b's decode shapes: 8 slots, 32/8 heads of 128, tables of
    16 pages of 64 (1,024 rows)."""
    q = torch.zeros((8, 32, 128) if k1 is None else (8, k1, 32, 128),
                    dtype=torch.bfloat16)
    pool = torch.zeros(8, 1 + 8 * 16, 64, 128, dtype=_STORAGE[kv])
    sc = None if kv == "bf16" else torch.ones(8, 1 + 8 * 16)
    table = torch.arange(1, 1 + 8 * 16, dtype=torch.int32).reshape(8, 16)
    return q, pool, sc, table


@pytest.mark.parametrize("kv", ["int8", "fp8_e4m3"])
def test_quant_launcher_picks_its_split_without_reading_lengths(monkeypatch,
                                                                kv):
    """B5's chunk comes from the table's reach alone: calls whose
    lengths differ (all empty, all full) launch with the same chunk, B4's
    rule (chunks of PAGED_SPLIT_ROWS rows), scratch only for several
    splits, one launch a call."""
    assert "lengths" not in inspect.signature(pg.split_plan).parameters
    launches = _recording(monkeypatch, qk)
    q, pool, sc, table = _served_operands(kv)
    for n in (0, 1024):
        ln = torch.full((8,), n, dtype=torch.int32)
        for splits in (None, 1, 8):
            qk.quant_paged_decode_attention_fwd(
                q, pool, pool, sc, sc, table, ln, window=None, softcap=None,
                scale=None, page_size=None, block_kv=64, splits=splits)
    assert len(launches) == 6
    # (q, kp, vp, ks, vs, bt, lengths, acc, m, l, scratch x 4, b, hq, hkv,
    #  n_pages, page_size, t_cols, d, dv, bk, chunk, ...)
    served = dk.split_chunk(1024, dk.paged_splits(1024, 64), 64)
    assert served == dk.PAGED_SPLIT_ROWS
    assert [a[21] for a in launches] == [128] * 6          # dv = d
    assert [a[23] for a in launches] == [served, 1024, 128] * 2
    assert all(p is not None for p in launches[0][10:14])
    assert all(p is None for p in launches[1][10:14])
    assert dk._COUNTERS[q.device].numel() >= 8 * 8
    with pytest.raises(ValueError, match="splits"):
        qk.quant_paged_decode_attention_fwd(
            q, pool, pool, sc, sc, table, ln, window=None, softcap=None,
            scale=None, page_size=None, block_kv=64, splits=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_spec_launcher_picks_its_split_without_reading_lengths(monkeypatch,
                                                               kv):
    """B6's chunk the same way, its scratch holding every stacked row:
    (n, B, K1, Hq, D) and (n, B, K1, Hq)."""
    launches = _recording(monkeypatch, sk)
    q, pool, sc, table = _served_operands(kv, k1=5)
    for n in (0, 1019):
        ln = torch.full((8,), n, dtype=torch.int32)
        for splits in (None, 1):
            sk.spec_paged_decode_attention_fwd(
                q, pool, pool, table, ln, window=None, softcap=None,
                scale=None, page_size=None, block_kv=64, k_scales=sc,
                v_scales=sc, splits=splits)
    # (q, kp, vp, ks, vs, bt, row_len, acc, m, l, scratch x 4, b, k1, hq,
    #  hkv, n_pages, page_size, t_cols, d, dv, bk, chunk, ...)
    assert [a[22] for a in launches] == [128] * 4          # dv = d
    assert [a[24] for a in launches] == [dk.PAGED_SPLIT_ROWS, 1024] * 2
    assert all(p is not None for p in launches[0][10:14])
    assert all(p is None for p in launches[1][10:14])
    chunk, scratch = pg.split_plan("spec", q, 8, table, 64, None)
    assert chunk == dk.PAGED_SPLIT_ROWS
    assert [tuple(t.shape) for t in scratch[:3]] == [
        (4, 8, 5, 32, 128), (4, 8, 5, 32), (4, 8, 5, 32)]


def test_splits_is_a_schedule_choice_on_the_cpu():
    """On the CPU the quantized and speculative ops take their plain
    versions whatever ``splits`` asks."""
    q, kp, vp, ks, vs, table, ln, _, _, kw = _quant_case(
        QUANT_CASES[1], "int8", 2)
    base = dec_ops.quant_paged_decode_attention(q, kp, vp, ks, vs, table, ln,
                                                **kw)
    for splits in (1, 3):
        assert torch.equal(dec_ops.quant_paged_decode_attention(
            q, kp, vp, ks, vs, table, ln, splits=splits, **kw), base)
    q, kp, vp, ks, vs, table, ln, _, _, kw = _spec_case(
        SPEC_CASES[0], "int8", 2)
    quant = dec_ops.quant_spec_paged_decode_attention(
        q, kp, vp, ks, vs, table, ln, **kw)
    plain = dec_ops.spec_paged_decode_attention(q, kp.float(), vp.float(),
                                                table, ln, **kw)
    for splits in (1, 3):
        assert torch.equal(dec_ops.quant_spec_paged_decode_attention(
            q, kp, vp, ks, vs, table, ln, splits=splits, **kw), quant)
        assert torch.equal(dec_ops.spec_paged_decode_attention(
            q, kp.float(), vp.float(), table, ln, splits=splits, **kw),
            plain)
