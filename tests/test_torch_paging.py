"""The port's paged KV plane (``repro_torch.serve.paging``) mirrored on
tests/test_paging.py: the strict allocator, block-table audit, the
prefill scatter into pages and the fused page write + attend, the last
two held against ``repro.serve.paging`` and ``repro.sharding`` on the
same inputs."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import context as ctx
from repro.serve import paging as jpaging
from repro.sharding.kernel_sharding import sharded_paged_decode_update_attend
from repro_torch.serve import paging
from repro_torch.sharding.kernel_sharding import (decode_update_attend,
                                                  paged_decode_update_attend)


def _np_rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------ allocator ----

def test_allocator_alloc_free_reuse():
    a = paging.PageAllocator(6)
    assert a.available == 5 and a.usable == 5
    got = a.alloc_many(3)
    assert len(set(got)) == 3 and paging.NULL_PAGE not in got
    a.free(got)
    assert a.available == 5
    assert a.alloc() == got[-1]                 # LIFO reuse


def test_allocator_needs_two_pages():
    with pytest.raises(ValueError, match="at least 2"):
        paging.PageAllocator(1)


def test_allocator_never_hands_out_or_frees_null_page():
    a = paging.PageAllocator(4)
    assert paging.NULL_PAGE not in a.alloc_many(3)
    with pytest.raises(ValueError, match="null page"):
        a.free([paging.NULL_PAGE])
    assert a.available == 0


def test_allocator_exhaustion_raises():
    a = paging.PageAllocator(3)
    a.alloc_many(2)
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc()
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc_many(1)


def test_allocator_rejects_double_free_atomically():
    a = paging.PageAllocator(6)
    pages = a.alloc_many(3)
    a.free(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free(pages[:1])
    with pytest.raises(ValueError, match="double free"):
        a.free([pages[1], pages[0]])
    assert a.available == 3
    a.free(pages[1:])
    assert a.available == 5


def test_allocator_rejects_duplicate_within_one_batch():
    a = paging.PageAllocator(6)
    p = a.alloc_many(3)[0]
    before = a.available
    with pytest.raises(ValueError, match="double free"):
        a.free([p, p])
    assert a.available == before
    a.free([p])
    assert a.alloc() == p


def test_allocator_never_allocated_free_rejected():
    a = paging.PageAllocator(8)
    a.alloc()
    with pytest.raises(ValueError, match="double free"):
        a.free([5])


def test_alloc_many_partial_exhaustion_rolls_back():
    a = paging.PageAllocator(5)
    got = a.alloc_many(2)
    before = a.available
    with pytest.raises(RuntimeError, match="exhausted"):
        a.alloc_many(3)
    assert a.available == before
    more = a.alloc_many(2)
    assert len(set(got + more)) == 4


def test_allocator_pressure_stats_match_reference_keys():
    a, ja = paging.PageAllocator(6), jpaging.PageAllocator(6)
    for alloc in (a, ja):
        got = alloc.alloc_many(3)
        alloc.free(got[:2])
        alloc.alloc()
    want = ja.pressure()
    assert a.pressure() == want
    assert want["peak_in_use"] == 3 and want["frees"] == 2
    assert want["quarantined"] == 0


def test_allocator_reclaim_filters_null_strict_otherwise():
    a = paging.PageAllocator(8)
    pages = a.alloc_many(3)
    row = np.array(pages + [paging.NULL_PAGE] * 3, np.int32)
    assert a.reclaim(row) == 3
    assert a.available == 7
    with pytest.raises(ValueError, match="double free"):
        a.reclaim(row)
    assert a.reclaim([paging.NULL_PAGE] * 4) == 0


def test_allocator_quarantine_matches_reference():
    """Quarantine takes allocated and free pages out of circulation for
    good, shrinks ``usable``, validates the batch before changing
    anything, and leaves both allocators in the same state."""
    a, ja = paging.PageAllocator(8), jpaging.PageAllocator(8)
    for alloc in (a, ja):
        got = alloc.alloc_many(3)
        alloc.quarantine([got[1], 6])           # one allocated, one free
        assert alloc.usable == 5 and alloc.quarantined == 2
        assert alloc.in_use == 2 and alloc.available == 3
        for bad, match in (([got[1]], "already quarantined"),
                           ([7, 7], "already quarantined"),
                           ([paging.NULL_PAGE], "not a real"),
                           ([8], "not a real")):
            with pytest.raises(ValueError, match=match):
                alloc.quarantine(bad)
        assert alloc.quarantined == 2          # unchanged by a refusal
        with pytest.raises(ValueError, match="double free"):
            alloc.free([got[1]])               # no longer allocated
        alloc.free([got[0], got[2]])
        assert alloc.alloc_many(5) and alloc.available == 0
        with pytest.raises(RuntimeError, match="exhausted"):
            alloc.alloc()
    assert a.pressure() == ja.pressure()
    assert a.quarantine_count == ja.quarantine_count == 2
    assert sorted(a._quarantined) == sorted(ja._quarantined)


@pytest.mark.parametrize("cache_len,ps", [(32, 8), (33, 8), (12, 4), (5, 64)])
def test_pages_per_slot_matches_reference(cache_len, ps):
    assert paging.pages_per_slot(cache_len, ps) == \
        jpaging.pages_per_slot(cache_len, ps)


# ---------------------------------------------------------------- audit ----

def _audit_fixture(slots=2, pages_per_slot=3, page_size=4):
    a = paging.PageAllocator(1 + slots * pages_per_slot)
    bt = np.full((slots, pages_per_slot), paging.NULL_PAGE, np.int32)
    return a, bt, np.zeros((slots,), np.int64), np.zeros((slots,), bool), \
        page_size


def test_audit_clean_state_and_live_prefix():
    a, bt, lengths, active, ps = _audit_fixture()
    assert paging.audit(a, bt, lengths, active, ps) == []
    bt[0, :2] = a.alloc_many(2)
    lengths[0], active[0] = 6, True
    assert paging.audit(a, bt, lengths, active, ps) == []


def test_audit_flags_null_in_live_prefix():
    a, bt, lengths, active, ps = _audit_fixture()
    bt[0, 0] = a.alloc()
    lengths[0], active[0] = 6, True
    errs = paging.audit(a, bt, lengths, active, ps)
    assert any("NULL_PAGE inside the live prefix" in e for e in errs)


def test_audit_flags_leak_past_prefix_and_inactive_rows():
    a, bt, lengths, active, ps = _audit_fixture()
    bt[0, 0] = a.alloc()
    lengths[0], active[0] = 2, True
    bt[0, 2] = a.alloc()
    assert any("past the live prefix" in e
               for e in paging.audit(a, bt, lengths, active, ps))
    bt[1, 0], bt[0, 2] = bt[0, 2], paging.NULL_PAGE
    assert any("past the live prefix" in e
               for e in paging.audit(a, bt, lengths, active, ps))


def test_audit_flags_double_lease_and_in_use_mismatch():
    a, bt, lengths, active, ps = _audit_fixture()
    p = a.alloc()
    bt[0, 0] = bt[1, 0] = p
    lengths[:] = 2
    active[:] = True
    errs = paging.audit(a, bt, lengths, active, ps)
    assert any("leased to both" in e for e in errs)
    assert any("in_use" in e for e in errs)


def test_audit_flags_free_list_corruption():
    a, bt, lengths, active, ps = _audit_fixture()
    page = a.alloc()
    a._free.append(page)
    errs = paging.audit(a, bt, lengths, active, ps)
    assert any("both free and allocated" in e for e in errs)
    a._free.append(page)
    assert any("duplicate" in e
               for e in paging.audit(a, bt, lengths, active, ps))


def test_audit_agrees_with_reference_on_the_same_state():
    """Both audits see the same corrupted state; the port reports the
    same findings as the reference (quarantine aside)."""
    a, bt, lengths, active, ps = _audit_fixture()
    ja = jpaging.PageAllocator(a.total_pages)
    for alloc in (a, ja):
        alloc.alloc_many(3)
    bt[0, :2] = [1, 2]
    bt[1, 0] = 2                                  # double lease
    lengths[:] = [5, 3]
    active[:] = True
    assert paging.audit(a, bt, lengths, active, ps) == \
        jpaging.audit(ja, bt, lengths, active, ps)


@pytest.mark.parametrize("fault", ["clean", "free and quarantined",
                                   "allocated and quarantined",
                                   "live page quarantined", "vanished"])
def test_audit_three_way_partition_agrees_with_reference(fault):
    """free, allocated and quarantined partition the non-null pages: each
    way of breaking that (and a clean quarantine) is reported as the
    reference reports it, message for message."""
    a, bt, lengths, active, ps = _audit_fixture()
    ja = jpaging.PageAllocator(a.total_pages)
    for alloc in (a, ja):
        got = alloc.alloc_many(3)
        alloc.quarantine([got[2]])
        if fault == "free and quarantined":
            alloc._free.append(got[2])
        elif fault == "allocated and quarantined":
            alloc._allocated.add(got[2])
        elif fault == "vanished":
            alloc._allocated.discard(got[1])
    bt[0, :2] = got[:2]
    if fault == "live page quarantined":
        bt[1, 0] = got[2]
    lengths[:] = [5, 3]
    active[:] = [True, fault == "live page quarantined"]
    errs = paging.audit(a, bt, lengths, active, ps)
    assert errs == jpaging.audit(ja, bt, lengths, active, ps)
    assert (errs == []) == (fault == "clean")
    if fault == "live page quarantined":
        assert any("(in quarantine)" in e for e in errs)
    if fault == "vanished":
        assert any("vanished" in e and "quarantined" in e for e in errs)


# ---------------------------------------------------------- page scatter ----

def test_scatter_prefill_matches_reference_and_dense():
    """A batch-2 prefill lands in scrambled pages (one NULL tail) exactly
    where the reference puts it; the dense path writes slot rows."""
    layers, b, h, s, d, ps, t = 2, 2, 2, 10, 8, 4, 3
    total = 1 + b * t
    rows = np.random.default_rng(0).permutation(np.arange(1, total))
    rows = rows.reshape(b, t).astype(np.int32)
    rows[1, 2] = paging.NULL_PAGE
    leaves = [{"k": _np_rand((b, h, s, d), 2 * i),
               "v": _np_rand((b, h, s, d), 2 * i + 1)} for i in range(layers)]

    pools = paging.init_paged_caches(layers, h, d, total, ps, device="cpu",
                                     dtype=torch.float32)
    paging.scatter_prefill(
        pools, [{n: torch.from_numpy(a) for n, a in c.items()}
                for c in leaves], torch.arange(b), torch.from_numpy(rows))
    jpool = jnp.zeros((layers, h, total, ps, d), jnp.float32)
    one = {n: jnp.stack([c[n] for c in leaves]) for n in ("k", "v")}
    with ctx.target("generic"):
        jc = jpaging.scatter_prefill(
            [({"kp": jpool, "vp": jpool},)], [(one,)], jnp.arange(b),
            jnp.asarray(rows))
    live = sorted(set(rows.ravel()) - {paging.NULL_PAGE})
    for i in range(layers):
        for n in ("kp", "vp"):
            np.testing.assert_array_equal(
                pools[i][n][:, live].numpy(),
                np.asarray(jc[0][0][n][i])[:, live])

    dense = [{"k": torch.zeros(3, h, 16, d), "v": torch.zeros(3, h, 16, d)}
             for _ in range(layers)]
    cache1 = [{n: torch.nn.functional.pad(torch.from_numpy(a),
                                          (0, 0, 0, 6))
               for n, a in c.items()} for c in leaves]
    paging.scatter_prefill(dense, cache1, torch.tensor([2, 0]))
    torch.testing.assert_close(dense[1]["v"][2], cache1[1]["v"][0])
    torch.testing.assert_close(dense[0]["k"][0], cache1[0]["k"][1])
    assert not dense[0]["k"][1].any()


def test_scatter_prefill_rejects_prompt_longer_than_its_pages():
    pools = paging.init_paged_caches(1, 1, 4, 3, 2, device="cpu",
                                     dtype=torch.float32)
    cache1 = [{"k": torch.ones(1, 1, 5, 4), "v": torch.ones(1, 1, 5, 4)}]
    with pytest.raises(ValueError, match="exceeds"):
        paging.scatter_prefill(pools, cache1, torch.arange(1),
                               torch.tensor([[1, 2]], dtype=torch.int32))


# ------------------------------------------------------ write + attend -----

def test_paged_write_then_attend_matches_reference():
    """The port's fused page write + paged decode against
    ``sharded_paged_decode_update_attend`` (no mesh): the same output,
    and the same rows written into the same pages, in place."""
    b, hq, hkv, d, ps, t = 2, 4, 2, 16, 8, 3
    n_pages = 1 + b * t
    q = _np_rand((b, hq, d), 0)
    kp, vp = _np_rand((hkv, n_pages, ps, d), 1), _np_rand((hkv, n_pages, ps, d), 2)
    k_new, v_new = _np_rand((b, hkv, d), 3), _np_rand((b, hkv, d), 4)
    bt = np.random.default_rng(5).permutation(np.arange(1, n_pages))
    bt = bt.reshape(b, t).astype(np.int32)
    lengths = np.array([ps + 3, 2 * ps - 1], np.int32)
    page = bt[np.arange(b), lengths // ps]
    off = (lengths % ps).astype(np.int32)
    with ctx.target("generic"):
        want, jk, jv = sharded_paged_decode_update_attend(
            jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
            jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(bt),
            jnp.asarray(page), jnp.asarray(off), jnp.asarray(lengths + 1),
            page_size=ps)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = paged_decode_update_attend(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, torch.from_numpy(bt), torch.from_numpy(page),
        torch.from_numpy(off), torch.from_numpy(lengths + 1), page_size=ps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_dense_write_then_attend_matches_reference_and_parks_past_end():
    """Dense fused write: row ``write_pos`` takes the new K/V; a slot
    parked at ``cache_len`` (finished) writes nothing, as the
    reference's one-hot select does."""
    from repro.sharding.kernel_sharding import sharded_decode_update_attend
    b, hq, hkv, s, d = 3, 4, 2, 8, 16
    q = _np_rand((b, hq, d), 0)
    kc, vc = _np_rand((b, hkv, s, d), 1), _np_rand((b, hkv, s, d), 2)
    k_new, v_new = _np_rand((b, hkv, d), 3), _np_rand((b, hkv, d), 4)
    pos = np.array([3, 7, 8], np.int32)
    eff = np.minimum(pos + 1, s).astype(np.int32)
    with ctx.target("generic"):
        want, jk, jv = sharded_decode_update_attend(
            *(jnp.asarray(a) for a in (q, k_new, v_new, kc, vc, pos, eff)))
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got = decode_update_attend(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        tk, tv, torch.from_numpy(pos), torch.from_numpy(eff))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[2].numpy(), kc[2])


def test_page_coords_route_freed_and_finished_slots_to_null_page():
    """A freed slot's all-null row and a finished slot parked at the end
    of its table both resolve to the trash page 0."""
    from repro_torch.models.attention import _page_coords
    bt = torch.tensor([[3, 5], [0, 0], [4, 6]], dtype=torch.int32)
    lengths = torch.tensor([5, 2, 8], dtype=torch.int32)
    page, off = _page_coords(bt, lengths, 4)
    assert page.tolist() == [5, 0, 0] and off.tolist() == [1, 2, 0]
    jpage = jnp.take_along_axis(jnp.asarray(bt.numpy()[:2]),
                                jnp.asarray([[1], [0]]), axis=1)[:, 0]
    assert page[:2].tolist() == np.asarray(jpage).tolist()
