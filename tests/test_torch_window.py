"""The port's sliding-window plane (gemma2-2b: local layers with a window,
global layers, softcaps, sandwich norms) against ``repro`` on the same
inputs: the window page math and eager prefix free, the windowed
audit, the ring walk the window kernels follow, the window group's
prefill scatter, the converted gemma2 tree, the model's prefill and
decode over dense rings and ring-table window pools, and the engines.

Inputs come from a numpy seed; the JAX side runs under
``target("generic")`` (queue C note 0 of ROADMAP.md: its interpret
path is broken for dense decode on this jax); the port runs on the
CPU, where every kernel wrapper takes its plain version.  The window
kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py).
"""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels.decode_attention import ref as jref
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro.serve import paging as jpaging
from repro_torch.configs import get_config as port_get_config
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.quant import resolve_kv_spec
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

WINDOW = 16                                 # the smoke config's window
TOL = dict(atol=1e-4, rtol=1e-4)            # float32, another sum order


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(x):
    """JAX or numpy array -> CPU torch tensor (fp8 through its bytes)."""
    a = np.asarray(x)
    if a.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(np.array(a))


def _bytes(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(jnp.asarray(want, jnp.float32)),
                               **TOL)


# ------------------------------------------------------ window page math ----

@pytest.mark.parametrize("window,ps", [(16, 4), (16, 16), (17, 16),
                                       (128, 64), (4096, 64), (5, 8)])
def test_window_page_math_matches_reference(window, ps):
    tw = paging.window_table_width(window, ps)
    assert tw == jpaging.window_table_width(window, ps)
    for length in range(0, 4 * window + 2 * ps, max(1, window // 16)):
        assert paging.first_live_page(length, window, ps) == \
            jpaging.first_live_page(length, window, ps)
        live = paging.live_window_pages(length, window, ps)
        assert live == jpaging.live_window_pages(length, window, ps)
        assert len(live) <= tw
        assert len({g % tw for g in live}) == len(live)   # no clobber


def _ring_row(allocator, length, tw, ps=4):
    row = np.full((tw,), paging.NULL_PAGE, np.int32)
    for g in paging.live_window_pages(length, WINDOW, ps):
        row[g % tw] = allocator.alloc()
    return row


@pytest.mark.parametrize("old_len,new_len", [(20, 28), (20, 20), (16, 17),
                                             (33, 52)])
def test_free_prefix_matches_reference(old_len, new_len):
    """The same pages freed, the same columns nulled, on both sides."""
    tw = paging.window_table_width(WINDOW, 4)
    a, ja = paging.PageAllocator(1 + tw), jpaging.PageAllocator(1 + tw)
    row, jrow = _ring_row(a, old_len, tw), _ring_row(ja, old_len, tw)
    old = paging.first_live_page(old_len, WINDOW, 4)
    new = paging.first_live_page(new_len, WINDOW, 4)
    assert paging.free_prefix(a, row, old, new) == \
        jpaging.free_prefix(ja, jrow, old, new)
    np.testing.assert_array_equal(row, jrow)
    assert a.in_use == ja.in_use and a.available == ja.available


@pytest.mark.parametrize("old,new,match", [(3, 1, "backwards"),
                                           (0, 6, "lap"),
                                           (0, 2, "NULL_PAGE")])
def test_free_prefix_refusals_match_reference(old, new, match):
    """Backwards moves, moves that would lap the ring and ranges holding
    the null page raise on both sides, and leave the allocator as it
    was."""
    tw = paging.window_table_width(WINDOW, 4)
    outcomes = []
    for mod in (paging, jpaging):
        a = mod.PageAllocator(1 + tw)
        row = np.full((tw,), mod.NULL_PAGE, np.int32)
        row[0] = a.alloc()
        with pytest.raises(ValueError, match=match) as err:
            mod.free_prefix(a, row, old, new)
        outcomes.append((str(err.value), a.in_use, row.tolist()))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0][1] == 1


# ---------------------------------------------------------- window audit ----

def _audit_state():
    tw = paging.window_table_width(WINDOW, 4)
    a = paging.PageAllocator(1 + tw)
    bt = _ring_row(a, 20, tw)[None]                 # live pages 1..4
    return a, bt, np.array([20]), np.array([True])


@pytest.mark.parametrize("damage,want", [
    (None, None),
    ("hole", "NULL_PAGE inside the live window (page 2) at column 2"),
    ("stale", "mapped behind the live window at column 0"),
    ("leak", "in_use 4 != sum of live window pages 0")])
def test_window_audit_matches_reference(damage, want):
    """Clean, holed and stale ring tables, and an inactive slot still
    holding its pages: the port's audit reports what the reference's
    does."""
    a, bt, lengths, active = _audit_state()
    ja = jpaging.PageAllocator(a.total_pages)
    for p in sorted(a._allocated):
        ja._free.remove(p)
        ja._allocated.add(p)
    if damage == "hole":
        bt[0, 2] = paging.NULL_PAGE
    elif damage == "stale":
        bt[0, 0] = 5                                # behind the window
    elif damage == "leak":
        active = np.array([False])
    got = paging.audit(a, bt, lengths, active, 4, window=WINDOW)
    ref = jpaging.audit(ja, bt, lengths, active, 4, window=WINDOW)
    if want is None:
        assert got == ref == []
    else:
        assert any(want in p for p in got), got
        assert [p for p in got if "is not allocated" not in p] == \
            [p for p in ref if "is not allocated" not in p]


# -------------------------------------------------------------- ring walk ----

def _ring_case(lengths, window=96, ps=32, hkv=2, d=64, seed=0):
    """Pools and ring tables mapping each slot's live window pages to
    scrambled pages (global page g at column g % T_w)."""
    tw = paging.window_table_width(window, ps)
    n_pages = 1 + len(lengths) * tw
    perm = list(np.random.default_rng(seed).permutation(
        np.arange(1, n_pages)))
    bt = np.zeros((len(lengths), tw), np.int32)
    for i, n in enumerate(lengths):
        for g in paging.live_window_pages(n, window, ps):
            bt[i, g % tw] = perm.pop()
    kp = _rand((hkv, n_pages, ps, d), seed + 1)
    vp = _rand((hkv, n_pages, ps, d), seed + 2)
    return kp, vp, bt, np.array(lengths, np.int32)


@pytest.mark.parametrize("page_size,block_kv", [(32, 32), (32, 8), (16, 16),
                                                (8, 4)])
def test_ring_walk_follows_the_reference_index_map(page_size, block_kv):
    """Block ``ik`` of the reference's grid reads ring column ``(first +
    ik // spp) % T_w`` (paged.py:301-305); the walk the window kernels
    follow names the same page at the same token offset, after the
    logical re-paging the launcher applies."""
    window = 96
    kp, _, bt, lengths = _ring_case([1, 95, 96, 130, 481, 0], window)
    pool, btl = paged_kern.repage(_t(kp), _t(bt), page_size)
    walk, start = paged_kern.ring_walk(btl, _t(lengths), window, page_size)
    bk = paged_kern.clamp_block_kv(block_kv, page_size)
    spp = page_size // bk
    tw = btl.shape[1]
    assert walk.shape == btl.shape and walk.dtype == torch.int32
    for b, n in enumerate(lengths):
        first = max(int(n) - window, 0) // page_size
        assert int(start[b]) == first * page_size
        for ik in range(tw * spp):
            col = (first + ik // spp) % tw
            k_start = (first + ik // spp) * page_size + (ik % spp) * bk
            # the kernel's block at k_start: page walk[(k - start) // ps]
            j = (k_start - int(start[b])) // page_size
            assert int(walk[b, j]) == int(btl[b, col])


@pytest.mark.parametrize("softcap", [None, 50.0])
def test_window_plain_matches_reference_and_dense(softcap):
    """The window plain version against ``repro``'s ring oracle and
    against dense windowed attention over the un-rung timeline, with an
    empty slot, slots inside the window and wrapped rings."""
    window, ps = 96, 32
    lengths = [0, 1, 95, 96, 130, 481]
    kp, vp, bt, ln = _ring_case(lengths, window, ps)
    q = _rand((len(lengths), 4, 64), 9)
    kw = dict(window=window, softcap=softcap)
    jres = jref.window_paged_decode_attention_ref(
        *(jnp.asarray(a) for a in (q, kp, vp, bt, ln)),
        return_residuals=True, **kw)
    got = dec_ops.window_paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(ln), return_residuals=True, **kw)
    for g, w in zip(got, jres):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)
    dense_k = np.zeros((len(lengths), 2, max(lengths), 64), np.float32)
    dense_v = np.zeros_like(dense_k)
    tw = bt.shape[1]
    for i, n in enumerate(lengths):
        for g in paging.live_window_pages(n, window, ps):
            lo, hi = g * ps, min((g + 1) * ps, n)
            dense_k[i, :, lo:hi] = kp[:, bt[i, g % tw], :hi - lo]
            dense_v[i, :, lo:hi] = vp[:, bt[i, g % tw], :hi - lo]
    out = dec_ops.window_paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(bt), _t(ln), **kw)
    dense = dec_ref.decode_attention_ref(_t(q), _t(dense_k), _t(dense_v),
                                         _t(ln), **kw)
    torch.testing.assert_close(out, dense, atol=2e-5, rtol=2e-5)
    assert not out[0].any()                         # the empty slot


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_quant_window_plain_matches_reference(kv_dtype):
    from repro.quant import spec_for_storage
    window, ps = 96, 32
    kp, vp, bt, ln = _ring_case([3, 96, 200, 481], window, ps)
    s = spec_for_storage({"int8": jnp.int8,
                          "fp8_e4m3": jnp.float8_e4m3fn}[kv_dtype])
    kq, ks = s.quantize_pages(jnp.asarray(kp))
    vq, vs = s.quantize_pages(jnp.asarray(vp))
    q = _rand((4, 4, 64), 3)
    want = jref.quant_window_paged_decode_attention_ref(
        jnp.asarray(q), kq, vq, ks, vs, jnp.asarray(bt), jnp.asarray(ln),
        window=window, softcap=30.0, return_residuals=True)
    got = dec_ops.quant_window_paged_decode_attention(
        _t(q), _t(kq), _t(vq), _t(ks), _t(vs), _t(bt), _t(ln),
        window=window, softcap=30.0, return_residuals=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5,
                                   rtol=2e-5)


def test_window_launchers_refuse_cpu_tensors_and_no_window():
    q = torch.zeros(2, 4, 64)
    pool = torch.zeros(2, 5, 16, 64)
    bt = torch.ones(2, 3, dtype=torch.int32)
    ln = torch.ones(2, dtype=torch.int32)
    kw = dict(softcap=None, scale=None, page_size=None, block_kv=64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kern.window_paged_decode_attention_fwd(q, pool, pool, bt, ln,
                                                     window=16, **kw)
    with pytest.raises(ValueError, match="requires a window"):
        paged_kern.window_paged_decode_attention_fwd(q, pool, pool, bt, ln,
                                                     window=None, **kw)
    qpool = torch.zeros(2, 5, 16, 64, dtype=torch.int8)
    sc = torch.ones(2, 5)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kern.window_paged_decode_attention_fwd(
            q, qpool, qpool, bt, ln, window=16, k_scales=sc, v_scales=sc,
            **kw)
    with pytest.raises(NotImplementedError, match=r"\(64, 128, 256\)"):
        paged_kern.window_paged_decode_attention_fwd(
            torch.zeros(2, 4, 48), torch.zeros(2, 5, 16, 48),
            torch.zeros(2, 5, 16, 48), bt, ln, window=16, **kw)
    assert paged_kern.WINDOW_KERNEL.launches == 0
    assert paged_kern.QUANT_WINDOW_KERNEL.launches == 0


# ---------------------------------------------------- window scatter ----

@pytest.mark.parametrize("kv_dtype", [None, "int8", "fp8_e4m3"])
def test_window_prefill_scatter_matches_reference(kv_dtype):
    """The window group's prefill scatter: the ring leaves of a prefill
    un-rung to true positions, only the live window's pages written,
    quantized per (head, page) where the pool is; the same pools (to
    the byte) and scales as ``repro``'s ``_scatter_pages_window``."""
    k, h, d, ps = 2, 2, 16, 4
    plens = np.array([21, 9], np.int32)
    t = paging.pages_per_slot(32, ps)
    ring = {name: np.zeros((k, h, WINDOW, d), np.float32)
            for name in ("k", "v")}
    for name, seed in (("k", 1), ("v", 2)):
        full = _rand((k, h, 21, d), seed)
        for i, n in enumerate(plens):               # position p at p % W
            for p in range(max(0, n - WINDOW), n):
                ring[name][i, :, p % WINDOW] = full[i, :, p]
    tw = paging.window_table_width(WINDOW, ps)
    total = 1 + k * tw
    rows_w = np.zeros((k, t), np.int32)
    nxt = 1
    for i, n in enumerate(plens):
        for g in paging.live_window_pages(int(n), WINDOW, ps):
            rows_w[i, g] = nxt
            nxt += 1
    spec = None if kv_dtype is None else resolve_kv_spec(kv_dtype, "cpu")
    caches = paging.init_paged_caches(1, h, d, total, ps, device="cpu",
                                      dtype=torch.float32, kv_spec=spec,
                                      window_layers=[0],
                                      total_pages_window=total)
    assert set(caches[0]) == ({"kw", "vw"} if spec is None
                              else {"kw", "vw", "ks", "vs"})
    paging.scatter_prefill(caches, [{n: torch.from_numpy(ring[n])
                                     for n in ("k", "v")}],
                           torch.arange(k), None, torch.from_numpy(rows_w),
                           plens=torch.from_numpy(plens), window=WINDOW)
    live = list(range(1, nxt))
    for name in ("k", "v"):
        leaf = jnp.asarray(ring[name])[None]
        if spec is None:
            jp = jpaging._scatter_pages_window(
                jnp.zeros((1, h, total, ps, d)), leaf, jnp.asarray(rows_w),
                WINDOW, jnp.asarray(plens))
            np.testing.assert_array_equal(
                caches[0][f"{name}w"].numpy()[:, live],
                np.asarray(jp[0])[:, live])
            continue
        jdt = {"int8": jnp.int8, "fp8_e4m3": jnp.float8_e4m3fn}[kv_dtype]
        jp, js = jpaging._scatter_pages_window_quant(
            jnp.zeros((1, h, total, ps, d), jdt), jnp.ones((1, h, total)),
            leaf, jnp.asarray(rows_w), WINDOW, jnp.asarray(plens))
        np.testing.assert_array_equal(_bytes(caches[0][f"{name}w"])[:, live],
                                      _bytes(_t(jp[0]))[:, live])
        np.testing.assert_array_equal(caches[0][f"{name}s"].numpy()[:, live],
                                      np.asarray(js[0])[:, live])


# --------------------------------------------------------------- models ----

_STATE = {}


def _models(num_layers=4, dtype="float32"):
    """(jax model, jax params, port model, port params) of the gemma2
    smoke config (window 16)."""
    key = (num_layers, dtype)
    if key not in _STATE:
        cfg = dataclasses.replace(smoke_config("gemma2-2b",
                                               num_layers=num_layers),
                                  dtype=dtype)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pcfg = dataclasses.replace(
            port_smoke_config("gemma2-2b", num_layers=num_layers),
            dtype=dtype)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[key] = (model, params, port_build_model(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[key]


def test_config_and_smoke_rule_match_reference():
    from repro.configs import get_config
    for want, got in ((get_config("gemma2-2b"),
                       port_get_config("gemma2-2b")),
                      (smoke_config("gemma2-2b"),
                       port_smoke_config("gemma2-2b"))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert port_smoke_config("gemma2-2b").window == WINDOW
    assert port_smoke_config("granite-8b").window is None


@pytest.mark.parametrize("num_layers", [4, 3, 1])
def test_plan_segments_matches_reference(num_layers):
    """A (local, global) block repeated as often as it fits, then the
    truncated tail: the layout ``convert`` reads."""
    from repro.models.transformer import plan_segments
    cfg = port_smoke_config("gemma2-2b", num_layers=num_layers)
    jcfg = smoke_config("gemma2-2b", num_layers=num_layers)
    assert [(p.block, p.reps) for p in PT.plan_segments(cfg)] == \
        [(p.block, p.reps) for p in plan_segments(jcfg)]


@pytest.mark.parametrize("num_layers", [4, 3])
def test_convert_reads_the_gemma2_tree(num_layers):
    """Layer i of the port is position i % 2 of the reference's block at
    repeat i // 2 (the tail segment after the repeats), with its post
    norms."""
    model, params, pmodel, pparams = _models(num_layers)
    kinds = pmodel.cfg.layer_kinds()
    assert len(pparams["layers"]) == num_layers
    segs = params["segments"]
    for i, layer in enumerate(pparams["layers"]):
        seg, pos, r = (0, i % 2, i // 2) if i < 2 * (num_layers // 2) \
            else (1, 0, 0)
        blk = segs[seg][pos]
        assert kinds[i] == ("local", "global")[i % 2]
        for name in ("ln1", "post_ln1", "ln2", "post_ln2"):
            np.testing.assert_array_equal(layer[name].numpy(),
                                          np.asarray(blk[name][r]))
        np.testing.assert_array_equal(
            layer["attn"]["wq"].numpy(),
            np.asarray(blk["attn"]["wq"][r]).reshape(64, -1))
        np.testing.assert_array_equal(layer["mlp"]["w_gate"].numpy(),
                                      np.asarray(blk["mlp"]["w_gate"][r]))


def test_check_supported_admits_gemma2_and_names_what_is_left():
    """gemma2 with gemma3's qk-norm and local RoPE base is admitted, and
    so are an encoder and the vision and audio frontends (whisper's and
    internvl2's fields); a frontend the reference has no stub for is
    refused by name."""
    cfg = port_smoke_config("gemma2-2b")
    PT.check_supported(cfg)
    PT.check_supported(dataclasses.replace(cfg, use_qk_norm=True,
                                           rope_theta_local=1e4))
    for change in (dict(encoder_layers=2), dict(frontend="vision"),
                   dict(frontend="audio")):
        PT.check_supported(dataclasses.replace(cfg, **change))
    with pytest.raises(NotImplementedError, match="'video'"):
        PT.check_supported(dataclasses.replace(cfg, frontend="video"))


CACHE_LEN, PAGE = 40, 4


def _prefill_both(toks, num_layers=4, dtype="float32"):
    model, params, pmodel, pparams = _models(num_layers, dtype)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), CACHE_LEN,
                                       {})
    plogits, pcaches = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                      CACHE_LEN)
    return (logits, caches), (plogits, pcaches)


def _jleaf(caches, i, name):
    """Layer i's leaf of the reference's segmented cache tree."""
    return caches[0][i % 2][name][i // 2]


@pytest.mark.parametrize("s", [9, 21, 33])
def test_prefill_logits_and_ring_caches_match(s):
    """Prompts inside the window and past it (the ring has wrapped):
    the same logits, global caches padded to the cache, local caches
    rings of the window with token p at slot p % 16."""
    toks = np.random.default_rng(s).integers(0, 256, (2, s)).astype(
        np.int32)
    (logits, caches), (plogits, pcaches) = _prefill_both(toks)
    _close(plogits, logits)
    for i, c in enumerate(pcaches):
        want_len = WINDOW if i % 2 == 0 else CACHE_LEN
        assert c["k"].shape == (2, 2, want_len, 16)
        _close(c["k"], _jleaf(caches, i, "k"))
        _close(c["v"], _jleaf(caches, i, "v"))


def test_forward_logits_from_a_start_position():
    _, _, pmodel, pparams = _models()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (2, 12))).long()
    full = pmodel.forward_logits(pparams, toks)
    tail = pmodel.forward_logits(pparams, toks, start=7)
    assert tail.shape == (2, 5, 256)
    torch.testing.assert_close(tail, full[:, 7:], atol=1e-5, rtol=1e-5)
    assert float(full[..., :256].abs().max()) <= 30.0     # final softcap


def test_dense_ring_decode_steps_past_the_window_match():
    """Five decode steps over dense caches, the local layers' rings
    written at lengths % 16 and read whole, from a prompt past the
    window: the reference's logits and caches at every step."""
    model, params, pmodel, _ = _models()
    toks = np.random.default_rng(1).integers(0, 256, (2, 21)).astype(
        np.int32)
    (_, caches), (_, pcaches) = _prefill_both(toks)
    lengths = np.array([21, 14], np.int32)
    cur = np.array([3, 250], np.int32)
    for _ in range(5):
        with ctx.target("generic"):
            logits, caches = model.decode_step(
                params, caches, jnp.asarray(cur), jnp.asarray(lengths))
        plogits = pmodel.decode_step(_models()[3], pcaches,
                                     torch.from_numpy(cur),
                                     torch.from_numpy(lengths))
        _close(plogits, logits)
        for i, c in enumerate(pcaches):
            _close(c["k"], _jleaf(caches, i, "k"))
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        lengths = lengths + 1


def _paged_both(toks, plens, kv_dtype=None):
    """Both sides' paged caches holding the same prefill: the global
    group's pages and the window group's ring tables."""
    model, params, pmodel, pparams = _models()
    k = toks.shape[0]
    t = paging.pages_per_slot(CACHE_LEN, PAGE)
    tw = paging.window_table_width(WINDOW, PAGE)
    total, total_w = 1 + k * t, 1 + k * tw
    rows = np.zeros((k, t), np.int32)
    rows_w = np.zeros((k, t), np.int32)
    bt_w = np.zeros((k, tw), np.int32)
    nxt, nxt_w = 1, 1
    for i, n in enumerate(plens):
        for j in range(paging.pages_per_slot(n + 8, PAGE)):
            rows[i, j] = nxt
            nxt += 1
        for g in paging.live_window_pages(n, WINDOW, PAGE):
            rows_w[i, g] = bt_w[i, g % tw] = nxt_w
            nxt_w += 1
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from repro.quant import resolve_kv_spec as jresolve
        jspec = jresolve(kv_dtype) if kv_dtype else None
        _, cache1 = model.prefill(params, jnp.asarray(toks), CACHE_LEN, {})
        jc = jpaging.init_paged_caches(model, k, CACHE_LEN, PAGE, total,
                                       kv_spec=jspec,
                                       total_pages_window=total_w)
        jc = jpaging.scatter_prefill(
            jc, cache1, jnp.arange(k), jnp.asarray(rows),
            page_rows_w=jnp.asarray(rows_w),
            plens=jnp.asarray(plens, jnp.int32), window=WINDOW)
    _, pcache1 = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                CACHE_LEN)
    spec = resolve_kv_spec(kv_dtype, "cpu") if kv_dtype else None
    pc = paging.init_paged_caches(
        4, 2, 16, total, PAGE, device="cpu", dtype=torch.float32,
        kv_spec=spec, window_layers=[0, 2], total_pages_window=total_w)
    paging.scatter_prefill(pc, pcache1, torch.arange(k),
                           torch.from_numpy(rows), torch.from_numpy(rows_w),
                           plens=torch.tensor(plens), window=WINDOW)
    return jc, pc, rows, bt_w


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_window_decode_steps_past_the_window_match(kv_dtype):
    """Decode steps over the global group's pages and the window group's
    ring tables, past page edges where a write lands in the ring column
    of a page the window has left (the page is kept there, as a freed
    and re-leased page would be): the reference's logits at every step,
    and the dense-ring port's too."""
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(2).integers(0, 256, (2, 19)).astype(
        np.int32)
    plens = [19, 19]
    jc, pc, rows, bt_w = _paged_both(toks, plens, kv_dtype)
    _, dense = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                              CACHE_LEN)
    lengths = np.array(plens, np.int32)
    cur = np.array([5, 77], np.int32)
    bt = {"global": rows, "window": bt_w}
    for _ in range(6):
        with ctx.target("generic"):
            logits, jc = model.decode_step(
                params, jc, jnp.asarray(cur), jnp.asarray(lengths),
                block_tables={k: jnp.asarray(v) for k, v in bt.items()})
        plogits = pmodel.decode_step(
            pparams, pc, torch.from_numpy(cur), torch.from_numpy(lengths),
            block_tables={k: torch.from_numpy(v.copy())
                          for k, v in bt.items()})
        _close(plogits, logits)
        if kv_dtype is None:
            dlogits = pmodel.decode_step(pparams, dense,
                                         torch.from_numpy(cur),
                                         torch.from_numpy(lengths))
            torch.testing.assert_close(dlogits, plogits, atol=1e-5,
                                       rtol=1e-5)
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        lengths = lengths + 1


# -------------------------------------------------------------- engines ----

_SC = dict(slots=2, cache_len=64, max_new_tokens=12)


def _prompts(n=3, length=20):
    return [[(7 * i + j) % 250 + 1 for j in range(length)]
            for i in range(n)]


def _run_jax(prompts, **sc):
    model, params, _, _ = _models(2)
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**sc))
        reqs = [Request(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
        eng.run_to_completion(reqs)
    return eng, reqs


def _run_port(prompts, audit_every_step=False, **sc):
    _, _, pmodel, pparams = _models(2)
    eng = PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")
    reqs = [PortRequest(rid=i, tokens=list(p))
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    for _ in range(1000):
        busy = eng.step()
        if audit_every_step:
            assert eng.audit() == [], eng.step_count
        if not busy and not eng.queue and not eng.requeue:
            break
    return eng, reqs


@pytest.mark.parametrize("kv_dtype", [None, "bf16", "int8"])
def test_paged_window_engine_token_identical_past_the_window(kv_dtype):
    """Prompts of 20 tokens and 12 new ones each, window 16, pages of 4:
    the rings wrap and the window slides past page edges.  The paged
    engine (global pool + window group) emits the reference engine's
    tokens and, unquantized, the port's dense-ring engine's; pages
    behind the window are freed and every step's audit is clean."""
    prompts = _prompts()
    sc = dict(_SC, paged=True, page_size=4)
    if kv_dtype is not None:
        sc["kv_dtype"] = kv_dtype
    jeng, jreqs = _run_jax(prompts, **sc)
    peng, preqs = _run_port(prompts, audit_every_step=True, **sc)
    assert peng.windowed and jeng.windowed
    assert peng.tw == paging.window_table_width(WINDOW, 4)
    assert all(r.done and len(r.out) == 12 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    st, jst = peng.stats(), jeng.stats()
    assert st["window_prefix_frees"] == jst["window_prefix_frees"] > 0
    for group, pressure in st["pool_groups"].items():
        assert pressure == {k: jst["pool_groups"][group][k]
                            for k in pressure}, group
    assert st["pool_groups"]["window"]["in_use"] == 0
    if kv_dtype is None:
        _, dense = _run_port(prompts, **_SC)
        assert [r.out for r in dense] == [r.out for r in preqs]


def test_dense_ring_engine_matches_reference():
    prompts = _prompts(4, 23)
    _, jreqs = _run_jax(prompts, **_SC)
    peng, preqs = _run_port(prompts, **_SC)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.caches[0]["k"].shape[2] == WINDOW        # the ring
    assert peng.caches[1]["k"].shape[2] == _SC["cache_len"]


@pytest.mark.parametrize("policy", ["lru", "shortest"])
def test_window_preemption_at_half_the_global_pool(policy):
    """Prompts of 5 tokens decode 27 more, past the window: two slots
    need 16 pages of 4 at the end, and a global pool of 8 usable pages
    (half of it) forces preemption.  Re-admitted checkpoints re-prefill
    their window tails; the tokens are those of the reference under the
    same policy and of an unconstrained run."""
    prompts = _prompts(4, 5)
    sc = dict(_SC, max_new_tokens=27, paged=True, page_size=4)
    _, free = _run_port(prompts, **sc)
    jeng, jreqs = _run_jax(prompts, total_pages=9, preempt_policy=policy,
                           **sc)
    peng, preqs = _run_port(prompts, audit_every_step=True, total_pages=9,
                            preempt_policy=policy, **sc)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert [r.out for r in preqs] == [r.out for r in free]
    assert peng.preemptions == jeng.preemptions > 0
    assert peng.stats()["pool_groups"]["window"]["in_use"] == 0


def test_window_pool_sizing_and_refusals():
    """The default window pool never runs dry (1 + slots * T_w); a
    prompt whose live window outgrows an explicit window pool is
    refused at submit, as by the reference."""
    _, _, pmodel, pparams = _models(2)
    eng = PortEngine(pmodel, pparams,
                     PortServeConfig(paged=True, page_size=4, **_SC),
                     device="cpu")
    assert eng.allocator_w.total_pages == 1 + 2 * eng.tw
    small = PortEngine(pmodel, pparams,
                       PortServeConfig(paged=True, page_size=4,
                                       total_pages_window=3, **_SC),
                       device="cpu")
    with pytest.raises(ValueError, match="total_pages_window"):
        small.submit(PortRequest(rid=0, tokens=list(range(1, 21))))
    wide = PortEngine(pmodel, pparams,
                      PortServeConfig(paged=True, page_size=4, slots=2,
                                      cache_len=16, max_new_tokens=4),
                      device="cpu")
    assert not wide.windowed and "kw" not in wide.caches[0]


def test_spec_mode_raises_for_local_layers():
    _, _, pmodel, pparams = _models(2)
    with pytest.raises(ValueError, match="roll back"):
        PortEngine(pmodel, pparams,
                   PortServeConfig(paged=True, spec_mode="ngram", **_SC),
                   device="cpu")
    model, params, _, _ = _models(2)
    with pytest.raises(ValueError, match="roll back"):
        Engine(model, params, ServeConfig(paged=True, spec_mode="ngram",
                                          **_SC))


def test_launcher_serves_gemma2_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", "gemma2-2b", "--smoke", "--prompts", "3",
                       "--prompt-len", "20", "--max-new", "6", "--paged",
                       "--page-size", "4", "--device", "cpu"])
    assert all(r.done and len(r.out) == 6 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"window_prefix_frees"' in out
