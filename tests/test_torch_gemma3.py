"""gemma3 through the port (five sliding-window local layers of a 1,024-
token window to each global one, qk-norm, a RoPE base of its own on the
local layers) against ``repro`` on the CPU.

Both configs field for field and their segmentation at full depth (34
and 62 layers end mid-cycle) and at the cuts served on the card; the
``convert`` tree with ``q_norm``/``k_norm``; B1's plain version at rows
of the smoke head width; the RoPE tables, one per base and call;
prefill logits and caches in float32 and bfloat16; decode steps over
dense rings and over the paged window group; the engines paged, dense,
int8 and fp8 (to the contract ``tests/test_torch_quant.py`` holds
granite's to), and a global-only qk-norm speculative engine, token for
token against ``repro.serve.Engine``; and the launcher at smoke size.

The smoke model is cut to 7 layers (one period of five local and one
global layer, then one more local layer: mid-cycle, as 34 and 62 are)
and its qk-norm weights are drawn from a numpy seed, so that they and
the two RoPE bases both move the outputs.  The JAX side runs under
``target("generic")``; the port on the CPU, where every kernel wrapper
takes its plain version.
"""
from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.kernels import registry as R
from repro.models import transformer as JT
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro.serve import paging as jpaging
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.quant import DECODE_TOL, resolve_kv_spec
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "gemma3-4b"
ARCHS = ("gemma3-4b", "gemma3-27b")
LAYERS = 7                        # one period, then a local layer
WINDOW = 16                       # the smoke config's window
CACHE_LEN, PAGE = 40, 4
# float32: the same graph in another summation order; bfloat16: every
# product rounds to 8 mantissa bits at other places in XLA and torch
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=6e-2, rtol=6e-2)}

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype="float32"):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _with_qk_norms(params, seed=7):
    """The reference's params with every ``q_norm``/``k_norm`` drawn
    from a numpy seed (init leaves them at 0, where q and k share one
    norm weight, the identity's)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        if getattr(path[-1], "key", None) in ("q_norm", "k_norm"):
            return jnp.asarray(0.5 * rng.standard_normal(leaf.shape),
                               leaf.dtype)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


def _models(dtype="float32", pattern=None):
    """(jax model, jax params, port model, port params) of the gemma3-4b
    smoke config cut to LAYERS, in ``dtype``; ``pattern`` replaces the
    layer pattern (the global-only speculative model)."""
    key = (dtype, pattern)
    if key not in _STATE:
        kw = dict(dtype=dtype)
        if pattern is not None:
            kw["layer_pattern"] = pattern
        cfg = dataclasses.replace(smoke_config(ARCH, num_layers=LAYERS),
                                  **kw)
        pcfg = dataclasses.replace(port_smoke_config(ARCH, num_layers=LAYERS),
                                   **kw)
        model = build_model(cfg)
        params = _with_qk_norms(model.init(jax.random.PRNGKey(0)))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[key] = (model, params, port_build_model(pcfg),
                       from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[key]


# ----------------------------------------------------------- config -----

@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    for want, got in ((get_config(arch), port_configs.get_config(arch)),
                      (smoke_config(arch), port_smoke_config(arch))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    cfg = port_configs.get_config(arch)
    assert arch not in port_configs.LATER_SLICES
    assert cfg.use_qk_norm and cfg.rope_theta_local == 10_000.0
    assert cfg.layer_pattern == ("local",) * 5 + ("global",)
    assert port_smoke_config(arch).window == WINDOW
    PT.check_supported(cfg)


@pytest.mark.parametrize("arch,num_layers", [
    ("gemma3-4b", 34), ("gemma3-27b", 62), ("gemma3-27b", 8),
    ("gemma3-4b", 12), ("gemma3-4b", 7), ("gemma3-4b", 5)])
def test_segments_match_reference(arch, num_layers):
    """The 6-layer block repeated as often as it fits, then the
    mid-cycle tail (34 = 5 x 6 + 4, 62 = 10 x 6 + 2, 8 = 6 + 2): the
    layout ``convert`` reads, and the local/global counts served."""
    jcfg = dataclasses.replace(get_config(arch), num_layers=num_layers)
    pcfg = dataclasses.replace(port_configs.get_config(arch),
                               num_layers=num_layers)
    got = [(p.block, p.reps) for p in PT.plan_segments(pcfg)]
    assert got == [(p.block, p.reps) for p in JT.plan_segments(jcfg)]
    kinds = pcfg.layer_kinds()
    assert kinds.count("global") == num_layers // 6
    assert kinds == jcfg.layer_kinds()


def test_check_supported_names_only_encoders_and_frontends():
    """An encoder and the vision and audio frontends are admitted beside
    gemma3's own fields; an unknown frontend is refused by name, and
    the message lists qk-norm among what the port serves."""
    cfg = port_smoke_config(ARCH)
    PT.check_supported(cfg)
    for change in (dict(encoder_layers=2), dict(frontend="vision"),
                   dict(frontend="audio")):
        PT.check_supported(dataclasses.replace(cfg, **change))
    with pytest.raises(NotImplementedError, match="'video'") as e:
        PT.check_supported(dataclasses.replace(cfg, frontend="video"))
    assert "qk-norm" in str(e.value).split("the port serves")[1]


def test_convert_carries_q_norm_and_k_norm():
    """Layer i is position i % 6 of the block at repeat i // 6 (then
    the tail), its ``attn`` leaf with the reference's q_norm and k_norm
    (head_dim,) beside the projections."""
    _, params, pmodel, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    kinds = pmodel.cfg.layer_kinds()
    assert len(pparams["layers"]) == LAYERS
    for i, layer in enumerate(pparams["layers"]):
        seg, pos, r = (0, i % 6, i // 6) if i < 6 else (1, 0, 0)
        blk = tree["segments"][seg][pos]
        assert kinds[i] == ("global" if i == 5 else "local")
        for name in ("q_norm", "k_norm"):
            assert layer["attn"][name].shape == (16,)
            np.testing.assert_array_equal(layer["attn"][name].numpy(),
                                          blk["attn"][name][r])
        for name in ("ln1", "post_ln1", "ln2", "post_ln2"):
            np.testing.assert_array_equal(layer[name].numpy(), blk[name][r])
    a = pparams["layers"][0]["attn"]
    assert not torch.equal(a["q_norm"], a["k_norm"])


def test_init_adds_zero_qk_norms():
    pmodel = port_build_model(port_smoke_config(ARCH, num_layers=2))
    params = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    for layer in params["layers"]:
        for name in ("q_norm", "k_norm"):
            assert torch.equal(layer["attn"][name], torch.zeros(16))


# ------------------------------------------------ B1 at head rows -----

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rmsnorm_plain_at_head_rows(dtype):
    """B1's plain version at rows of the smoke head width (16), as
    qk-norm runs it over (B, H, S, hd), against the reference's rmsnorm
    under the op's tol (bf16: its output rounding)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    w = (0.5 * rng.standard_normal((16,))).astype(np.float32)
    xj, wj = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    with ctx.target("generic"):
        want = R.get_op("rmsnorm").ref(xj, wj, eps=1e-6, weight_offset=1.0,
                                       block_rows=None)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    got = rms_ops.rmsnorm(_t(_np(xj)).to(tdt), _t(_np(wj)).to(tdt), eps=1e-6,
                          weight_offset=1.0)
    tol = rms_ops.TOL if dtype == np.float32 else TOL["bfloat16"]
    np.testing.assert_allclose(got.float().numpy(), _np(want), **tol)


# ------------------------------------------------------------ RoPE -----

def test_rope_tables_one_per_base_and_call(monkeypatch):
    """Each call computes one cos/sin pair per RoPE base of the stack
    (two for gemma3), whatever its depth, and each layer takes its
    kind's base (``repro`` transformer.py:124)."""
    cfg = port_smoke_config(ARCH, num_layers=LAYERS)
    assert PT._theta(cfg, "local") == 10_000.0
    assert PT._theta(cfg, "global") == 1_000_000.0
    assert PT._theta(port_smoke_config("gemma2-2b"), "local") == 10_000.0
    _, _, pmodel, pparams = _models()
    from repro_torch.models import layers as L
    real, thetas = L.rope_cache, []

    def counted(pos, dim, theta):
        thetas.append(theta)
        return real(pos, dim, theta)
    monkeypatch.setattr(L, "rope_cache", counted)
    toks = torch.tensor([[3, 4, 5]])
    pmodel.prefill(pparams, toks, CACHE_LEN)
    assert sorted(thetas) == [10_000.0, 1_000_000.0]
    thetas.clear()
    caches = pmodel.init_decode_caches(1, CACHE_LEN, "cpu")
    pmodel.decode_step(pparams, caches, torch.tensor([3]),
                       torch.tensor([0], dtype=torch.int32))
    assert sorted(thetas) == [10_000.0, 1_000_000.0]


# ------------------------------------------------------------ model -----

def _prefill_both(toks, dtype="float32"):
    model, params, pmodel, pparams = _models(dtype)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), CACHE_LEN,
                                       {})
    plogits, pcaches = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                      CACHE_LEN)
    return (logits, caches), (plogits, pcaches)


def _jleaf(caches, i, name):
    """Layer i's leaf of the reference's segmented cache tree."""
    return caches[0][i % 6][name][i // 6] if i < 6 else caches[1][0][name][0]


def _err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)
                        ).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [9, 33])
def test_prefill_logits_and_caches_match(dtype, s):
    """Prompts inside the window and past it: the same logits, global
    caches padded to the cache, local ones rings of the window.  In
    float32 within TOL.  In bfloat16 both sides round every product at
    other places, and the drift grows with depth (the seventh layer's K
    about 0.1 apart), so each output is held to the reference's own
    bf16 rounding instead: the port's bf16 output may lie at most twice
    as far from the reference's bf16 one as that lies from the float32
    forward of the same weights."""
    toks = np.random.default_rng(s).integers(0, 256, (2, s)).astype(np.int32)
    (logits, caches), (plogits, pcaches) = _prefill_both(toks, dtype)
    outs = [(plogits, logits)] + [
        (c[n], _jleaf(caches, i, n)) for i, c in enumerate(pcaches)
        for n in ("k", "v")]
    for i, c in enumerate(pcaches):
        assert c["k"].shape == (2, 2, CACHE_LEN if i == 5 else WINDOW, 16)
    if dtype == "float32":
        for got, want in outs:
            _close(got, want)
        return
    (logits32, caches32), _ = _prefill_both(toks, "float32")
    wants32 = [logits32] + [_jleaf(caches32, i, n) for i in range(LAYERS)
                            for n in ("k", "v")]
    for (got, want), want32 in zip(outs, wants32):
        own = _err(_np(want), _np(want32))
        assert _err(got.float().numpy(), _np(want)) <= 2 * own


def test_dense_ring_decode_steps_past_the_window_match():
    """Five decode steps over dense caches from prompts past the window
    (local layers' rings written at lengths % 16): the reference's
    logits and caches at every step."""
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(1).integers(0, 256, (2, 21)).astype(
        np.int32)
    (_, caches), (_, pcaches) = _prefill_both(toks)
    lengths = np.array([21, 14], np.int32)
    cur = np.array([3, 250], np.int32)
    step = jax.jit(model.decode_step)
    for _ in range(5):
        with ctx.target("generic"):
            logits, caches = step(params, caches, jnp.asarray(cur),
                                  jnp.asarray(lengths))
        plogits = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
        _close(plogits, logits)
        for i, c in enumerate(pcaches):
            _close(c["k"], _jleaf(caches, i, "k"))
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        lengths = lengths + 1


def _paged_both(toks, plens, kv_dtype=None):
    """Both sides' paged caches holding the same prefill: the global
    layer's pages and the local layers' ring tables."""
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
    local = [i for i, kind in enumerate(pmodel.cfg.layer_kinds())
             if kind == "local"]
    pc = paging.init_paged_caches(
        LAYERS, 2, 16, total, PAGE, device="cpu", dtype=torch.float32,
        kv_spec=spec, window_layers=local, total_pages_window=total_w)
    paging.scatter_prefill(pc, pcache1, torch.arange(k), _t(rows),
                           _t(rows_w), plens=torch.tensor(plens),
                           window=WINDOW)
    return jc, pc, rows, bt_w


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_window_decode_steps_past_the_window_match(kv_dtype):
    """Decode steps over the global layer's pages and the six local
    layers' ring tables, past page edges: the reference's logits at
    every step."""
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(2).integers(0, 256, (2, 19)).astype(
        np.int32)
    jc, pc, rows, bt_w = _paged_both(toks, [19, 19], kv_dtype)
    assert ["kw" in c for c in pc] == [i != 5 for i in range(LAYERS)]
    lengths = np.array([19, 19], np.int32)
    cur = np.array([5, 77], np.int32)
    bt = {"global": rows, "window": bt_w}
    step = jax.jit(lambda *a: model.decode_step(*a[:4], block_tables=a[4]))
    for _ in range(6):
        with ctx.target("generic"):
            logits, jc = step(params, jc, jnp.asarray(cur),
                              jnp.asarray(lengths),
                              {k: jnp.asarray(v) for k, v in bt.items()})
        plogits = pmodel.decode_step(
            pparams, pc, _t(cur), _t(lengths),
            block_tables={k: _t(v) for k, v in bt.items()})
        _close(plogits, logits)
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        lengths = lengths + 1


# ----------------------------------------------------------- engines -----

_SC = dict(slots=2, cache_len=48, max_new_tokens=12)


def _prompts(n=3, length=20):
    return [[(7 * i + j) % 250 + 1 for j in range(length)]
            for i in range(n)]


def _run_jax(prompts, pattern=None, **sc):
    model, params, _, _ = _models(pattern=pattern)
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**sc))
        reqs = [Request(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
        eng.run_to_completion(reqs)
    return eng, reqs


def _run_port(prompts, pattern=None, audit_every_step=False, **sc):
    _, _, pmodel, pparams = _models(pattern=pattern)
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


@pytest.fixture(scope="module")
def dense_tokens():
    _, preqs = _run_port(_prompts(), **_SC)
    return [r.out for r in preqs]


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_paged_engine_token_identical_to_reference(kv_dtype, dense_tokens):
    """Prompts of 20 tokens and 12 new ones, window 16, pages of 4: the
    rings wrap and the window slides past page edges on six local
    layers and one global.  The paged engine (global pool + window
    group), bf16-free float32 or int8, emits the reference engine's
    tokens and, unquantized, the port's dense-ring engine's; pages
    behind the window are freed, the pool groups' pressure is the
    reference's and every step's audit is clean."""
    sc = dict(_SC, paged=True, page_size=PAGE)
    if kv_dtype is not None:
        sc["kv_dtype"] = kv_dtype
    jeng, jreqs = _run_jax(_prompts(), **sc)
    peng, preqs = _run_port(_prompts(), audit_every_step=True, **sc)
    assert peng.windowed and jeng.windowed
    assert all(r.done and len(r.out) == 12 for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    st, jst = peng.stats(), jeng.stats()
    assert st["window_prefix_frees"] == jst["window_prefix_frees"] > 0
    assert set(st["pool_groups"]) == set(jst["pool_groups"]) == \
        {"global", "window"}
    for group, pressure in st["pool_groups"].items():
        assert pressure == {k: jst["pool_groups"][group][k]
                            for k in pressure}, group
    if kv_dtype is None:
        assert [r.out for r in preqs] == dense_tokens
    else:
        assert peng.caches[0]["kw"].dtype == torch.int8
        assert peng.caches[5]["kp"].dtype == torch.int8


def test_dense_ring_engine_matches_reference(dense_tokens):
    _, jreqs = _run_jax(_prompts(), **_SC)
    assert dense_tokens == [r.out for r in jreqs]
    _, _, pmodel, _ = _models()
    caches = pmodel.init_decode_caches(2, _SC["cache_len"], "cpu")
    assert [c["k"].shape[2] for c in caches] == \
        [_SC["cache_len"] if i == 5 else WINDOW for i in range(LAYERS)]


def test_fp8_engine_completes_within_decode_tol():
    """The reference falls back to int8 under ``generic``, so the fp8
    engine is held to completion and to DECODE_TOL: after admission, a
    decode-attention call over each layer's fp8 pools (the window
    kernel's plain version over the ring tables on local layers) against
    the same call over the float32 engine's pools and tables."""
    engines, reqs = {}, {}
    for kv in ("fp8_e4m3", None):
        _, _, pmodel, pparams = _models()
        eng = PortEngine(pmodel, pparams,
                         PortServeConfig(paged=True, page_size=PAGE,
                                         kv_dtype=kv, **_SC), device="cpu")
        reqs[kv] = [PortRequest(rid=i, tokens=p)
                    for i, p in enumerate(_prompts())]
        for r in reqs[kv]:
            eng.submit(r)
        eng._admit()
        engines[kv] = eng
    fp8, f32 = engines["fp8_e4m3"], engines[None]
    assert fp8.kv_spec.dtype == "fp8_e4m3"
    assert (fp8.block_tables == f32.block_tables).all()
    assert (fp8.block_tables_w == f32.block_tables_w).all()
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 16)).astype(np.float32))
    lengths = torch.from_numpy(fp8._len_h.astype(np.int32))
    bt, bt_w = _t(fp8.block_tables), _t(fp8.block_tables_w)
    for cq, cf in zip(fp8.caches, f32.caches):
        if "kw" in cq:
            got = dec_ops.quant_window_paged_decode_attention(
                q, cq["kw"], cq["vw"], cq["ks"], cq["vs"], bt_w, lengths,
                window=WINDOW)
            want = dec_ops.window_paged_decode_attention(
                q, cf["kw"], cf["vw"], bt_w, lengths, window=WINDOW)
        else:
            got = dec_ops.quant_paged_decode_attention(
                q, cq["kp"], cq["vp"], cq["ks"], cq["vs"], bt, lengths)
            want = dec_ops.paged_decode_attention(q, cf["kp"], cf["vp"], bt,
                                                  lengths)
        assert float((got - want).abs().max()) <= DECODE_TOL["fp8_e4m3"]
    fp8.run_to_completion([])
    assert all(r.done and len(r.out) == 12 for r in reqs["fp8_e4m3"])
    assert fp8.allocator.in_use == 0 and fp8.audit() == []
    assert fp8.stats()["pool_groups"]["window"]["in_use"] == 0


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_global_only_qk_norm_spec_engine_token_identical(kv_dtype):
    """The engine refuses speculation over local layers (as the
    reference does), so qk-norm meets speculation in a global-only
    model: the n-gram engine at k = 2 over float32 or int8 pools emits
    the reference's tokens, with drafts both accepted and rejected."""
    pattern = ("global",)
    prompts = [[1 + i] * (3 + 2 * i) for i in range(4)]
    sc = dict(slots=2, cache_len=32, max_new_tokens=10, paged=True,
              page_size=PAGE, spec_mode="ngram", spec_k=2)
    if kv_dtype is not None:
        sc["kv_dtype"] = kv_dtype
    jeng, jreqs = _run_jax(prompts, pattern=pattern, **sc)
    peng, preqs = _run_port(prompts, pattern=pattern, audit_every_step=True,
                            **sc)
    assert peng.cfg.use_qk_norm and set(peng.cfg.layer_kinds()) == {"global"}
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    assert peng.spec_emitted > peng.spec_steps and peng.spec_rejections > 0


def test_spec_mode_raises_for_local_layers():
    _, _, pmodel, pparams = _models()
    with pytest.raises(ValueError, match="roll back"):
        PortEngine(pmodel, pparams,
                   PortServeConfig(paged=True, spec_mode="ngram", **_SC),
                   device="cpu")


# ---------------------------------------------------------- launcher -----

@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_serves_gemma3_on_cpu(capsys, arch):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", arch, "--smoke", "--layers", str(LAYERS),
                       "--prompts", "3", "--prompt-len", "20", "--max-new",
                       "6", "--paged", "--page-size", "4", "--device", "cpu"])
    assert all(r.done and len(r.out) == 6 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"window_prefix_frees"' in out
