"""int8/fp8 pools for the hybrid and recurrent models (jamba's attention
and mamba layers, xlstm's mLSTM and sLSTM layers) against ``repro`` on
the CPU.

The attention layers' pools quantize as granite's do; the recurrent
state keeps its dense slot-major leaves in the model's dtype
(``repro`` paging.py:454).  Held here: the paged caches' layout, the
quantizing scatter of an admitted group's prefill into a hybrid cache
(pool bytes, scales and recurrent leaves), quantized decode steps over
it (the re-quantizing page write at jamba's attention layer), the
jamba engine from int8 pools token for token against
``repro.serve.Engine`` and from fp8 pools to the contract
``tests/test_torch_quant.py`` holds granite's to (the reference falls
back to int8 under ``generic``), the xlstm engines with ``kv_dtype``
int8 and fp8 (no pool to quantize: the reference's tokens and page size,
the spec reported), pool bytes per slot, and the launcher.

jamba runs its smoke config cut to 4 layers (attention with a dense
MLP, then three mamba layers, MoE on the second and fourth), xlstm its
smoke config cut to one period (seven mLSTM layers, one sLSTM), both in
float32.  The JAX side runs under ``target("generic")``.
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
from repro.models.registry import build_model
from repro.quant.spec import _SPECS as JAX_SPECS
from repro.serve import Engine, Request, ServeConfig
from repro.serve import paging as jpaging
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.quant import DECODE_TOL, resolve_kv_spec
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

JAMBA, XLSTM = "jamba-1.5-large-398b", "xlstm-1.3b"
LAYERS = {JAMBA: 4, XLSTM: 8}
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
# five prompts over two slots, 12 new tokens each: pages of 4 crossed
# several times per request
PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(5)]
ENGINE = dict(slots=2, cache_len=32, max_new_tokens=12, paged=True)
CACHE_LEN, PAGE = 32, 4

_STATE = {}


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


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(arch):
    """(jax model, jax params, port model, port params), float32."""
    if arch not in _STATE:
        n = LAYERS[arch]
        jcfg = dataclasses.replace(smoke_config(arch, num_layers=n),
                                   dtype="float32")
        pcfg = dataclasses.replace(port_smoke_config(arch, num_layers=n),
                                   dtype="float32")
        model = build_model(jcfg)
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[arch] = (model, params, port_build_model(pcfg),
                        from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[arch]


def _reference(arch, **sc):
    """repro.serve.Engine on PROMPTS: (outputs, page size, preemptions),
    cached (a reference engine takes seconds here)."""
    key = (arch, tuple(sorted(sc.items())))
    if key not in _STATE:
        model, params, _, _ = _models(arch)
        with ctx.target("generic"), warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = Engine(model, params, ServeConfig(**sc))
            reqs = [Request(rid=i, tokens=list(p))
                    for i, p in enumerate(PROMPTS)]
            eng.run_to_completion(reqs)
        assert all(r.done for r in reqs)
        _STATE[key] = ([r.out for r in reqs], eng.page_size, eng.preemptions)
    return _STATE[key]


def _port(arch, audit_every_step=True, **sc):
    _, _, pmodel, pparams = _models(arch)
    eng = PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")
    reqs = [PortRequest(rid=i, tokens=list(p)) for i, p in enumerate(PROMPTS)]
    for r in reqs:
        eng.submit(r)
    for _ in range(1000):
        busy = eng.step()
        if audit_every_step:
            assert eng.audit() == [], eng.step_count
        if not busy and not eng.queue and not eng.requeue:
            break
    assert all(r.done and len(r.out) == 12 for r in reqs)
    return eng, [r.out for r in reqs]


# ----------------------------------------------------------- caches -----

@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_jamba_pools_quantize_and_the_state_stays_dense(kv_dtype):
    """The attention layer's pools take the spec's storage with f32
    scale pools beside them; each mamba layer keeps its dense
    slot-major ``h`` and ``conv`` leaves in the model's dtype, the
    reference's law."""
    model, _, pmodel, pparams = _models(JAMBA)
    eng = PortEngine(pmodel, pparams,
                     PortServeConfig(page_size=PAGE, kv_dtype=kv_dtype,
                                     **ENGINE), device="cpu")
    spec = resolve_kv_spec(kv_dtype, "cpu")
    kinds = pmodel.cfg.layer_kinds()
    assert kinds == ("global", "mamba", "mamba", "mamba")
    with ctx.target("generic"):
        jc = jpaging.init_paged_caches(model, 2, CACHE_LEN, PAGE,
                                       eng.allocator.total_pages,
                                       kv_spec=JAX_SPECS[kv_dtype])
    for c, jl, kind in zip(eng.caches, _jleaves(jc), kinds):
        assert set(c) == set(jl)
        for name, leaf in c.items():
            assert tuple(leaf.shape) == jl[name].shape, name
        if kind == "global":
            assert set(c) == {"kp", "vp", "ks", "vs"}
            assert c["kp"].dtype == c["vp"].dtype == spec.storage
            assert c["ks"].dtype == torch.float32
            assert c["ks"].shape == c["kp"].shape[:2]
        else:
            assert set(c) == {"h", "conv"}
            assert all(v.dtype == torch.float32 for v in c.values())
            assert c["h"].shape[0] == c["conv"].shape[0] == 2


def _prefill_paged(kv_dtype, toks):
    """Both sides' hybrid paged caches holding the reference's prefill of
    ``toks``, quantized per (head, page) on the attention layer, the
    mamba state scattered into slot rows."""
    model, params, pmodel, _ = _models(JAMBA)
    k, s = toks.shape
    t = paging.pages_per_slot(CACHE_LEN, PAGE)
    total = 1 + k * t
    rows = (np.arange(k * t, dtype=np.int32) + 1).reshape(k, t)
    rows[:, paging.pages_per_slot(s + 8, PAGE):] = 0
    slots = np.array([1, 0], np.int32)[:k]
    with ctx.target("generic"):
        _, cache1 = model.prefill(params, jnp.asarray(toks), CACHE_LEN, {})
        jc = jpaging.init_paged_caches(model, 2, CACHE_LEN, PAGE, total,
                                       kv_spec=JAX_SPECS[kv_dtype])
        jc = jpaging.scatter_prefill(jc, cache1, jnp.asarray(slots),
                                     jnp.asarray(rows))
    # the reference's prefill on both sides: the scatter alone is held
    pcache1 = [{n: _t(v) for n, v in c.items()} for c in _jleaves(cache1)]
    kinds = pmodel.cfg.layer_kinds()
    recurrent = {i: PT.recurrent_cache(pmodel.cfg, kind, 2, torch.float32,
                                       "cpu")
                 for i, kind in enumerate(kinds) if kind == "mamba"}
    pc = paging.init_paged_caches(
        len(kinds), 2, 16, total, PAGE, device="cpu", dtype=torch.float32,
        kv_spec=resolve_kv_spec(kv_dtype, "cpu"), recurrent=recurrent)
    paging.scatter_prefill(pc, pcache1, torch.from_numpy(slots).long(),
                           torch.from_numpy(rows))
    return jc, pc, rows, slots


def _jleaves(jc):
    """The reference's per-layer cache dicts of the 4-layer cut (one
    segment: the tail), each leaf with its leading reps axis of 1."""
    return [{n: v[0] for n, v in c.items()} for c in jc[0]]


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_hybrid_quantizing_scatter_matches_reference(kv_dtype):
    """An admitted group's prefill into a hybrid cache: the attention
    pools' bytes and scales on the group's pages, and the mamba layers'
    state in the group's slot rows (here reversed), equal to the
    reference's ``scatter_prefill``."""
    toks = np.random.default_rng(0).integers(0, 256, (2, 11)).astype(
        np.int32)
    jc, pc, rows, _ = _prefill_paged(kv_dtype, toks)
    live = sorted(int(p) for p in rows.ravel() if p)
    for c, jl in zip(pc, _jleaves(jc)):
        if "kp" in c:
            for name in ("kp", "vp"):
                np.testing.assert_array_equal(
                    _bytes(c[name])[:, live], _bytes(_t(jl[name]))[:, live])
            for name in ("ks", "vs"):
                np.testing.assert_array_equal(c[name].numpy()[:, live],
                                              np.asarray(jl[name])[:, live])
        else:
            for name, leaf in c.items():
                np.testing.assert_array_equal(leaf.numpy(), _np(jl[name]))


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_hybrid_quantized_decode_steps_match_reference(kv_dtype):
    """Decode steps over the quantized hybrid cache, past page edges
    (the re-quantizing page write at the attention layer, the mamba
    state updated in its slot rows): the reference's logits and scales
    at every step (the new rows' K/V differ from the reference's in the
    last f32 bits, so a scale may too, by an ulp)."""
    model, params, pmodel, pparams = _models(JAMBA)
    toks = np.random.default_rng(1).integers(0, 256, (2, 7)).astype(
        np.int32)
    jc, pc, rows, slots = _prefill_paged(kv_dtype, toks)
    bt = np.zeros_like(rows)
    bt[slots] = rows                        # slot s holds its group row
    lengths = np.array([7, 7], np.int32)
    cur = np.array([5, 77], np.int32)
    step = jax.jit(lambda *a: model.decode_step(*a[:4], block_tables=a[4]))
    for _ in range(6):
        with ctx.target("generic"):
            logits, jc = step(params, jc, jnp.asarray(cur),
                              jnp.asarray(lengths), jnp.asarray(bt))
        plogits = pmodel.decode_step(pparams, pc, _t(cur), _t(lengths),
                                     block_tables=_t(bt))
        np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
        live = sorted(int(p) for p in bt.ravel() if p)
        jl = _jleaves(jc)[0]
        for name in ("ks", "vs"):
            np.testing.assert_allclose(pc[0][name].numpy()[:, live],
                                       np.asarray(jl[name])[:, live], **TOL)
        cur = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        lengths = lengths + 1


# ----------------------------------------------------------- engines -----

def test_jamba_int8_engine_token_identical_to_reference():
    want, page_size, _ = _reference(JAMBA, kv_dtype="int8", page_size=PAGE,
                                    **ENGINE)
    eng, got = _port(JAMBA, kv_dtype="int8", page_size=PAGE, **ENGINE)
    assert got == want
    assert eng.kv_spec.dtype == "int8" and eng.page_size == page_size
    st = eng.stats()
    assert st["kv_dtype"] == "int8"
    assert st["available"] == st["total_pages"] - 1
    assert eng.caches[0]["kp"].dtype == torch.int8


def test_jamba_int8_preempting_engine_token_identical_to_reference():
    """A pool of 6 usable pages of 4 for two slots growing to 6 pages
    each: requests are preempted and re-prefilled, their attention rows
    re-quantized and their mamba state rewritten, as by the
    reference."""
    sc = dict(kv_dtype="int8", page_size=PAGE, total_pages=7, **ENGINE)
    want, _, preempted = _reference(JAMBA, **sc)
    eng, got = _port(JAMBA, **sc)
    assert got == want
    assert eng.preemptions == preempted > 0


def test_jamba_fp8_engine_completes_within_decode_tol():
    """The reference falls back to int8 under ``generic``, so the fp8
    engine is held to completion and to DECODE_TOL: after admission, a
    decode-attention call over the attention layer's fp8 pools against
    the same call over the float32 engine's pools, same tables; the
    mamba state the same as the float32 engine's bit for bit."""
    _, _, pmodel, pparams = _models(JAMBA)
    engines, reqs = {}, {}
    for kv in ("fp8_e4m3", None):
        eng = PortEngine(pmodel, pparams,
                         PortServeConfig(page_size=PAGE, kv_dtype=kv,
                                         **ENGINE), device="cpu")
        reqs[kv] = [PortRequest(rid=i, tokens=list(p))
                    for i, p in enumerate(PROMPTS)]
        for r in reqs[kv]:
            eng.submit(r)
        eng._admit()
        engines[kv] = eng
    fp8, f32 = engines["fp8_e4m3"], engines[None]
    assert fp8.kv_spec.dtype == "fp8_e4m3"
    assert (fp8.block_tables == f32.block_tables).all()
    q = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 4, 16)).astype(np.float32))
    bt = _t(fp8.block_tables)
    lengths = torch.from_numpy(fp8._len_h.astype(np.int32))
    cq, cf = fp8.caches[0], f32.caches[0]
    got = dec_ops.quant_paged_decode_attention(
        q, cq["kp"], cq["vp"], cq["ks"], cq["vs"], bt, lengths)
    want = dec_ops.paged_decode_attention(q, cf["kp"], cf["vp"], bt, lengths)
    assert float((got - want).abs().max()) <= DECODE_TOL["fp8_e4m3"]
    for cq, cf in zip(fp8.caches[1:], f32.caches[1:]):
        for name in ("h", "conv"):
            assert torch.equal(cq[name], cf[name])
    fp8.run_to_completion([])
    assert all(r.done and len(r.out) == 12 for r in reqs["fp8_e4m3"])
    assert fp8.allocator.in_use == 0 and fp8.audit() == []


@pytest.mark.parametrize("kv_dtype", ["int8", "fp8_e4m3"])
def test_xlstm_quantized_engine_matches_reference(kv_dtype):
    """A model of recurrent layers alone has no pool to quantize: with
    ``kv_dtype`` int8 (the reference's own fp8 request falls back to
    int8 under ``generic``) the engine emits the reference's tokens, at
    the page size the reference resolves for a quantized pool, and its
    bf16 tokens; it reports the spec it was given and holds the state
    in the model's dtype."""
    want, page_size, _ = _reference(XLSTM, kv_dtype="int8", **ENGINE)
    eng, got = _port(XLSTM, kv_dtype=kv_dtype, **ENGINE)
    _, plain = _port(XLSTM, audit_every_step=False, **ENGINE)
    assert got == want == plain
    assert eng.page_size == page_size
    assert eng.stats()["kv_dtype"] == kv_dtype
    assert not any(name in c for c in eng.caches
                   for name in ("kp", "kw", "ks"))
    assert all(v.dtype == torch.float32 for c in eng.caches
               for v in c.values())
    assert paging.paged_bytes_per_slot(eng.caches, eng.allocator.total_pages,
                                       eng.pages_per_slot) == 0


def test_jamba_pool_bytes_per_slot_count_the_attention_layer_alone():
    _, _, pmodel, pparams = _models(JAMBA)
    pmodel = port_build_model(dataclasses.replace(pmodel.cfg,
                                                  dtype="bfloat16"))
    pparams = pmodel.init(torch.Generator().manual_seed(0), device="cpu")
    sizes = {}
    for kv in ("bf16", "int8", "fp8_e4m3"):
        eng = PortEngine(pmodel, pparams,
                         PortServeConfig(page_size=PAGE, kv_dtype=kv,
                                         **ENGINE), device="cpu")
        sizes[kv] = paging.paged_bytes_per_slot(
            eng.caches, eng.allocator.total_pages, eng.pages_per_slot)
    # one attention layer: K and V, one byte an element and an f32 scale
    # a (head, page) against two bytes an element; the mamba state is
    # not paged
    cfg, pages = pmodel.cfg, eng.pages_per_slot
    elems = 2 * cfg.num_kv_heads * PAGE * cfg.head_dim
    assert sizes["bf16"] == pages * 2 * elems
    assert sizes["int8"] == sizes["fp8_e4m3"] == \
        pages * (elems + 2 * cfg.num_kv_heads * 4)


# ---------------------------------------------------------- launcher -----

@pytest.mark.parametrize("arch", [JAMBA, XLSTM])
def test_launcher_serves_hybrid_models_from_int8_pools(capsys, arch):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", arch, "--smoke", "--layers",
                       str(LAYERS[arch]), "--prompts", "3", "--prompt-len",
                       "6", "--max-new", "4", "--paged", "--page-size", "4",
                       "--kv-dtype", "int8", "--device", "cpu"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"kv_dtype": "int8"' in out
