"""The port's model against ``repro``'s on the same converted weights:
prefill logits and caches, and one decode step over a dense cache and
over paged pools, in float32 (tight) and bfloat16 (loose: XLA and torch
round bf16 products at other places).

The JAX side runs under ``target("generic")``; the port on the CPU,
through the plain PyTorch versions of its kernels.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models.registry import build_model
from repro.serve import paging
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import paging as port_paging

# float32: both sides compute the same f32 graph in another summation
# order.  bfloat16: every matmul output rounds to 8 bits of mantissa,
# at other places in XLA-CPU and torch-CPU; logits are O(1).
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=6e-2, rtol=6e-2)}
B, S, CACHE_LEN, PAGE = 2, 7, 16, 4

_STATE = {}


def _models(dtype):
    if dtype not in _STATE:
        cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=2),
                                  dtype=dtype)
        model = build_model(cfg)
        params = model.init(jax.random.PRNGKey(0))
        pcfg = dataclasses.replace(
            port_smoke_config("granite-8b", num_layers=2), dtype=dtype)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[dtype] = (model, params, port_build_model(pcfg),
                         from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[dtype]


def _tokens(b=B, s=S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), _np(want), **TOL[dtype])


def _prefill_both(dtype, toks):
    model, params, pmodel, pparams = _models(dtype)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), CACHE_LEN,
                                       {})
    plogits, pcaches = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                      CACHE_LEN)
    return (logits, caches), (plogits, pcaches)


def test_config_matches_reference():
    """The port's config copy keeps every field of the reference's (the
    MoE and MLA sub-configs field by field), at full and smoke size;
    whisper-base's too (its encoder, audio frontend and ungated GELU)."""
    ds, wb = "deepseek-v2-lite-16b", "whisper-base"
    for want, got in ((get_config("granite-8b"),
                       port_configs.get_config("granite-8b")),
                      (smoke_config("granite-8b", num_layers=2),
                       port_smoke_config("granite-8b", num_layers=2)),
                      (get_config(ds), port_configs.get_config(ds)),
                      (smoke_config(ds), port_smoke_config(ds)),
                      (get_config(wb), port_configs.get_config(wb)),
                      (smoke_config(wb), port_smoke_config(wb))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    whisper = port_configs.get_config(wb)
    assert whisper.encoder_layers == 6 and whisper.frontend == "audio"
    assert whisper.mlp_activation == "gelu_ungated"
    assert port_smoke_config(wb).encoder_layers == 2
    with pytest.raises(KeyError):
        port_configs.get_config("no-such-arch")


def test_unported_layer_kinds_raise():
    cfg = port_smoke_config("granite-8b", num_layers=2)
    for change in (dict(encoder_layers=-1), dict(frontend="video"),
                   dict(layer_pattern=("mlstm", "global")),
                   dict(mlp_activation="relu"),
                   dict(dtype="float16")):
        with pytest.raises(NotImplementedError):
            port_build_model(dataclasses.replace(cfg, **change))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_logits_and_caches_match(dtype):
    (logits, caches), (plogits, pcaches) = _prefill_both(dtype, _tokens())
    _close(plogits, logits, dtype)
    assert len(pcaches) == 2
    for i, c in enumerate(pcaches):
        assert c["k"].shape == (B, 2, CACHE_LEN, 16)
        _close(c["k"], caches[0][0]["k"][i], dtype)
        _close(c["v"], caches[0][0]["v"][i], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_decode_step_matches(dtype):
    model, params, pmodel, pparams = _models(dtype)
    toks = _tokens()
    (_, caches), (_, pcaches) = _prefill_both(dtype, toks)
    cur = np.array([3, 250], np.int32)
    lengths = np.array([S, S - 2], np.int32)      # ragged: row 1 rewinds
    with ctx.target("generic"):
        logits, new = model.decode_step(params, caches, jnp.asarray(cur),
                                        jnp.asarray(lengths))
    plogits = pmodel.decode_step(pparams, pcaches, torch.from_numpy(cur),
                                 torch.from_numpy(lengths))
    _close(plogits, logits, dtype)
    for i, c in enumerate(pcaches):               # written in place
        _close(c["k"], new[0][0]["k"][i], dtype)
        _close(c["v"], new[0][0]["v"][i], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_decode_step_matches(dtype):
    """Scatter the same prefill into scrambled pages on both sides, then
    decode one token through the block tables, crossing into a fresh
    page for row 0 (length 8 = 2 full pages of 4)."""
    model, params, pmodel, pparams = _models(dtype)
    toks = _tokens(s=8)
    model_cfg = model.cfg
    with ctx.target("generic"):
        _, cache1 = model.prefill(params, jnp.asarray(toks), CACHE_LEN, {})
    _, pcache1 = pmodel.prefill(pparams, torch.from_numpy(toks).long(),
                                CACHE_LEN)
    t = CACHE_LEN // PAGE
    total = 1 + B * t
    perm = np.random.default_rng(1).permutation(np.arange(1, total))
    rows = perm.reshape(B, t).astype(np.int32)
    rows[1, 3] = paging.NULL_PAGE                 # an unallocated tail
    jc = paging.init_paged_caches(model, B, CACHE_LEN, PAGE, total)
    with ctx.target("generic"):
        jc = paging.scatter_prefill(jc, cache1, jnp.arange(B),
                                    jnp.asarray(rows))
    pc = port_paging.init_paged_caches(
        model_cfg.num_layers, model_cfg.num_kv_heads, model_cfg.head_dim,
        total, PAGE, device="cpu", dtype=pcache1[0]["k"].dtype)
    port_paging.scatter_prefill(pc, pcache1, torch.arange(B),
                                torch.from_numpy(rows))
    for i, c in enumerate(pc):
        _close(c["kp"], jc[0][0]["kp"][i], dtype)

    cur = np.array([17, 4], np.int32)
    lengths = np.array([8, 6], np.int32)
    with ctx.target("generic"):
        logits, new = model.decode_step(
            params, jc, jnp.asarray(cur), jnp.asarray(lengths),
            block_tables=jnp.asarray(rows))
    plogits = pmodel.decode_step(pparams, pc, torch.from_numpy(cur),
                                 torch.from_numpy(lengths),
                                 block_tables=torch.from_numpy(rows))
    _close(plogits, logits, dtype)
    for i, c in enumerate(pc):
        live = sorted(set(rows.ravel()) - {paging.NULL_PAGE})
        _close(c["kp"][:, live], new[0][0]["kp"][i][:, np.array(live)],
               dtype)
        _close(c["vp"][:, live], new[0][0]["vp"][i][:, np.array(live)],
               dtype)


def test_dense_and_paged_decode_agree_in_the_port():
    """Paging is invisible: the same step over a dense cache and over
    pages holding the same rows gives the same logits, bit for bit."""
    _, _, pmodel, pparams = _models("float32")
    cfg = pmodel.cfg
    toks = torch.from_numpy(_tokens(s=5)).long()
    _, dense = pmodel.prefill(pparams, toks, CACHE_LEN)
    _, once = pmodel.prefill(pparams, toks, CACHE_LEN)
    rows = torch.arange(1, 1 + B * (CACHE_LEN // PAGE),
                        dtype=torch.int32).reshape(B, -1)
    pools = port_paging.init_paged_caches(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 1 + rows.numel(),
        PAGE, device="cpu", dtype=torch.float32)
    port_paging.scatter_prefill(pools, once, torch.arange(B), rows)
    cur, lengths = torch.tensor([1, 2]), torch.tensor([5, 5],
                                                      dtype=torch.int32)
    a = pmodel.decode_step(pparams, dense, cur, lengths)
    b = pmodel.decode_step(pparams, pools, cur, lengths, block_tables=rows)
    torch.testing.assert_close(a, b, atol=0, rtol=0)


def test_prefill_decode_consistency_dense():
    """Port of tests/test_arch_smoke.py::test_prefill_decode_consistency_
    dense against the port itself: decoding token 7 over a 7-token
    prefill reproduces the 8-token prefill's logits (bf16, the smoke
    model's own dtype, with the reference test's tolerance)."""
    cfg = port_smoke_config("granite-8b")
    model = port_build_model(cfg)
    params = model.init(torch.Generator().manual_seed(3), device="cpu")
    toks = torch.from_numpy(_tokens(1, 8, seed=3)).long()
    logits_full, _ = model.prefill(params, toks, 16)
    _, caches = model.prefill(params, toks[:, :7], 16)
    logits_dec = model.decode_step(params, caches, toks[:, 7],
                                   torch.tensor([7], dtype=torch.int32))
    torch.testing.assert_close(logits_dec, logits_full, atol=2e-2, rtol=2e-2)


def test_forward_logits_last_position_is_prefill():
    _, _, pmodel, pparams = _models("float32")
    toks = torch.from_numpy(_tokens()).long()
    full = pmodel.forward_logits(pparams, toks)
    last, _ = pmodel.prefill(pparams, toks, CACHE_LEN)
    assert full.shape == (B, S, 256)
    torch.testing.assert_close(full[:, -1], last, atol=1e-5, rtol=1e-5)
    plain = pmodel.forward_logits(pparams, toks, plain=True)
    torch.testing.assert_close(plain, full, atol=0, rtol=0)


def test_logits_rounded_to_bf16_equal_the_reference():
    """The documented deviation of ``L.unembed``: in bf16 the reference
    rounds the logits to bf16, the port keeps the f32 sums of the same
    bf16 operands.  On the same hidden states the port's logits, rounded
    to bf16, are the reference's bit for bit (at d_model 64; at widths
    of thousands an f32 sum near a rounding boundary can land one bf16
    step apart), and unrounded they differ by up to half a step."""
    from repro.models import transformer as JT
    model, params, pmodel, pparams = _models("bfloat16")
    x = np.random.default_rng(0).standard_normal((B, S, 64)).astype(
        np.float32)
    with ctx.target("generic"):
        want = _np(JT._logits(params, jnp.asarray(x, jnp.bfloat16),
                              model.cfg))
    got = PT._logits(pparams, torch.from_numpy(x).bfloat16(), pmodel.cfg)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.bfloat16().float().numpy(), want)
    assert float(np.abs(got.numpy() - want).max()) > 0


def test_init_draws_the_reference_laws():
    """Model.init: normal / sqrt(fan_in) weights, norms at 0, on the
    generator's device, in the compute dtype, reproducible by seed."""
    cfg = dataclasses.replace(port_smoke_config("granite-8b", num_layers=2),
                              d_model=256, d_ff=512)
    model = port_build_model(cfg)
    p = model.init(torch.Generator().manual_seed(0), device="cpu")
    again = model.init(torch.Generator().manual_seed(0), device="cpu")
    torch.testing.assert_close(p["embed"], again["embed"], atol=0, rtol=0)
    assert p["embed"].dtype == torch.bfloat16
    assert p["embed"].shape == (256, 256) and p["unembed"].shape == (256, 256)
    layer = p["layers"][1]
    for w, fan_in in ((layer["attn"]["wq"], 256), (layer["attn"]["wo"], 64),
                      (layer["mlp"]["w_gate"], 256),
                      (layer["mlp"]["w_down"], 512)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.05
    assert not layer["ln1"].any() and not p["final_norm"].any()


def test_convert_rejects_a_tree_of_another_depth():
    model, params, pmodel, _ = _models("float32")
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a)[:1], params)
    with pytest.raises(ValueError, match="layers"):
        from_jax_params(tree, pmodel.cfg, device="cpu")


def test_plan_segments_is_one_repeated_global_layer():
    cfg = port_smoke_config("granite-8b", num_layers=2)
    (plan,) = PT.plan_segments(cfg)
    assert plan.block == (("global", False),) and plan.reps == 2


def test_kernel_operands_are_dense_along_the_serving_path(monkeypatch):
    """The CUDA kernels take raw pointers and refuse strided operands;
    on the CPU the same call sites reach the plain versions, so check
    there that every operand the serving path hands a kernel slot is
    contiguous (prefill, dense and paged decode)."""
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops

    seen, depth = [], []

    def dense(mod, name):
        real = getattr(mod._ref, name)

        def wrapped(*args, **kw):
            if not depth:                   # a plain version's own calls
                tensors = [a for a in args if isinstance(a, torch.Tensor)]
                assert all(t.is_contiguous() for t in tensors), name
                seen.append(name)
            depth.append(1)
            try:
                return real(*args, **kw)
            finally:
                depth.pop()
        monkeypatch.setattr(mod._ref, name, wrapped)

    dense(rms_ops, "rmsnorm_ref")
    dense(fa_ops, "flash_attention_ref")
    dense(dec_ops, "decode_attention_ref")
    dense(dec_ops, "paged_decode_attention_ref")
    _, _, pmodel, pparams = _models("float32")
    cfg = pmodel.cfg
    toks = torch.from_numpy(_tokens()).long()
    _, caches = pmodel.prefill(pparams, toks, CACHE_LEN)
    lengths = torch.tensor([S, S], dtype=torch.int32)
    pmodel.decode_step(pparams, caches, toks[:, 0], lengths)
    rows = torch.arange(1, 1 + B * (CACHE_LEN // PAGE),
                        dtype=torch.int32).reshape(B, -1)
    pools = port_paging.init_paged_caches(
        cfg.num_layers, cfg.num_kv_heads, cfg.head_dim, 1 + rows.numel(),
        PAGE, device="cpu", dtype=torch.float32)
    pmodel.decode_step(pparams, pools, toks[:, 0], lengths,
                       block_tables=rows)
    assert set(seen) == {"rmsnorm_ref", "flash_attention_ref",
                         "decode_attention_ref", "paged_decode_attention_ref"}
