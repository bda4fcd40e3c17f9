"""arctic-480b through the port: GQA attention with 128 experts top-2
and an always-on dense residual MLP on every layer, against ``repro``
on the CPU.

The config field for field, its segmentation (one MoE layer repeated)
and the ``convert`` tree (every layer's ``moe`` leaf with the router,
the stacked expert weights and the dense residual MLP); the decode
kernels' plain versions at a GQA group of 7 (the full model's 56 query
heads over 8 KV heads); prefill and one decode step at the smoke
config's 4 query heads over 2 and at 14 over 2 (group 7); the paged
engine at group 7 token-identical to ``repro.serve.Engine`` (float32,
page crossings) and the dense engine to the paged one; and the launcher serving ``--arch
arctic-480b --smoke`` on the CPU.  The JAX side runs under
``target("generic")``.
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
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import ref as jflash_ref
from repro.models import transformer as JT
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import ref as dec_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "arctic-480b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
#: query / KV heads: the smoke config's, and arctic's group of 7
HEADS = {"4/2": (4, 2), "14/2": (14, 2)}

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _jit(fn, **static):
    """``fn`` with ``static`` bound, compiled whole (cheaper than its
    small ops dispatched one by one)."""
    return jax.jit(lambda *args: fn(*args, **static))


def _models(heads="4/2"):
    """(jax model, jax params, port model, port params), float32, at
    ``HEADS[heads]``."""
    if heads not in _STATE:
        h, hkv = HEADS[heads]
        cfgs = [dataclasses.replace(c, dtype="float32", num_heads=h,
                                    num_kv_heads=hkv)
                for c in (smoke_config(ARCH), port_smoke_config(ARCH))]
        model = build_model(cfgs[0])
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[heads] = (model, params, port_build_model(cfgs[1]),
                         from_jax_params(tree, cfgs[1], device="cpu"))
    return _STATE[heads]


# ----------------------------------------------------------- config -----

def test_config_matches_reference_field_for_field():
    for want, got in ((get_config(ARCH), port_configs.get_config(ARCH)),
                      (smoke_config(ARCH), port_smoke_config(ARCH))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    cfg = port_configs.get_config(ARCH)
    assert ARCH not in port_configs.LATER_SLICES
    assert cfg.num_heads // cfg.num_kv_heads == 7
    assert cfg.moe_layers == "all" and cfg.moe.dense_residual
    assert all(cfg.is_moe_layer(i) for i in range(cfg.num_layers))


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_segments_match_reference(which):
    """One MoE global layer repeated: 35 times at full size, twice at
    smoke size, as the reference segments it."""
    jcfg = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    pcfg = port_configs.get_config(ARCH) if which == "full" \
        else port_smoke_config(ARCH)
    got = [(p.block, p.reps) for p in PT.plan_segments(pcfg)]
    want = [(p.block, p.reps) for p in JT.plan_segments(jcfg)]
    assert got == want == [((("global", True),), pcfg.num_layers)]
    assert PT.kv_dims(pcfg) == (pcfg.num_kv_heads, pcfg.head_dim,
                                pcfg.head_dim)


def test_convert_carries_the_arctic_tree():
    """Every layer's ``moe`` leaf: the f32 router, the stacked expert
    weights and the dense residual MLP, at the reference's values; no
    ``mlp`` leaf and no shared experts."""
    _, params, _, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    seg = tree["segments"][0][0]
    for r, layer in enumerate(pparams["layers"]):
        assert "mlp" not in layer and "shared" not in layer["moe"]
        moe = layer["moe"]
        assert moe["router"].dtype == torch.float32
        assert moe["we_gate"].shape == (8, 64, 64)
        for name in ("router", "we_gate", "we_up", "we_down"):
            np.testing.assert_array_equal(moe[name].numpy(),
                                          seg["moe"][name][r])
        for name in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(moe["dense"][name].numpy(),
                                          seg["moe"]["dense"][name][r])
        assert moe["dense"]["w_up"].shape == (64, 128)


# ---------------------------------------- the kernels at group 7 -----

@pytest.mark.parametrize("window,softcap", [(None, None), (5, 20.0)])
def test_decode_plain_at_group_7_dense_and_paged(window, softcap):
    """B3's and B4's plain versions at 14 query heads over 2 KV heads,
    unsplit and split (``chunk=``), against the reference's."""
    b, hq, hkv, s, ps, d = 3, 14, 2, 16, 4, 32
    q = _rand((b, hq, d), 0)
    kc, vc = _rand((b, hkv, s, d), 1), _rand((b, hkv, s, d), 2)
    ln = np.array([1, 9, 16], np.int32)
    kw = dict(window=window, softcap=softcap)
    with ctx.target("generic"):
        want = _jit(jdec_ref.decode_attention_ref, return_residuals=True,
                    **kw)(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                          jnp.asarray(ln))
    got = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(ln),
                                   return_residuals=True, **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **dec_ops.TOL)
    t = s // ps
    rows = (np.random.default_rng(0).permutation(b * t) + 1).reshape(
        b, t).astype(np.int32)
    kp = np.zeros((hkv, 1 + b * t, ps, d), np.float32)
    vp = np.zeros((hkv, 1 + b * t, ps, d), np.float32)
    kp[:, rows] = kc.reshape(b, hkv, t, ps, d).transpose(1, 0, 2, 3, 4)
    vp[:, rows] = vc.reshape(b, hkv, t, ps, d).transpose(1, 0, 2, 3, 4)
    for chunk in (None, 8):
        paged = dec_ref.paged_decode_attention_ref(
            _t(q), _t(kp), _t(vp), _t(rows), _t(ln), return_residuals=True,
            chunk=chunk, **kw)
        for g, w in zip(paged, want):
            np.testing.assert_allclose(g.numpy(), _np(w), **dec_ops.TOL)


def test_flash_plain_at_group_7():
    q = _rand((2, 14, 13, 16), 3)
    k, v = _rand((2, 2, 13, 16), 4), _rand((2, 2, 13, 16), 5)
    want = _jit(jflash_ref.flash_attention_ref, causal=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(got.numpy(), _np(want), **fa_ops.TOL)


# ------------------------------------------------------------ model -----

@pytest.mark.parametrize("heads", list(HEADS))
def test_prefill_and_decode_step_match_reference(heads):
    """Prefill logits and K/V caches, then one dense and one paged
    decode step, against the reference's."""
    model, params, pmodel, pparams = _models(heads)
    hkv = HEADS[heads][1]
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), 16, {})
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), 16)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    assert [c["k"].shape for c in pcaches] == [(2, hkv, 16, 16)] * 2
    for i, c in enumerate(pcaches):
        np.testing.assert_allclose(c["k"].numpy(),
                                   _np(caches[0][0]["k"][i]), **TOL)
        np.testing.assert_allclose(c["v"].numpy(),
                                   _np(caches[0][0]["v"][i]), **TOL)
    cur = np.array([3, 250], np.int32)
    lengths = np.array([9, 7], np.int32)
    with ctx.target("generic"):
        want, _ = model.decode_step(params, caches, jnp.asarray(cur),
                                    jnp.asarray(lengths))
    rows = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    pools = paging.init_paged_caches(2, hkv, 16, 9, 4, device="cpu",
                                     dtype=torch.float32)
    paging.scatter_prefill(pools, pcaches, torch.arange(2), rows)
    dense = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
    paged = pmodel.decode_step(pparams, pools, _t(cur), _t(lengths),
                               block_tables=rows)
    np.testing.assert_allclose(dense.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(paged.numpy(), _np(want), **TOL)


# ----------------------------------------------------------- engine -----

_PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(4)]


def _port_engine_run(paged):
    _, _, pmodel, pparams = _models("14/2")
    peng = PortEngine(pmodel, pparams, PortServeConfig(**_sc(paged)),
                      device="cpu")
    preqs = [PortRequest(rid=i, tokens=list(p))
             for i, p in enumerate(_PROMPTS)]
    peng.run_to_completion(preqs)
    assert all(r.done and len(r.out) == 10 for r in preqs)
    assert peng.audit() == []
    return [r.out for r in preqs]


def _sc(paged):
    return dict(slots=2, cache_len=32, max_new_tokens=10, paged=paged,
                page_size=4)


def test_paged_engine_at_group_7_token_identical_to_reference():
    """Four requests over two slots, 10 new tokens each, at 14 query
    heads over 2: pages of 4 crossed several times per request."""
    model, params, _, _ = _models("14/2")
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = Engine(model, params, ServeConfig(**_sc(True)))
        jreqs = [Request(rid=i, tokens=list(p)) for i, p in
                 enumerate(_PROMPTS)]
        jeng.run_to_completion(jreqs)
    assert _port_engine_run(True) == [r.out for r in jreqs]


def test_dense_engine_at_group_7_token_identical_to_paged():
    """The dense engine's tokens are the paged engine's (float32, the
    same plain versions over a cache laid out otherwise), so by the
    test above the reference's too."""
    assert _port_engine_run(False) == _port_engine_run(True)


@pytest.mark.parametrize("layers", [[], ["--layers", "1"]],
                         ids=["smoke", "cut"])
def test_launcher_serves_arctic_on_cpu(capsys, layers):
    """At smoke size, and cut to its first layer as the card serves the
    full width cut to 2 (``--layers``)."""
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--smoke", "--prompts", "3",
                       "--prompt-len", "6", "--max-new", "4", "--paged",
                       "--page-size", "4", "--device", "cpu"] + layers)
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"moe_dropped"' in out
