"""deepseek-v2-lite-16b through the port: MLA attention, the Dk != Dv
plain versions of the attention kernels, the MoE/MLA model and the
serving engine, against ``repro`` on the CPU.

MLA's prefill and one-token decode (dense cache and paged pools) on
the reference's weights; flash prefill and dense/paged decode at Dk 24
/ Dv 16 against the reference's plain versions; the paged and the dense
engine token-identical to ``repro.serve.Engine`` in float32 on
``smoke_config("deepseek-v2-lite-16b")`` (a dense first layer, then
two MoE layers of 8 experts, top 2, with 2 shared experts), with page
crossings, preemption, and a run whose prefill drops assignments.  The
JAX side runs under ``target("generic")``.
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
from repro.kernels.decode_attention import ref as jdec_ref
from repro.kernels.flash_attention import ref as jflash_ref
from repro.models import attention as jattn
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.kernels.decode_attention import decode_attention as dec_kern
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.kernels.decode_attention import paged as paged_kern
from repro_torch.kernels.flash_attention import flash_attention as fa_kern
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as pattn
from repro_torch.models import layers as L
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import paging as port_paging
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "deepseek-v2-lite-16b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _models(cf=None):
    """(jax model, jax params, port model, port params), float32; ``cf``
    overrides the MoE capacity factor on both sides."""
    if cf not in _STATE:
        cfgs = []
        for c in (smoke_config(ARCH), port_smoke_config(ARCH)):
            c = dataclasses.replace(c, dtype="float32")
            if cf is not None:
                c = dataclasses.replace(
                    c, moe=dataclasses.replace(c.moe, capacity_factor=cf))
            cfgs.append(c)
        model = build_model(cfgs[0])
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[cf] = (model, params, port_build_model(cfgs[1]),
                      from_jax_params(tree, cfgs[1], device="cpu"))
    return _STATE[cf]


# ----------------------------------------------------------- config -----

def test_config_and_segments_match_reference():
    for want, got in ((get_config(ARCH), port_configs.get_config(ARCH)),
                      (smoke_config(ARCH), port_smoke_config(ARCH))):
        for f in dataclasses.fields(got):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, f.name
    full = PT.plan_segments(port_configs.get_config(ARCH))
    assert [(p.block, p.reps) for p in full] == [
        ((("global", False),), 1), ((("global", True),), 26)]
    assert PT.kv_dims(port_configs.get_config(ARCH)) == (16, 192, 128)


# ---------------------------------------------- Dk != Dv plain versions --

def test_flash_plain_at_dk_24_dv_16():
    q, k, v = _rand((2, 4, 19, 24), 0), _rand((2, 4, 19, 24), 1), \
        _rand((2, 4, 19, 16), 2)
    want = jflash_ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v), causal=True,
                                          scale=0.3)
    got = fa_ops.flash_attention(_t(q), _t(k), _t(v), scale=0.3)
    assert got.shape == (2, 4, 19, 16)
    np.testing.assert_allclose(got.numpy(), _np(want), **fa_ops.TOL)


def test_decode_plain_at_dk_24_dv_16_dense_and_paged():
    b, h, s, ps = 3, 4, 12, 4
    q = _rand((b, h, 24), 0)
    kc, vc = _rand((b, h, s, 24), 1), _rand((b, h, s, 16), 2)
    ln = np.array([0, 5, 12], np.int32)
    want = jdec_ref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(ln),
        scale=0.2, return_residuals=True)
    got = dec_ops.decode_attention(_t(q), _t(kc), _t(vc), _t(ln), scale=0.2,
                                   return_residuals=True)
    assert got[0].shape == (b, h, 16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **dec_ops.TOL)
    t = s // ps
    rows = (np.random.default_rng(0).permutation(b * t) + 1).reshape(b, t)
    rows = rows.astype(np.int32)
    kp = np.zeros((h, 1 + b * t, ps, 24), np.float32)
    vp = np.zeros((h, 1 + b * t, ps, 16), np.float32)
    kp[:, rows] = kc.reshape(b, h, t, ps, 24).transpose(1, 0, 2, 3, 4)
    vp[:, rows] = vc.reshape(b, h, t, ps, 16).transpose(1, 0, 2, 3, 4)
    paged = dec_ops.paged_decode_attention(
        _t(q), _t(kp), _t(vp), _t(rows), _t(ln), scale=0.2,
        return_residuals=True)
    for g, w in zip(paged, want):
        np.testing.assert_allclose(g.numpy(), _np(w), **dec_ops.TOL)


def test_kernel_launchers_take_the_mla_pair_and_refuse_others():
    ln = torch.zeros(2, dtype=torch.int32)
    # (192, 128) passes the shape checks and reaches the device check
    with pytest.raises(ValueError, match="CUDA"):
        dec_kern.decode_attention_fwd(
            torch.zeros(2, 4, 192), torch.zeros(2, 4, 8, 192),
            torch.zeros(2, 4, 8, 128), ln, window=None, softcap=None,
            scale=None, block_kv=64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_kern.paged_decode_attention_fwd(
            torch.zeros(2, 4, 192), torch.zeros(4, 3, 16, 192),
            torch.zeros(4, 3, 16, 128), torch.ones(2, 2, dtype=torch.int32),
            ln, window=None, softcap=None, scale=None, page_size=None,
            block_kv=64)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kern.flash_attention_fwd(
            torch.zeros(1, 2, 8, 192), torch.zeros(1, 2, 8, 192),
            torch.zeros(1, 2, 8, 128), causal=True, window=None,
            softcap=None, scale=None, q_offset=0)
    with pytest.raises(NotImplementedError, match=r"\(192, 64\)"):
        dec_kern.decode_attention_fwd(
            torch.zeros(2, 4, 192), torch.zeros(2, 4, 8, 192),
            torch.zeros(2, 4, 8, 64), ln, window=None, softcap=None,
            scale=None, block_kv=64)
    with pytest.raises(NotImplementedError, match="head dims"):
        fa_kern.flash_attention_fwd(
            torch.zeros(1, 2, 8, 128), torch.zeros(1, 2, 8, 128),
            torch.zeros(1, 2, 8, 64), causal=True, window=None,
            softcap=None, scale=None, q_offset=0)
    # without mla=True a launcher's check takes equal widths only
    with pytest.raises(NotImplementedError, match="equal key and value"):
        dec_kern.check_decode_operands(
            "quant_paged_decode_attention", torch.zeros(2, 4, 192),
            torch.zeros(4, 3, 16, 192, dtype=torch.int8),
            torch.zeros(4, 3, 16, 128, dtype=torch.int8), ln,
            quantized=True)
    assert dec_kern.KERNEL.launches == 0 and fa_kern.KERNEL.launches == 0


# -------------------------------------------------------------- MLA -----

def _mla_params(jcfg):
    jp = jattn.init_mla(jax.random.PRNGKey(1), jcfg)
    d, lora = jcfg.d_model, jcfg.mla.kv_lora_rank
    shapes = {"wq_mla": (d, -1), "wkv_a": None, "wkv_b": (lora, -1),
              "wo_mla": (-1, d)}
    pp = {}
    for name, shape in shapes.items():
        a = np.array(jp[name], np.float32)
        pp[name] = torch.from_numpy(a if shape is None else a.reshape(shape))
    return jp, pp


def _cfgs():
    return (dataclasses.replace(smoke_config(ARCH), dtype="float32"),
            dataclasses.replace(port_smoke_config(ARCH), dtype="float32"))


def test_apply_mla_matches_reference():
    jcfg, pcfg = _cfgs()
    jp, pp = _mla_params(jcfg)
    x = _rand((2, 11, jcfg.d_model), 0)
    with ctx.target("generic"):
        y, k, v = jattn.apply_mla(jp, jnp.asarray(x), jcfg, return_kv=True)
    rope = L.rope_cache(torch.arange(11), pcfg.mla.qk_rope_head_dim,
                        pcfg.rope_theta)
    py, pk, pv = pattn.apply_mla(pp, _t(x), pcfg, rope)
    assert pk.shape == (2, 4, 11, 24) and pv.shape == (2, 4, 11, 16)
    for g, w in ((py, y), (pk, k), (pv, v)):
        np.testing.assert_allclose(g.numpy(), _np(w), **TOL)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_mla_matches_reference(paged):
    """One token per slot written into a cache holding 6 (slot 0) and 3
    (slot 1) tokens, then attended; paged pools through scrambled
    tables of pages of 4, slot 0 crossing into its second page."""
    jcfg, pcfg = _cfgs()
    jp, pp = _mla_params(jcfg)
    b, h, s, ps = 2, 4, 12, 4
    x = _rand((b, 1, jcfg.d_model), 0)
    kc, vc = _rand((b, h, s, 24), 1), _rand((b, h, s, 16), 2)
    ln = np.array([6, 3], np.int32)
    rows = bt = None
    if paged:
        t = s // ps
        rows = (np.random.default_rng(0).permutation(b * t) + 1).reshape(
            b, t).astype(np.int32)
        kc = _rand((h, 1 + b * t, ps, 24), 3)
        vc = _rand((h, 1 + b * t, ps, 16), 4)
        bt = jnp.asarray(rows)
    with ctx.target("generic"):
        y, ck, cv = jattn.decode_mla(jp, jnp.asarray(x), jnp.asarray(kc),
                                     jnp.asarray(vc), jnp.asarray(ln), jcfg,
                                     block_tables=bt)
    cos, sin = L.rope_cache(_t(ln), pcfg.mla.qk_rope_head_dim,
                            pcfg.rope_theta)
    pk, pv = _t(kc), _t(vc)
    py = pattn.decode_mla(pp, _t(x), pk, pv, _t(ln), pcfg,
                          (cos[:, None], sin[:, None]),
                          block_tables=None if rows is None else _t(rows))
    np.testing.assert_allclose(py.numpy(), _np(y), **TOL)
    np.testing.assert_allclose(pk.numpy(), _np(ck), **TOL)   # in place
    np.testing.assert_allclose(pv.numpy(), _np(cv), **TOL)


def test_prefill_then_decode_is_the_longer_prefill():
    """Decoding token 7 over a 7-token prefill reproduces the 8-token
    prefill's logits (float32), dense and paged, at a capacity no call
    can overflow (which assignments drop depends on each call's token
    count, so with drops the two computations differ by design)."""
    _, _, pmodel, pparams = _models(cf=16.0)
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (2, 8))).long()
    full, _ = pmodel.prefill(pparams, toks, 16)
    _, caches = pmodel.prefill(pparams, toks[:, :7], 16)
    lengths = torch.tensor([7, 7], dtype=torch.int32)
    rows = torch.arange(1, 9, dtype=torch.int32).reshape(2, 4)
    h, dk, dv = PT.kv_dims(pmodel.cfg)
    pools = port_paging.init_paged_caches(
        pmodel.cfg.num_layers, h, dk, 9, 4, device="cpu",
        dtype=torch.float32, v_head_dim=dv)
    port_paging.scatter_prefill(pools, caches, torch.arange(2), rows)
    dense = pmodel.decode_step(pparams, caches, toks[:, 7], lengths)
    pg = pmodel.decode_step(pparams, pools, toks[:, 7], lengths,
                            block_tables=rows)
    torch.testing.assert_close(dense, full, **TOL)
    torch.testing.assert_close(pg, dense, atol=0, rtol=0)
    plain = pmodel.decode_step(pparams, caches, toks[:, 7], lengths,
                               plain=True)
    torch.testing.assert_close(plain, full, **TOL)


def test_prefill_and_decode_step_match_reference():
    model, params, pmodel, pparams = _models()
    toks = np.random.default_rng(1).integers(0, 256, (2, 9)).astype(np.int32)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), 16, {})
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), 16)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    assert [c["k"].shape[-1] for c in pcaches] == [24] * 3
    assert [c["v"].shape[-1] for c in pcaches] == [16] * 3
    np.testing.assert_allclose(pcaches[0]["k"].numpy(),
                               _np(caches[0][0]["k"][0]), **TOL)
    np.testing.assert_allclose(pcaches[2]["v"].numpy(),
                               _np(caches[1][0]["v"][1]), **TOL)
    cur = np.array([3, 250], np.int32)
    lengths = np.array([9, 7], np.int32)
    with ctx.target("generic"):
        logits, _ = model.decode_step(params, caches, jnp.asarray(cur),
                                      jnp.asarray(lengths))
    plogits = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)


def test_convert_carries_the_moe_and_mla_tree():
    model, params, pmodel, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    layers = pparams["layers"]
    assert "mlp" in layers[0] and "moe" not in layers[0]
    assert all("moe" in p and "mlp" not in p for p in layers[1:])
    seg = tree["segments"][1][0]
    moe = layers[2]["moe"]
    assert moe["router"].dtype == torch.float32
    np.testing.assert_array_equal(moe["we_down"].numpy(),
                                  seg["moe"]["we_down"][1])
    np.testing.assert_array_equal(moe["shared"]["w_up"].numpy(),
                                  seg["moe"]["shared"]["w_up"][1])
    np.testing.assert_array_equal(
        layers[1]["attn"]["wkv_b"].numpy(),
        seg["attn"]["wkv_b"][0].reshape(32, -1))
    assert layers[0]["attn"]["wq_mla"].shape == (64, 4 * 24)
    assert layers[0]["attn"]["wo_mla"].shape == (4 * 16, 64)


# ----------------------------------------------------------- engine -----

def _serve_both(prompts, cf=None, **sc):
    model, params, pmodel, pparams = _models(cf)
    with ctx.target("generic"):
        jeng = Engine(model, params, ServeConfig(**sc))
        jreqs = [Request(rid=i, tokens=list(p)) for i, p in enumerate(prompts)]
        jeng.run_to_completion(jreqs)
    peng = PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")
    preqs = [PortRequest(rid=i, tokens=list(p))
             for i, p in enumerate(prompts)]
    peng.run_to_completion(preqs)
    assert all(r.done for r in preqs)
    assert [r.out for r in preqs] == [r.out for r in jreqs]
    return (jeng, jreqs), (peng, preqs)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_token_identical_to_reference(paged):
    """Five requests over two slots, 12 tokens each: pages of 4 are
    crossed several times per request."""
    prompts = [[1 + i] * (3 + 2 * i) for i in range(5)]
    _, (peng, preqs) = _serve_both(prompts, slots=2, cache_len=32,
                                   max_new_tokens=12, paged=paged,
                                   page_size=4)
    assert all(len(r.out) == 12 for r in preqs)
    assert peng.audit() == []


def test_engine_preemption_at_half_pool_is_token_identical():
    prompts = [[1 + i] * 6 for i in range(4)]
    sc = dict(slots=2, cache_len=32, max_new_tokens=24, paged=True,
              page_size=8)
    (jeng, _), (peng, preqs) = _serve_both(prompts, total_pages=5, **sc)
    assert peng.preemptions > 0 and peng.preemptions == jeng.preemptions
    _, pmodel_free = _serve_both(prompts, **sc)
    assert [r.out for r in preqs] == [r.out for r in pmodel_free[1]]


def test_engine_with_dropped_assignments_is_token_identical():
    """At capacity factor 0.25 a prefill of 3 x 11 tokens has room for 8
    of its 66 assignments' average 8.25 per expert: assignments drop at
    prefill and at decode, on both sides alike."""
    prompts = [list(np.random.default_rng(i).integers(0, 256, 11))
               for i in range(3)] + [[5, 6, 7]]
    drops = pmoe.count_drops("cpu")
    try:
        for paged in (False, True):
            _serve_both(prompts, cf=0.25, slots=3, cache_len=32,
                        max_new_tokens=8, paged=paged, page_size=4)
    finally:
        pmoe.stop_counting_drops()
    assert int(drops) > 0


def test_launcher_serves_deepseek_on_cpu(capsys):
    from repro_torch.launch import serve
    reqs = serve.main(["--arch", ARCH, "--smoke", "--prompts", "3",
                       "--prompt-len", "6", "--max-new", "4", "--paged",
                       "--page-size", "4", "--device", "cpu"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = capsys.readouterr().out
    assert '"all_done": true' in out and '"moe_dropped"' in out
