"""whisper-base through the port: the encoder over frame embeddings,
cross-attention in every decoder layer and the ungated GELU MLP, against
``repro`` on the CPU.

The ungated MLP (tanh-GELU, as ``jax.nn.gelu`` computes by default) and
its missing ``w_gate``; the encoder's sinusoidal positions; the segments
and the ``convert`` tree (the encoder's segments and final norm, every
decoder layer's ``ln_cross`` and ``cross_attn``); ``_encode``; prefill
with ``encoder_embeds`` and its ``ek``/``ev`` caches; decode steps whose
cross-attention query sits at position 0, as the reference rotates it;
``Model.loss``; and the engine's refusal beside the reference engine's
``KeyError`` at its first admission.  Everything in float32 on both
sides, the smoke config (2 encoder and 2 decoder layers, d_model 64, 4
query heads over 2 of 16), parameters through ``convert.from_jax_params``,
the JAX side under ``target("generic")``.  Serial time about 40 s, most
of it the reference's two engines.
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
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import layers as PL
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "whisper-base"
#: float32 on both sides, summed in another order
TOL = dict(atol=1e-4, rtol=1e-4)
#: the loss: a sum over every label divided by their count
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)
B, S, ENC, CACHE_LEN = 2, 9, 20, 16

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _models():
    """(jax model, jax params, port model, port params), float32."""
    if not _STATE:
        cfgs = [dataclasses.replace(c, dtype="float32")
                for c in (smoke_config(ARCH), port_smoke_config(ARCH))]
        model = build_model(cfgs[0])
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build_model(cfgs[1]),
                       from_jax_params(tree, cfgs[1], device="cpu"))
    return _STATE["m"]


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _prefill_both(toks, enc):
    model, params, pmodel, pparams = _models()
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), CACHE_LEN,
                                       {"encoder_embeds": jnp.asarray(enc)})
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), CACHE_LEN,
                                      {"encoder_embeds": _t(enc)})
    return (logits, caches), (plogits, pcaches)


# ------------------------------------------------------------ layers -----

def test_gelu_ungated_mlp_is_the_references():
    """No ``w_gate``; gelu(x W_up) W_down with the tanh approximation
    (``jax.nn.gelu``'s default), which the erf form misses."""
    x = _rand((3, 5, 64), 0)
    jp = JL.init_mlp(jax.random.PRNGKey(1), 64, 128, "gelu_ungated")
    assert set(jp) == {"w_up", "w_down"}
    pp = {k: _t(v) for k, v in jp.items()}
    want = _np(JL.apply_mlp(jp, jnp.asarray(x), "gelu_ungated"))
    got = PL.apply_mlp(pp, _t(x), "gelu_ungated")
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    up = _t(x) @ pp["w_up"]
    erf = torch.nn.functional.gelu(up) @ pp["w_down"]
    assert float((erf - got).abs().max()) > 1e-4
    init = PL.init_mlp(torch.Generator().manual_seed(0), 64, 128,
                       dtype=torch.float32, activation="gelu_ungated")
    assert set(init) == {"w_up", "w_down"}


@pytest.mark.parametrize("s,d,dtype", [(1500, 512, "float32"),
                                       (1500, 512, "bfloat16"),
                                       (7, 64, "float32")])
def test_sinusoidal_positions_match_reference(s, d, dtype):
    """Computed in f32, then cast: bf16 positions equal bit for bit."""
    want = _np(JL.sinusoidal_positions(s, d, jnp.dtype(dtype)))
    got = PL.sinusoidal_positions(s, d, getattr(torch, dtype), "cpu")
    assert got.dtype == getattr(torch, dtype) and got.shape == (s, d)
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.float().numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=2e-6, rtol=0)


# ------------------------------------------------------------ config -----

@pytest.mark.parametrize("which", ["full", "smoke"])
def test_segments_match_reference(which):
    """The decoder's one global layer repeated (6 at full size, 2 at
    smoke) and the encoder's likewise, as the reference segments them."""
    jcfg = get_config(ARCH) if which == "full" else smoke_config(ARCH)
    pcfg = port_configs.get_config(ARCH) if which == "full" \
        else port_smoke_config(ARCH)
    for enc in (False, True):
        got = [(p.block, p.reps) for p in PT.plan_segments(pcfg,
                                                           encoder=enc)]
        assert got == [(p.block, p.reps)
                       for p in JT.plan_segments(jcfg, encoder=enc)]
        assert got == [((("global", False),), 6 if which == "full" else 2)]
    granite = port_configs.get_config("granite-8b")
    assert PT.plan_segments(granite, encoder=True) == []


def test_convert_carries_the_encoder_and_cross_attention():
    _, params, _, pparams = _models()
    tree = jax.tree_util.tree_map(np.asarray, params)
    enc, dec = tree["encoder"], tree["segments"][0][0]
    assert len(pparams["encoder"]["layers"]) == 2
    np.testing.assert_array_equal(pparams["encoder"]["final_norm"].numpy(),
                                  enc["final_norm"])
    for r, layer in enumerate(pparams["encoder"]["layers"]):
        blk = enc["segments"][0][0]
        assert set(layer) == {"ln1", "ln2", "attn", "mlp"}
        assert set(layer["mlp"]) == {"w_up", "w_down"}
        np.testing.assert_array_equal(layer["attn"]["wq"].numpy(),
                                      blk["attn"]["wq"][r].reshape(64, -1))
    for r, layer in enumerate(pparams["layers"]):
        assert set(layer) == {"ln1", "ln_cross", "ln2", "attn",
                              "cross_attn", "mlp"}
        for name in ("wq", "wk", "wv", "wo"):
            np.testing.assert_array_equal(
                layer["cross_attn"][name].numpy(),
                dec["cross_attn"][name][r].reshape(
                    layer["cross_attn"][name].shape))
        np.testing.assert_array_equal(layer["mlp"]["w_up"].numpy(),
                                      dec["mlp"]["w_up"][r])


def test_init_draws_the_encoder_and_cross_attention():
    """The port's own random weights have the converted tree's layout."""
    pcfg = dataclasses.replace(port_smoke_config(ARCH), dtype="float32")
    got = PT.init_params(torch.Generator().manual_seed(0), pcfg)
    _, _, _, pparams = _models()

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return tuple(tree.shape)
    assert shapes(got) == shapes(pparams)


# ------------------------------------------------------------- model -----

def test_encode_matches_reference():
    model, params, _, pparams = _models()
    enc = _rand((B, ENC, 64), 2)
    with ctx.target("generic"):
        want = JT._encode(params, model.cfg, jnp.asarray(enc))
    got = PT._encode(pparams, _models()[2].cfg, _t(enc), plain=False)
    assert got.shape == (B, ENC, 64)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)


def test_prefill_with_encoder_matches_reference_and_caches_ek_ev():
    """Logits, the decoder's K/V, and each layer's encoder K/V (``ek``
    rotated at the encoder's positions, ``ev``) of ENC rows."""
    toks, enc = _tokens(), _rand((B, ENC, 64), 3)
    (logits, caches), (plogits, pcaches) = _prefill_both(toks, enc)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    for i, c in enumerate(pcaches):
        assert set(c) == {"k", "v", "ek", "ev"}
        assert c["k"].shape == (B, 2, CACHE_LEN, 16)
        assert c["ek"].shape == (B, 2, ENC, 16)
        for name in c:
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(caches[0][0][name][i]), **TOL)
    # without the encoder's input no cross-attention runs: other logits
    bare, _ = _models()[2].prefill(_models()[3], _t(toks).long(), CACHE_LEN)
    assert float((bare - plogits).abs().max()) > 1e-2


def test_decode_steps_match_reference_with_the_cross_query_at_position_0():
    """Three decode steps over the prefill's caches (ragged lengths)
    against the reference's; its cross query is rotated at position 0
    (``repro`` transformer.py:355), so a decode step is not the
    teacher-forced forward: the reference's own prefill over the same
    tokens gives other logits, and so does the port's."""
    model, params, pmodel, pparams = _models()
    toks, enc = _tokens(4), _rand((B, ENC, 64), 5)
    (_, caches), (_, pcaches) = _prefill_both(toks, enc)
    lengths = np.array([S, S - 3], np.int32)       # row 1 rewinds
    cur = np.array([7, 200], np.int32)
    for step in range(3):
        with ctx.target("generic"):
            want, caches = model.decode_step(params, caches, jnp.asarray(cur),
                                             jnp.asarray(lengths))
        got = pmodel.decode_step(pparams, pcaches, _t(cur), _t(lengths))
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        cur = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        lengths = lengths + 1
    # the first step's logits against a prefill over prompt + token
    full = np.concatenate([toks, np.array([[7], [200]], np.int32)], 1)
    (_, caches), (_, pcaches) = _prefill_both(toks, enc)
    with ctx.target("generic"):
        step, _ = model.decode_step(params, caches, jnp.asarray([7, 200]),
                                    jnp.asarray([S, S], jnp.int32))
        forward, _ = model.prefill(params, jnp.asarray(full), CACHE_LEN,
                                   {"encoder_embeds": jnp.asarray(enc)})
    pforward, _ = pmodel.prefill(pparams, _t(full).long(), CACHE_LEN,
                                 {"encoder_embeds": _t(enc)})
    np.testing.assert_allclose(pforward.numpy(), _np(forward), **TOL)
    assert float(jnp.abs(step - forward).max()) > 1e-2


def test_model_loss_with_encoder_embeds_matches_reference():
    model, params, pmodel, pparams = _models()
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, 256, (B, 12)).astype(np.int32),
             "labels": rng.integers(0, 256, (B, 12)).astype(np.int32),
             "encoder_embeds": _rand((B, ENC, 64), 7)}
    with ctx.target("generic"):
        loss, metrics = model.loss(params, {k: jnp.asarray(v)
                                            for k, v in batch.items()})
    pbatch = {k: _t(v) for k, v in batch.items()}
    pbatch["tokens"], pbatch["labels"] = (pbatch[k].long()
                                          for k in ("tokens", "labels"))
    ploss, pmetrics = pmodel.loss(pparams, pbatch)
    for name in metrics:
        np.testing.assert_allclose(float(pmetrics[name]),
                                   float(metrics[name]), **LOSS_TOL)
    _, plain = pmodel.loss(pparams, pbatch, plain=True)
    assert torch.equal(plain["loss"], ploss)
    bare, _ = pmodel.loss(pparams, {k: pbatch[k]
                                    for k in ("tokens", "labels")})
    assert abs(float(bare) - float(ploss)) > 1e-3


# ------------------------------------------------------------ engine -----

@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_refuses_an_encoder_decoder_as_the_reference_fails(paged):
    """The port refuses at construction, saying why; the reference's
    engine, which prefills with no extras (``repro`` engine.py:383),
    fails at its first admission for want of the encoder's K/V."""
    model, params, pmodel, pparams = _models()
    sc = dict(slots=2, cache_len=CACHE_LEN, max_new_tokens=4, paged=paged,
              page_size=4)
    with pytest.raises(ValueError, match="encoder-decoder"):
        PortEngine(pmodel, pparams, PortServeConfig(**sc), device="cpu")
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eng = Engine(model, params, ServeConfig(**sc))
        with pytest.raises(KeyError, match="ek"):
            eng.run_to_completion([Request(rid=0, tokens=[1, 2, 3])])
