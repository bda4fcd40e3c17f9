"""Every architecture of the reference through the port: the port of
``tests/test_arch_smoke.py``'s forward and prefill/decode tests over all
ten ``ARCH_IDS``, each held to ``repro`` on the same weights and inputs
(the reference's test only asks for finite values of the right shape).

Per architecture, at its smoke config in float32 on both sides, the
batch of the reference's test (2 x 32 tokens and labels, 8 patch
embeddings for internvl2, 32 encoder frames for whisper; drawn here
from numpy): ``Model.loss`` and each of its metrics within LOSS_TOL
(this puts arctic's and gemma3's loss against the reference, which no
other test did), then prefill with the batch's stub inputs and one
decode step from its argmax, logits within TOL.  Parameters go through
``convert.from_jax_params``; the JAX side runs jitted under
``target("generic")``.  The reference's gradient test waits for the
port's backward (ROADMAP.md queue A, item 12).  Serial time about 70 s,
most of it the reference's compilation.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS
from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models import transformer as JT
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models.registry import build_model as port_build_model

SEQ, BATCH = 32, 2
#: float32 on both sides, summed in another order
TOL = dict(atol=1e-4, rtol=1e-4)
#: the loss: sums over 64 labels divided by their count
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)
METRICS = ("loss", "ce", "z_loss", "load_balance", "router_z")

_STATE = {}


def _pair(arch):
    """(jax config, jax params, port model, port params), float32."""
    if arch not in _STATE:
        jcfg = dataclasses.replace(smoke_config(arch), dtype="float32")
        pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32")
        params = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE[arch] = (jcfg, params, port_build_model(pcfg),
                        from_jax_params(tree, pcfg, device="cpu"))
    return _STATE[arch]


def _batch(cfg, seed):
    """The reference test's batch, its stub inputs as the config takes
    them."""
    rng = np.random.default_rng(seed)
    b = {name: rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
         for name in ("tokens", "labels")}
    if cfg.frontend == "vision":
        b["vision_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        b["encoder_embeds"] = rng.standard_normal(
            (BATCH, SEQ, cfg.d_model)).astype(np.float32)
    return b


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32
            else torch.from_numpy(v) for k, v in batch.items()}


def test_every_architecture_is_ported():
    assert port_configs.LATER_SLICES == ()
    for arch in ARCH_IDS:
        port_build_model(port_configs.get_config(arch))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_train(arch):
    jcfg, params, pmodel, pparams = _pair(arch)
    batch = _batch(jcfg, 0)
    with ctx.target("generic"):
        loss, metrics = jax.jit(lambda p, b: JT.forward_train(p, b, jcfg))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pmetrics = pmodel.loss(pparams, _torch(batch))
    assert ploss.shape == () and torch.isfinite(ploss) and float(ploss) > 0
    assert set(pmetrics) == set(METRICS)
    for name in METRICS:
        np.testing.assert_allclose(float(pmetrics[name]),
                                   float(metrics[name]), **LOSS_TOL,
                                   err_msg=f"{arch} {name}")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_prefill_decode(arch):
    jcfg, params, pmodel, pparams = _pair(arch)
    batch = _batch(jcfg, 1)
    cache_len = SEQ + 8
    extras = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    jextras = {k: jnp.asarray(v) for k, v in extras.items()}
    with ctx.target("generic"):
        logits, caches = jax.jit(
            lambda p, t: JT.prefill(p, jcfg, t, cache_len, jextras))(
                params, jnp.asarray(batch["tokens"]))
    plogits, pcaches = pmodel.prefill(
        pparams, torch.from_numpy(batch["tokens"]).long(), cache_len,
        {k: torch.from_numpy(v) for k, v in extras.items()})
    v = jcfg.vocab_size
    assert plogits.shape == logits.shape
    assert torch.isfinite(plogits[:, :v]).all()
    np.testing.assert_allclose(plogits[:, :v].numpy(),
                               np.asarray(logits)[:, :v], **TOL)

    lengths = np.full((BATCH,), SEQ, np.int32)
    next_tok = np.asarray(jnp.argmax(logits, axis=-1)).astype(np.int32)
    with ctx.target("generic"):
        logits2, _ = jax.jit(
            lambda p, c, t, ln: JT.decode_step(p, jcfg, c, t, ln))(
                params, caches, jnp.asarray(next_tok), jnp.asarray(lengths))
    plogits2 = pmodel.decode_step(pparams, pcaches,
                                  torch.from_numpy(next_tok),
                                  torch.from_numpy(lengths))
    assert torch.isfinite(plogits2[:, :v]).all()
    np.testing.assert_allclose(plogits2[:, :v].numpy(),
                               np.asarray(logits2)[:, :v], **TOL)
