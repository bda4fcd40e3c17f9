"""The training loss through the port (``Model.loss``, forward only)
against ``repro``'s ``Model.loss`` on the CPU, for every ported family
at smoke size in float32: granite-8b (dense), gemma2-2b (sliding window,
softcaps, sandwich norms), deepseek-v2-lite-16b (MLA, MoE with shared
experts), jamba-1.5-large-398b (attention, mamba, MoE every other
layer) and xlstm-1.3b (mLSTM and sLSTM).  The loss and each of its
metrics (ce, z_loss, load_balance, router_z) within 2e-4; the MoE aux
losses of one call against the reference's; a vocabulary whose padded
tail the loss must mask; the refused batch inputs.  Parameters go
through ``convert.from_jax_params``; the JAX side runs under
``target("generic")``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models import moe as jmoe
from repro.models.registry import build_model
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import moe as pmoe
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model

ARCHS = ("granite-8b", "gemma2-2b", "deepseek-v2-lite-16b",
         "jamba-1.5-large-398b", "xlstm-1.3b")
METRICS = ("loss", "ce", "z_loss", "load_balance", "router_z")
# float32 on both sides, summed in another order; the loss is a mean
# over every position of a (2, 12) batch
TOL = dict(atol=2e-4, rtol=2e-4)


def _pair(arch, **change):
    jcfg = dataclasses.replace(smoke_config(arch), dtype="float32", **change)
    pcfg = dataclasses.replace(port_smoke_config(arch), dtype="float32",
                               **change)
    model = build_model(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (model, params, port_build_model(pcfg),
            from_jax_params(tree, pcfg, device="cpu"))


def _batch(vocab, seed=0, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab, shape).astype(np.int32),
            "labels": rng.integers(0, vocab, shape).astype(np.int32)}


def _both(arch, batch, **change):
    model, params, pmodel, pparams = _pair(arch, **change)
    with ctx.target("generic"):
        loss, metrics = model.loss(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    ploss, pmetrics = pmodel.loss(
        pparams, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    return (loss, metrics), (ploss, pmetrics)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_metrics_match_reference(arch):
    (loss, metrics), (ploss, pmetrics) = _both(arch, _batch(256))
    assert set(pmetrics) == set(metrics) == set(METRICS)
    assert ploss is pmetrics["loss"]
    for name in METRICS:
        got = pmetrics[name]
        assert got.shape == () and got.dtype == torch.float32, name
        np.testing.assert_allclose(float(got), float(metrics[name]), **TOL,
                                   err_msg=name)
    has_moe = smoke_config(arch).moe is not None
    assert (float(pmetrics["load_balance"]) > 0) == has_moe
    assert (float(pmetrics["router_z"]) > 0) == has_moe


@pytest.mark.parametrize("arch", ["granite-8b", "xlstm-1.3b"])
def test_loss_masks_the_padded_vocabulary(arch):
    """A vocabulary of 250 pads to 256: the six tail logits are -1e30
    and take no share of the log-sum-exp."""
    (loss, metrics), (ploss, pmetrics) = _both(arch, _batch(250, seed=1),
                                               vocab_size=250)
    for name in METRICS:
        np.testing.assert_allclose(float(pmetrics[name]),
                                   float(metrics[name]), **TOL,
                                   err_msg=name)


def test_plain_loss_is_the_loss_on_the_cpu():
    """``plain`` takes the plain versions on any device; on the CPU the
    wrappers take them already, so the two are the same numbers."""
    _, _, pmodel, pparams = _pair("xlstm-1.3b")
    batch = {k: torch.from_numpy(v).long() for k, v in _batch(256).items()}
    _, got = pmodel.loss(pparams, batch)
    _, plain = pmodel.loss(pparams, batch, plain=True)
    for name in METRICS:
        assert torch.equal(got[name], plain[name]), name


@pytest.mark.parametrize("t,e,k", [(24, 8, 2), (7, 4, 1)])
def test_moe_aux_losses_match_reference(t, e, k):
    """The load balance counts every assignment, dropped ones too (the
    reference's counts come before capacity), over the router's f32
    probabilities; the z-loss is the mean squared logsumexp."""
    rng = np.random.default_rng(t)
    x = rng.standard_normal((t, 16)).astype(np.float32)
    w = rng.standard_normal((16, e)).astype(np.float32)
    logits, probs, _, idx = jmoe._route(jnp.asarray(w), jnp.asarray(x), k)
    _, counts = jmoe._positions(idx, e)
    lb, z = jmoe._aux_losses(logits, probs, counts, t, e, k)
    _, pidx = pmoe._route(torch.from_numpy(w), torch.from_numpy(x), k)
    _, pcounts = pmoe._positions(pidx, e)
    got = pmoe._aux_losses(torch.from_numpy(w), torch.from_numpy(x),
                           pcounts, e, k)
    np.testing.assert_allclose(float(got["load_balance"]), float(lb), **TOL)
    np.testing.assert_allclose(float(got["router_z"]), float(z), **TOL)


def test_loss_refuses_the_vision_splice_and_the_encoder():
    """granite takes neither stub input: with ``vision_embeds`` or
    ``encoder_embeds`` in its batch, the loss and every metric are the
    reference's, which ignores them (no splice, no label mask, no
    encoder); a frontend with no stub is refused by name."""
    model, params, pmodel, pparams = _pair("granite-8b")
    batch = _batch(256)
    extra = np.random.default_rng(7).standard_normal((2, 4, 64)).astype(
        np.float32)
    with ctx.target("generic"):
        want, _ = model.loss(params, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    pbatch = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    plain, _ = pmodel.loss(pparams, pbatch)
    for name in ("vision_embeds", "encoder_embeds"):
        with ctx.target("generic"):
            jloss, jmetrics = model.loss(params, dict(
                {k: jnp.asarray(v) for k, v in batch.items()},
                **{name: jnp.asarray(extra)}))
        ploss, pmetrics = pmodel.loss(pparams, dict(
            pbatch, **{name: torch.from_numpy(extra)}))
        assert float(jloss) == float(want)
        assert torch.equal(ploss, plain), name
        for m in METRICS:
            np.testing.assert_allclose(float(pmetrics[m]),
                                       float(jmetrics[m]), **TOL)
    with pytest.raises(NotImplementedError, match="'video'"):
        PT.check_supported(dataclasses.replace(
            port_smoke_config("granite-8b"), frontend="video"))
