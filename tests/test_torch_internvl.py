"""internvl2-26b through the port: a GQA decoder (InternLM2-style, 48/8
heads of 128 at full size) whose first ``frontend_tokens`` positions
carry patch embeddings (the reference's vision stub), against ``repro``
on the CPU.

The config field for field, at full and smoke size (8 patch positions);
the splice in prefill (logits and caches); the splice in ``Model.loss``
with its label mask (the patch positions' labels do not count); the
paged and dense smoke engines on text prompts token for token against
``repro.serve.Engine``, which serves the model the same way (no extras
at admission).  float32 on both sides, parameters through
``convert.from_jax_params``, the JAX side under ``target("generic")``.
Serial time about 30 s, most of it the reference's engines.
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
from repro.models.registry import build_model
from repro.serve import Engine, Request, ServeConfig
from repro_torch import configs as port_configs
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models import transformer as PT
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve.engine import Engine as PortEngine
from repro_torch.serve.engine import Request as PortRequest
from repro_torch.serve.engine import ServeConfig as PortServeConfig

ARCH = "internvl2-26b"
TOL = dict(atol=1e-4, rtol=1e-4)        # float32, another summation order
LOSS_TOL = dict(atol=2e-4, rtol=2e-4)   # a sum over labels / their count
B, S, N, CACHE_LEN = 2, 12, 8, 20

_STATE = {}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models():
    if not _STATE:
        cfgs = [dataclasses.replace(c, dtype="float32")
                for c in (smoke_config(ARCH), port_smoke_config(ARCH))]
        model = build_model(cfgs[0])
        params = model.init(jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, params)
        _STATE["m"] = (model, params, port_build_model(cfgs[1]),
                       from_jax_params(tree, cfgs[1], device="cpu"))
    return _STATE["m"]


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, S)).astype(np.int32),
            rng.standard_normal((B, N, 64)).astype(np.float32))


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_matches_reference_field_for_field(which):
    want, got = {"full": (get_config(ARCH), port_configs.get_config(ARCH)),
                 "smoke": (smoke_config(ARCH), port_smoke_config(ARCH))}[which]
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.frontend == "vision" and got.family == "vlm"
    assert got.frontend_tokens == (256 if which == "full" else N)
    assert got.num_heads // got.num_kv_heads == (6 if which == "full"
                                                 else 2)
    PT.check_supported(got)


def test_prefill_splices_patch_embeddings_as_the_reference():
    """Logits and every layer's K/V with ``vision_embeds`` at the first
    N positions; the splice changes them (the tokens there are
    replaced), and the tokens at those positions no longer matter."""
    model, params, pmodel, pparams = _models()
    toks, vis = _inputs(1)
    with ctx.target("generic"):
        logits, caches = model.prefill(params, jnp.asarray(toks), CACHE_LEN,
                                       {"vision_embeds": jnp.asarray(vis)})
    extras = {"vision_embeds": _t(vis)}
    plogits, pcaches = pmodel.prefill(pparams, _t(toks).long(), CACHE_LEN,
                                      extras)
    np.testing.assert_allclose(plogits.numpy(), _np(logits), **TOL)
    for i, c in enumerate(pcaches):
        assert set(c) == {"k", "v"}
        for name in c:
            np.testing.assert_allclose(c[name].numpy(),
                                       _np(caches[0][0][name][i]), **TOL)
    bare, _ = pmodel.prefill(pparams, _t(toks).long(), CACHE_LEN)
    assert float((bare - plogits).abs().max()) > 1e-2
    other = toks.copy()
    other[:, :N] = (other[:, :N] + 1) % 256
    again, _ = pmodel.prefill(pparams, _t(other).long(), CACHE_LEN, extras)
    assert torch.equal(again, plogits)


def test_loss_masks_the_patch_positions_as_the_reference():
    """Every metric against the reference's; the labels at the N patch
    positions do not count, and the cross-entropy is the masked sum
    over the S - N labels that do, divided by their number."""
    model, params, pmodel, pparams = _models()
    toks, vis = _inputs(2)
    labels = np.random.default_rng(3).integers(0, 256, (B, S)).astype(
        np.int32)
    batch = {"tokens": toks, "labels": labels, "vision_embeds": vis}
    with ctx.target("generic"):
        _, metrics = model.loss(params, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    pbatch = {"tokens": _t(toks).long(), "labels": _t(labels).long(),
              "vision_embeds": _t(vis)}
    _, pmetrics = pmodel.loss(pparams, pbatch)
    for name in metrics:
        np.testing.assert_allclose(float(pmetrics[name]),
                                   float(metrics[name]), **LOSS_TOL)
    moved = dict(pbatch, labels=pbatch["labels"].clone())
    moved["labels"][:, :N] = (moved["labels"][:, :N] + 7) % 256
    _, again = pmodel.loss(pparams, moved)
    assert torch.equal(again["ce"], pmetrics["ce"])
    x, _ = PT._forward(pparams, pmodel.cfg, pbatch["tokens"], None,
                       plain=True, extras=pbatch)
    logits = PT._logits(pparams, x, pmodel.cfg, plain=True)[:, N:]
    ce = (torch.logsumexp(logits, -1)
          - logits.gather(-1, pbatch["labels"][:, N:, None])[..., 0]).mean()
    np.testing.assert_allclose(float(ce), float(pmetrics["ce"]), **LOSS_TOL)


# ----------------------------------------------------------- engine -----

_PROMPTS = [[1 + i] * (3 + 2 * i) for i in range(4)]


def _sc(paged):
    return dict(slots=2, cache_len=32, max_new_tokens=10, paged=paged,
                page_size=4)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_smoke_engine_token_identical_to_reference(paged):
    """Four text requests over two slots, 10 new tokens each, pages of 4
    crossed several times: the port's engine emits the reference
    engine's tokens, in each mode."""
    model, params, pmodel, pparams = _models()
    with ctx.target("generic"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jeng = Engine(model, params, ServeConfig(**_sc(paged)))
        jreqs = [Request(rid=i, tokens=list(p))
                 for i, p in enumerate(_PROMPTS)]
        jeng.run_to_completion(jreqs)
    peng = PortEngine(pmodel, pparams, PortServeConfig(**_sc(paged)),
                      device="cpu")
    preqs = [PortRequest(rid=i, tokens=list(p))
             for i, p in enumerate(_PROMPTS)]
    peng.run_to_completion(preqs)
    assert all(r.done and len(r.out) == 10 for r in preqs)
    assert peng.audit() == []
    assert [r.out for r in preqs] == [r.out for r in jreqs]
