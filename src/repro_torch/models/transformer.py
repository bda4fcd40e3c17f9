"""Decoder stack (``repro.models.transformer``, the branches serving
takes for decoders of global and sliding-window attention layers:
granite-8b; gemma2-2b's alternating local/global pattern with softcaps,
sandwich norms, a tanh-GELU MLP and a scaled embedding; gemma3's 5:1
local/global pattern with qk-norm and a RoPE base of its own on the
local layers;
deepseek-v2-lite-16b's MLA attention with a dense first layer and MoE
layers after it; jamba-1.5's hybrid of global attention and mamba
layers with MoE on every other layer; and xlstm-1.3b's recurrent stack
of mLSTM and sLSTM blocks, which subsume the feed-forward; whisper-base's
encoder-decoder: a bidirectional encoder over frame embeddings with
sinusoidal positions, cross-attention in every decoder layer and an
ungated GELU MLP; internvl2-26b's GQA decoder whose first
``frontend_tokens`` positions carry patch embeddings), and the
full-sequence forward with the training loss (``forward_train``,
forward only).

Parameters are a dict of tensors: ``embed`` (Vp, d), ``unembed``
(d, Vp), ``final_norm`` (d,), and ``layers``, a list with one dict per
layer (``ln1``, ``attn.{wq,wk,wv,wo}`` or with MLA ``attn.{wq_mla,
wkv_a,wkv_b,wo_mla}`` or on a mamba layer ``mamba.{in_proj,conv_w,
conv_b,x_proj,dt_proj,dt_bias,a_log,d_skip,out_proj}`` or on an xLSTM
layer ``mlstm.{...}`` / ``slstm.{...}`` (``models/xlstm.py``), then,
except on an xLSTM layer, ``ln2`` and ``mlp.{w_gate,w_up,w_down}`` or
on an MoE layer ``moe.{router,we_gate,we_up,we_down,shared}``, and
``post_ln1``/``post_ln2`` with sandwich norms, and ``ln_cross`` and
``cross_attn.{wq,wk,wv,wo}`` in an encoder-decoder); layer ``i`` has kind
``cfg.layer_kinds()[i]``.  An encoder-decoder also has ``encoder``
{"layers": its bidirectional global layers, "final_norm"}.  A Python loop
over the layers takes the place of the reference's ``lax.scan`` over
stacked segments.  Weights are stored in the compute dtype; the
reference stores f32 and casts at each use, which computes the same
thing.  Where the reference computes with a weight in f32 instead (the
MoE router; mamba's ``models/ssm.py::F32_PARAMS``; the xLSTM gates'
``models/xlstm.py::F32_PARAMS``), the port keeps it in f32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as S
from repro_torch.models import xlstm as X

Z_LOSS_WEIGHT = 1e-4
ROUTER_Z_WEIGHT = 1e-3

_FAMILIES = ("dense", "moe", "hybrid", "ssm", "audio", "vlm")
#: Modality frontends (stubs in the reference too): "audio" feeds
#: precomputed frame embeddings to the encoder, "vision" puts patch
#: embeddings at the first ``frontend_tokens`` positions.
_FRONTENDS = (None, "audio", "vision")
_MOE_LAYERS = ("none", "all", "all_but_first", "every_2")
_KINDS = ("global", "local", "mamba", "mlstm", "slstm")
_XLSTM_KINDS = ("mlstm", "slstm")
#: Layer kinds whose cache is a recurrent state, dense and slot-major in
#: both engines, instead of K/V.
RECURRENT_KINDS = ("mamba",) + _XLSTM_KINDS
_ACTIVATIONS = ("silu", "gelu", "gelu_ungated")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any configuration outside the port."""
    odd = {}
    if cfg.frontend not in _FRONTENDS:
        odd["frontend"] = cfg.frontend
    if cfg.encoder_layers < 0:
        odd["encoder_layers"] = cfg.encoder_layers
    if cfg.family not in _FAMILIES:
        odd["family"] = cfg.family
    if cfg.moe_layers not in _MOE_LAYERS:
        odd["moe_layers"] = cfg.moe_layers
    if set(cfg.layer_kinds()) - set(_KINDS):
        odd["layer_pattern"] = cfg.layer_pattern
    elif cfg.mla is not None and set(cfg.layer_kinds()) != {"global"}:
        odd["layer_pattern"] = cfg.layer_pattern    # MLA is global only
    elif ("mamba" in cfg.layer_kinds()) != (cfg.ssm is not None):
        odd["ssm"] = cfg.ssm                        # mamba layers need it
    elif (bool(set(cfg.layer_kinds()) & set(_XLSTM_KINDS))
          != (cfg.xlstm is not None)):
        odd["xlstm"] = cfg.xlstm                    # xLSTM layers need it
    if cfg.mlp_activation not in _ACTIVATIONS:
        odd["mlp_activation"] = cfg.mlp_activation
    if cfg.d_ff <= 0 and set(cfg.layer_kinds()) - set(_XLSTM_KINDS):
        odd["d_ff"] = cfg.d_ff          # only xLSTM blocks have no FFN
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: {odd} are not ported — the port serves "
            f"decoders of global and sliding-window (local) attention "
            f"layers with softcaps, sandwich norms, qk-norm, a local RoPE "
            f"base and a gated SiLU or tanh-GELU MLP, of global MLA layers "
            f"with MoE on all but the first layer, of global attention "
            f"layers with MoE and a dense residual MLP on every layer, of "
            f"global attention and mamba layers with MoE on every other "
            f"layer, and of mLSTM and sLSTM layers; encoder-decoders with "
            f"cross-attention and an ungated GELU MLP; and the frontends "
            f"{_FRONTENDS[1:]}")
    dtype_of(cfg.dtype)


def _has_ffn(kind: str) -> bool:
    """Whether a layer has the FFN sublayer: an xLSTM block subsumes it
    (``repro`` transformer.py:78)."""
    return kind not in _XLSTM_KINDS


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    block: Tuple[Tuple[str, bool], ...]   # (kind, is_moe) per position
    reps: int


def plan_segments(cfg: ModelConfig, *,
                  encoder: bool = False) -> List[SegmentPlan]:
    """The reference's segmentation (``repro`` transformer.py:50) for the
    configs the port takes: the dense first layer of ``moe_layers=
    "all_but_first"`` as a segment of its own, then the layer pattern as
    one block repeated as often as it fits (twice the pattern where
    ``every_2`` MoE meets an odd pattern, so that the block repeats),
    then the truncated tail; with ``encoder``, the encoder's global
    layers as one segment (none without an encoder).  It is the layout
    of ``repro``'s parameter tree that ``convert`` reads."""
    check_supported(cfg)
    if encoder:
        return [SegmentPlan((("global", False),), cfg.encoder_layers)] \
            if cfg.encoder_layers else []
    kinds = cfg.layer_kinds()
    descs = [(k, cfg.is_moe_layer(i)) for i, k in enumerate(kinds)]
    segs = []
    if cfg.moe is not None and cfg.moe_layers == "all_but_first":
        segs.append(SegmentPlan((descs[0],), 1))
        descs = descs[1:]
    p = len(cfg.layer_pattern)
    if cfg.moe is not None and cfg.moe_layers == "every_2" and p % 2:
        p *= 2
    reps = len(descs) // p
    if reps:
        segs.append(SegmentPlan(tuple(descs[:p]), reps))
    if descs[reps * p:]:
        segs.append(SegmentPlan(tuple(descs[reps * p:]), 1))
    return segs


# ---------------------------------------------------------------- init ----

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random weights on the generator's device, in the compute dtype,
    from the reference's laws (normal / sqrt(fan_in), norms at 0)."""
    check_supported(cfg)
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    embed, unembed = L.init_embed(gen, cfg, dtype=dt)
    cross = cfg.is_encoder_decoder
    layers = [_init_layer(gen, cfg, kind, cfg.is_moe_layer(i), dt, cross)
              for i, kind in enumerate(cfg.layer_kinds())]
    params = {"embed": embed, "unembed": unembed,
              "final_norm": L.norm_param(cfg.d_model, device=dev, dtype=dt),
              "layers": layers}
    if cross:
        params["encoder"] = {
            "layers": [_init_layer(gen, cfg, "global", False, dt, False)
                       for _ in range(cfg.encoder_layers)],
            "final_norm": L.norm_param(cfg.d_model, device=dev, dtype=dt)}
    return params


def _init_layer(gen: torch.Generator, cfg: ModelConfig, kind: str,
                is_moe: bool, dt, cross: bool) -> Dict[str, Any]:
    """One layer's weights (``repro`` transformer.py:88); ``cross`` adds
    ``ln_cross`` and ``cross_attn``."""
    dev = gen.device
    p = {"ln1": L.norm_param(cfg.d_model, device=dev, dtype=dt)}
    if kind == "mamba":
        p["mamba"] = S.init_mamba(gen, cfg, dtype=dt)
    elif kind in _XLSTM_KINDS:
        init = X.init_mlstm if kind == "mlstm" else X.init_slstm
        p[kind] = init(gen, cfg, dtype=dt)
    elif cfg.mla is not None:
        p["attn"] = A.init_mla(gen, cfg, dtype=dt)
    else:
        p["attn"] = A.init_attn(gen, cfg, dtype=dt)
    norms = ["post_ln1"] if cfg.use_post_norms else []
    if cross:
        norms.append("ln_cross")
        p["cross_attn"] = A.init_attn(gen, cfg, dtype=dt)
    if _has_ffn(kind):
        norms += ["ln2", "post_ln2"] if cfg.use_post_norms else ["ln2"]
        if is_moe:
            p["moe"] = M.init_moe(gen, cfg, dtype=dt)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt,
                                  activation=cfg.mlp_activation)
    for name in norms:
        p[name] = L.norm_param(cfg.d_model, device=dev, dtype=dt)
    return p


# -------------------------------------------------------------- layers ----

def _ring_from_full(k_full: torch.Tensor, w: int) -> torch.Tensor:
    """Full-sequence K/V (B, H, S, D) -> a ring cache (B, H, W, D) with
    token ``p`` at slot ``p % W`` (``repro`` transformer.py:207)."""
    s = k_full.shape[2]
    if s <= w:
        return torch.nn.functional.pad(k_full, (0, 0, 0, w - s))
    j = torch.arange(w, device=k_full.device)
    return k_full.index_select(2, s - w + (j - s % w) % w)


def _ring_cache(cfg: ModelConfig, kind: str, cache_len: int) -> bool:
    """Whether a layer's dense cache is a ring of the window (a local
    layer whose window is shorter than the cache)."""
    return (kind == "local" and cfg.window is not None
            and cfg.window < cache_len)


def _residual(p, x: torch.Tensor, y: torch.Tensor, post: str, cfg,
              plain: bool = False) -> torch.Tensor:
    """x + y, with y normed first by ``p[post]`` under sandwich norms."""
    if cfg.use_post_norms:
        y = L.apply_norm(p[post], y, plain=plain)
    return x + y


def _mlp_block(p, x: torch.Tensor, cfg: ModelConfig, *,
               plain: bool = False, aux=None) -> torch.Tensor:
    """The FFN sublayer: the MLP, or on an MoE layer the experts, whose
    load-balance and router z losses are added into ``aux`` where one
    is given; none on an xLSTM layer (it has no ``ln2``)."""
    if "ln2" not in p:
        return x
    h = L.apply_norm(p["ln2"], x, plain=plain)
    if "moe" not in p:
        y = L.apply_mlp(p["mlp"], h, cfg.mlp_activation)
    elif aux is None:
        y = M.apply_moe(p["moe"], h, cfg, plain=plain)
    else:
        y, a = M.apply_moe(p["moe"], h, cfg, plain=plain, return_aux=True)
        for name in aux:
            aux[name] = aux[name] + a[name]
    return _residual(p, x, y, "post_ln2", cfg, plain)


def _recurrent_mixer(p, h: torch.Tensor, cfg: ModelConfig, kind: str,
                     want_cache: bool, plain: bool):
    """A recurrent layer's mixer over the whole sequence: (y, its decode
    state after the sequence, or None unless ``want_cache``)."""
    if kind == "mamba":
        y, cache = S.apply_mamba(p["mamba"], h, cfg, return_cache=True,
                                 plain=plain)
        return y, (cache if want_cache else None)
    fn = X.apply_mlstm if kind == "mlstm" else X.apply_slstm
    res = fn(p[kind], h, cfg, return_cache=want_cache, plain=plain)
    return res if want_cache else (res, None)


def _cross_block(p, x: torch.Tensor, cfg: ModelConfig, ekv, rope,
                 plain: bool) -> torch.Tensor:
    """x + cross-attention of ``ln_cross(x)`` over the encoder's K/V
    ``ekv`` (``repro`` transformer.py:153, :258, :353): non-causal, no
    post-norm; ``rope`` rotates the query at positions 0..S-1."""
    h = L.apply_norm(p["ln_cross"], x, plain=plain)
    y, _, _ = A.apply_attn(p["cross_attn"], h, cfg, rope, causal=False,
                           kv_override=ekv, plain=plain)
    return x + y


def apply_layer_prefill(p, x: torch.Tensor, cfg: ModelConfig, kind: str,
                        cache_len: Optional[int], rope, *,
                        plain: bool = False, aux=None, causal: bool = True,
                        enc=None):
    """Full-sequence layer.  ``rope`` is the (cos, sin) pair of the
    sequence's positions.  Returns (x, cache): K/V padded to
    ``cache_len``, or the window's ring for a local layer whose window
    is shorter (no cache when ``cache_len`` is None: the training
    forward, whose MoE layers add their losses into ``aux``); MLA's K
    and V are the materialised per-head ones, of their own widths; a
    recurrent layer's cache is its decode state after the sequence
    (mamba {"h", "conv"}, mLSTM {"C", "n", "m", "conv"}, sLSTM {"c",
    "n", "m", "h", "conv"}).  ``causal`` False is the encoder's
    bidirectional attention.  ``enc`` (encoder output, its positions'
    rope, the decoder query's rope) runs the layer's cross-attention
    after the mixer, its encoder K/V kept in the cache as ``ek``/``ev``."""
    h = L.apply_norm(p["ln1"], x, plain=plain)
    if kind in RECURRENT_KINDS:
        y, cache = _recurrent_mixer(p, h, cfg, kind, cache_len is not None,
                                    plain)
        k = v = None
    elif cfg.mla is not None:
        y, k, v = A.apply_mla(p["attn"], h, cfg, rope, plain=plain)
    else:
        y, k, v = A.apply_attn(p["attn"], h, cfg, rope, kind=kind,
                               causal=causal, plain=plain)
    x = _residual(p, x, y, "post_ln1", cfg, plain)
    ekv = None
    if "cross_attn" in p and enc is not None:
        enc_out, enc_rope, q_rope = enc
        ekv = A.project_kv(p["cross_attn"], enc_out, cfg, enc_rope,
                           plain=plain)
        x = _cross_block(p, x, cfg, ekv, q_rope, plain)
    x = _mlp_block(p, x, cfg, plain=plain, aux=aux)
    if cache_len is None:
        return x, None
    if k is not None and _ring_cache(cfg, kind, cache_len):
        cache = {"k": _ring_from_full(k, cfg.window),
                 "v": _ring_from_full(v, cfg.window)}
    elif k is not None:
        pad = cache_len - x.shape[1]
        cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, pad)),
                 "v": torch.nn.functional.pad(v, (0, 0, 0, pad))}
    if ekv is not None:
        cache["ek"], cache["ev"] = ekv
    return x, cache


def apply_layer_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg: ModelConfig, kind: str, lengths: torch.Tensor,
                       rope, block_tables=None, *, plain: bool = False,
                       cross_rope=None) -> torch.Tensor:
    """One-token layer step, x: (B, 1, d).  A cache holding ``kp``/``vp``
    is a paged pool pair of the global group, ``kw``/``vw`` one of the
    window group (ring tables), either quantized when ``ks``/``vs``
    scale pools sit beside it; one holding ``k``/``v`` a dense slot
    cache, or the window's ring; a recurrent layer's holds its state
    (``apply_layer_prefill``), slot-major in both engines.  ``block_tables`` is the
    (B, T) table, or for a model with a window group the dict {"global",
    "window"}.  The new token's K/V (or state) is written into the cache
    in place.  ``plain`` takes the plain version of every kernel, on any
    device, for global layers over pools (bf16 or quantized) or dense
    caches and for recurrent layers (the replay that ``chip_smoke.py`` holds the served
    path against).  A cache holding ``ek``/``ev`` (an encoder-decoder's)
    adds the layer's cross-attention over them, its one-token query
    rotated by ``cross_rope``: position 0, as the reference rotates it
    (``repro`` transformer.py:355 passes no positions)."""
    h = L.apply_norm(p["ln1"], x, plain=plain)
    if kind in RECURRENT_KINDS:
        if kind == "mamba":
            y = S.decode_mamba(p["mamba"], h, cache, cfg)
        elif kind == "mlstm":
            y = X.decode_mlstm(p["mlstm"], h, cache, cfg, plain=plain)
        else:
            y = X.decode_slstm(p["slstm"], h, cache, cfg, plain=plain)
    else:
        y = _decode_mixer(p, h, cache, cfg, kind, lengths, rope,
                          block_tables, plain)
    x = _residual(p, x, y, "post_ln1", cfg, plain)
    if "cross_attn" in p and "ek" in cache:
        x = _cross_block(p, x, cfg, (cache["ek"], cache["ev"]), cross_rope,
                         plain)
    return _mlp_block(p, x, cfg, plain=plain)


def _decode_mixer(p, h: torch.Tensor, cache, cfg: ModelConfig, kind: str,
                  lengths: torch.Tensor, rope, block_tables,
                  plain: bool) -> torch.Tensor:
    """An attention layer's one-token step over its cache (the routes
    of ``apply_layer_decode``)."""
    if isinstance(block_tables, dict):
        bt_g, bt_w = block_tables.get("global"), block_tables.get("window")
    else:
        bt_g, bt_w = block_tables, None
    scales = (cache["ks"], cache["vs"]) if "ks" in cache else None
    if cfg.mla is not None:
        paged = "kp" in cache
        y = A.decode_mla(p["attn"], h, cache["kp" if paged else "k"],
                         cache["vp" if paged else "v"], lengths, cfg, rope,
                         block_tables=bt_g if paged else None,
                         cache_scales=scales, plain=plain)
    elif "kw" in cache:
        y = A.decode_attn(p["attn"], h, cache["kw"], cache["vw"], lengths,
                          cfg, rope, kind=kind, block_tables=bt_w,
                          cache_scales=scales, windowed=True, plain=plain)
    elif "kp" in cache:
        y = A.decode_attn(p["attn"], h, cache["kp"], cache["vp"], lengths,
                          cfg, rope, kind=kind, block_tables=bt_g,
                          cache_scales=scales, plain=plain)
    else:
        ring = (kind == "local" and cfg.window is not None
                and cache["k"].shape[2] == cfg.window)
        y = A.decode_attn(p["attn"], h, cache["k"], cache["v"], lengths, cfg,
                          rope, kind=kind, ring=ring, plain=plain)
    return y


def apply_layer_spec_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                            cfg: ModelConfig, kind: str,
                            lengths: torch.Tensor, rope,
                            block_tables, *,
                            plain: bool = False) -> torch.Tensor:
    """Speculative K1-token layer step, x: (B, K1, d), over a paged
    (possibly quantized) cache of a global layer, GQA or MLA (``repro``
    transformer.py:371); the window's K/V rows are written into it in
    place.  The norms, the MLP and the MoE are shape-generic over K1.
    ``plain`` takes the plain version of every kernel, on any device."""
    if kind != "global":
        raise ValueError(f"spec decode supports global-attention layers "
                         f"only, got {kind!r}")
    if "kp" not in cache:
        raise ValueError("spec decode requires paged caches")
    h = L.apply_norm(p["ln1"], x, plain=plain)
    scales = (cache["ks"], cache["vs"]) if "ks" in cache else None
    fn = A.spec_decode_mla if cfg.mla is not None else A.spec_decode_attn
    y = fn(p["attn"], h, cache["kp"], cache["vp"], lengths, cfg, rope,
           block_tables=block_tables, cache_scales=scales, plain=plain)
    return _mlp_block(p, _residual(p, x, y, "post_ln1", cfg, plain), cfg,
                      plain=plain)


# --------------------------------------------------------------- model ----

def _logits(params, x: torch.Tensor, cfg: ModelConfig, *,
            plain: bool = False) -> torch.Tensor:
    """f32 logits over the padded vocabulary (``L.unembed``), softcapped
    as ``final_softcap * tanh(x / final_softcap)`` where the config has
    one; the padded tail is -1e30."""
    x = L.apply_norm(params["final_norm"], x, plain=plain)
    logits = L.unembed(x, params["unembed"])
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    v = L.padded_vocab(cfg.vocab_size)
    if v != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _rope_dim(cfg: ModelConfig) -> int:
    """The columns RoPE rotates: the head, or MLA's rope part."""
    return cfg.mla.qk_rope_head_dim if cfg.mla is not None else cfg.head_dim


def _theta(cfg: ModelConfig, kind: str) -> float:
    """A layer's RoPE base: ``rope_theta_local`` on local layers where
    the config sets one (gemma3), else ``rope_theta``."""
    if kind == "local" and cfg.rope_theta_local is not None:
        return cfg.rope_theta_local
    return cfg.rope_theta


def _rope_tables(cfg: ModelConfig, positions: torch.Tensor, shape):
    """Every layer rotates the same positions, so each call computes one
    cos/sin pair per RoPE base of the stack (two with
    ``rope_theta_local``), not one per layer: {base: (cos, sin)}, each
    reshaped by ``shape`` to broadcast against the layers' q/k."""
    tables = {}
    for theta in {_theta(cfg, k) for k in cfg.layer_kinds()}:
        cos, sin = L.rope_cache(positions, _rope_dim(cfg), theta)
        tables[theta] = (shape(cos), shape(sin))
    return tables


def _encode(params, cfg: ModelConfig, encoder_embeds: torch.Tensor, *,
            plain: bool) -> torch.Tensor:
    """The encoder over precomputed frame embeddings (B, S_enc, d) (the
    reference's stub frontend, ``repro`` transformer.py:535): sinusoidal
    positions added in the compute dtype, then bidirectional global
    layers (RoPE at the frames' positions too) and the encoder's final
    norm."""
    dt = dtype_of(cfg.dtype)
    x = encoder_embeds.to(dt)
    s = x.shape[1]
    x = x + L.sinusoidal_positions(s, cfg.d_model, dt, x.device)[None]
    rope = L.rope_cache(torch.arange(s, device=x.device), cfg.head_dim,
                        _theta(cfg, "global"))
    for p in params["encoder"]["layers"]:
        x, _ = apply_layer_prefill(p, x, cfg, "global", None, rope,
                                   plain=plain, causal=False)
    return L.apply_norm(params["encoder"]["final_norm"], x, plain=plain)


def _splice_vision(x: torch.Tensor, vision_embeds: torch.Tensor):
    """The vision stub (``repro`` transformer.py:547): the first
    ``vision_embeds.shape[1]`` positions carry the patch embeddings in
    place of the tokens' (the sequence keeps its length)."""
    n = vision_embeds.shape[1]
    return torch.cat([vision_embeds.to(x.dtype), x[:, n:]], dim=1)


def _forward(params, cfg: ModelConfig, tokens: torch.Tensor,
             cache_len: Optional[int], *, plain: bool, aux=None,
             extras=None):
    """The decoder over ``tokens`` with the config's stub inputs from
    ``extras``: "vision_embeds" spliced in for a vision frontend,
    "encoder_embeds" through the encoder for an encoder-decoder; any
    other, or one the config does not take, is ignored, as the
    reference ignores it."""
    extras = extras or {}
    x = L.embed_tokens(params["embed"], tokens, cfg)
    if cfg.frontend == "vision" and "vision_embeds" in extras:
        x = _splice_vision(x, extras["vision_embeds"])
    positions = torch.arange(tokens.shape[1], device=x.device)
    ropes = _rope_tables(cfg, positions, lambda t: t)
    enc = None
    if cfg.is_encoder_decoder and "encoder_embeds" in extras:
        enc_out = _encode(params, cfg, extras["encoder_embeds"], plain=plain)
        enc_pos = torch.arange(enc_out.shape[1], device=x.device)
        # the cross-attention calls take no theta: the config's base
        enc = (enc_out, L.rope_cache(enc_pos, cfg.head_dim, cfg.rope_theta),
               L.rope_cache(positions, cfg.head_dim, cfg.rope_theta))
    caches = []
    for p, kind in zip(params["layers"], cfg.layer_kinds()):
        x, c = apply_layer_prefill(p, x, cfg, kind, cache_len,
                                   ropes[_theta(cfg, kind)], plain=plain,
                                   aux=aux, enc=enc)
        caches.append(c)
    return x, caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int,
            extras=None, *, plain: bool = False):
    """Full-sequence prefill.  tokens: (B, S); ``extras`` the batch's
    stub inputs (``_forward``).  Returns (last-position logits (B, Vp),
    per-layer caches {"k", "v"}: (B, Hkv, cache_len, hd), or (B, Hkv,
    window, hd) rings for local layers whose window is shorter than
    ``cache_len``; MLA's (B, H, cache_len, qk|v); with an encoder, also
    {"ek", "ev"}: (B, Hkv, S_enc, hd), the encoder's K/V for the
    layer's cross-attention).  ``plain`` takes the plain version of
    every kernel, on any device."""
    x, caches = _forward(params, cfg, tokens, cache_len, plain=plain,
                         extras=extras)
    # the norm kernel takes dense rows: copy the strided last position
    last = x[:, -1:].contiguous()
    return _logits(params, last, cfg, plain=plain)[:, 0], caches


def forward_logits(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   plain: bool = False, start: int = 0) -> torch.Tensor:
    """Logits (B, S - start, Vp) at positions ``start`` .. S-1: the
    teacher-forced reference for served token streams, computed only
    where it is read (at a vocabulary of 256,000, every position of a
    long prompt would be gigabytes).  ``plain`` takes the plain PyTorch
    version of every kernel, on any device."""
    x, _ = _forward(params, cfg, tokens, None, plain=plain)
    return _logits(params, x[:, start:].contiguous(), cfg, plain=plain)


def forward_train(params, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
                  *, plain: bool = False):
    """The training loss, forward only (``repro`` transformer.py:569):
    batch {"tokens", "labels"} (B, S) int, with the config's stub inputs
    ("vision_embeds" (B, n, d), "encoder_embeds" (B, S_enc, d);
    ``_forward``).  Returns (loss, metrics): the cross-entropy over the
    padded vocabulary (its tail masked at -1e30 by ``_logits``) and the
    z-loss ``Z_LOSS_WEIGHT`` lse^2, each summed over the labels that
    count and divided by their number (at least 1): all of them, but
    the n patch positions of a vision splice; and the MoE layers'
    load-balance (weighted by ``aux_loss_weight``) and router z
    (``ROUTER_Z_WEIGHT``) losses summed over the layers; every metric a
    0-d f32 tensor, under the reference's names.  ``plain`` takes the
    plain version of every kernel, on any device."""
    tokens, labels = batch["tokens"], batch["labels"]
    zero = torch.zeros((), dtype=torch.float32, device=tokens.device)
    aux = {"load_balance": zero, "router_z": zero}
    x, _ = _forward(params, cfg, tokens, None, plain=plain, aux=aux,
                    extras=batch)
    logits = _logits(params, x, cfg, plain=plain)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels[..., None].long())[..., 0]
    mask = torch.ones(labels.shape, dtype=torch.float32,
                      device=tokens.device)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        mask[:, :batch["vision_embeds"].shape[1]] = 0.0
    denom = mask.sum().clamp(min=1.0)
    ce = ((lse - ll) * mask).sum() / denom
    z_loss = Z_LOSS_WEIGHT * ((lse ** 2) * mask).sum() / denom
    moe_w = cfg.moe.aux_loss_weight if cfg.moe is not None else 0.0
    loss = (ce + z_loss + moe_w * aux["load_balance"]
            + ROUTER_Z_WEIGHT * aux["router_z"])
    return loss, {"loss": loss, "ce": ce, "z_loss": z_loss,
                  "load_balance": aux["load_balance"],
                  "router_z": aux["router_z"]}


def decode_step(params, cfg: ModelConfig, caches: List[Dict], tokens,
                lengths, block_tables=None, *,
                plain: bool = False) -> torch.Tensor:
    """One decode step.  tokens (B,) int; lengths (B,) int32, tokens
    already cached.  Writes the step's K/V into ``caches`` in place and
    returns logits (B, Vp).  ``block_tables`` routes paged pools: a
    (B, T) table, or {"global", "window"} with a window group.
    ``plain`` takes the plain version of every kernel, on any device
    (MLA models)."""
    x = L.embed_tokens(params["embed"], tokens[:, None], cfg)
    # each slot's position is its length, the same in every layer
    ropes = _rope_tables(cfg, lengths, lambda t: t[:, None, :])
    cross_rope = None
    if cfg.is_encoder_decoder:
        # the one-token cross query at position 0, every step
        cross_rope = L.rope_cache(torch.zeros(1, dtype=torch.int32,
                                              device=x.device),
                                  cfg.head_dim, cfg.rope_theta)
    for p, c, kind in zip(params["layers"], caches, cfg.layer_kinds()):
        x = apply_layer_decode(p, x, c, cfg, kind, lengths,
                               ropes[_theta(cfg, kind)], block_tables,
                               plain=plain, cross_rope=cross_rope)
    return _logits(params, x, cfg, plain=plain)[:, 0]


def spec_decode_step(params, cfg: ModelConfig, caches: List[Dict], tokens,
                     lengths, block_tables, *,
                     plain: bool = False) -> torch.Tensor:
    """Speculative verify step.  tokens (B, K1) int, the current token
    and K1-1 drafts; lengths (B,) int32, tokens already cached.  Writes
    all K1 rows' K/V into the paged ``caches`` in place and returns
    logits (B, K1, Vp): row i conditions on ``tokens[:, :i+1]``.
    ``plain`` takes the plain version of every kernel, on any device."""
    k1 = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, cfg)
    # positions lengths + i, the same in every layer
    pos = lengths[:, None] + torch.arange(k1, dtype=lengths.dtype,
                                          device=lengths.device)[None, :]
    ropes = _rope_tables(cfg, pos, lambda t: t[:, :, None, :])
    for p, c, kind in zip(params["layers"], caches, cfg.layer_kinds()):
        x = apply_layer_spec_decode(p, x, c, cfg, kind, lengths,
                                    ropes[_theta(cfg, kind)], block_tables,
                                    plain=plain)
    return _logits(params, x, cfg, plain=plain)


def kv_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(cached heads, K width, V width) per layer: MLA caches the
    materialised K (nope + rope) and V of every query head."""
    m = cfg.mla
    if m is None:
        return cfg.num_kv_heads, cfg.head_dim, cfg.head_dim
    return (cfg.num_heads, m.qk_nope_head_dim + m.qk_rope_head_dim,
            m.v_head_dim)


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       device, *, enc_len: int = 0
                       ) -> List[Dict[str, torch.Tensor]]:
    """Zeroed dense caches per layer kind (``repro`` transformer.py:176):
    K/V (B, H, S, Dk|Dv) (``kv_dims``), S = cache_len, or the window for
    a local layer whose window is shorter (its ring); a recurrent layer's
    empty state (``recurrent_cache``); an encoder-decoder's layers also
    ``ek``/``ev`` (B, Hkv, enc_len, hd)."""
    dt = dtype_of(cfg.dtype)
    h, dk, dv = kv_dims(cfg)
    caches = []
    for kind in cfg.layer_kinds():
        if kind in RECURRENT_KINDS:
            c = recurrent_cache(cfg, kind, batch, dt, device)
        else:
            s = cfg.window if _ring_cache(cfg, kind, cache_len) \
                else cache_len
            c = {"k": torch.zeros((batch, h, s, dk), device=device,
                                  dtype=dt),
                 "v": torch.zeros((batch, h, s, dv), device=device,
                                  dtype=dt)}
        if cfg.is_encoder_decoder:
            for name in ("ek", "ev"):
                c[name] = torch.zeros((batch, cfg.num_kv_heads, enc_len,
                                       cfg.head_dim), device=device,
                                      dtype=dt)
        caches.append(c)
    return caches


def recurrent_cache(cfg: ModelConfig, kind: str, batch: int, dtype,
                    device) -> Dict[str, torch.Tensor]:
    """A recurrent layer's empty decode state for ``batch`` slots: mamba
    {"h", "conv"}, mLSTM {"C", "n", "m", "conv"}, sLSTM {"c", "n", "m",
    "h", "conv"} (the stabilisers m at ``xlstm.M_EMPTY``)."""
    fn = {"mamba": S.mamba_cache, "mlstm": X.mlstm_cache,
          "slstm": X.slstm_cache}[kind]
    return fn(cfg, batch, dtype, device)
