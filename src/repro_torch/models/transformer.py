"""Dense GQA decoder stack (``repro.models.transformer``, the branches
granite-8b serving takes).

Parameters are a dict of tensors: ``embed`` (Vp, d), ``unembed``
(d, Vp), ``final_norm`` (d,), and ``layers``, a list with one dict per
layer (``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2``, ``mlp.{w_gate,w_up,
w_down}``).  A Python loop over the layers takes the place of the
reference's ``lax.scan`` over stacked segments.  Weights are stored in
the compute dtype; the reference stores f32 and casts at each use,
which computes the same thing.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import dtype_of
from repro_torch.models import attention as A
from repro_torch.models import layers as L

_DENSE_DEFAULTS = {
    "family": "dense", "window": None, "attn_softcap": None,
    "final_softcap": None, "use_qk_norm": False, "use_post_norms": False,
    "mlp_activation": "silu", "moe": None, "moe_layers": "none",
    "mla": None, "ssm": None, "xlstm": None, "encoder_layers": 0,
    "frontend": None, "embed_scale": False,
}


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any configuration outside this slice of the port."""
    odd = {k: getattr(cfg, k) for k, v in _DENSE_DEFAULTS.items()
           if getattr(cfg, k) != v}
    if set(cfg.layer_kinds()) != {"global"}:
        odd["layer_pattern"] = cfg.layer_pattern
    if cfg.d_ff <= 0:
        odd["d_ff"] = cfg.d_ff
    if odd:
        raise NotImplementedError(
            f"{cfg.name}: {odd} are not ported yet — slice 1 serves dense "
            f"global-attention decoders with a gated-SiLU MLP; windows, "
            f"softcaps, MoE/MLA, recurrent and multimodal layers arrive in "
            f"later slices (ROADMAP.md queue A)")
    dtype_of(cfg.dtype)


@dataclasses.dataclass(frozen=True)
class SegmentPlan:
    block: Tuple[Tuple[str, bool], ...]   # (kind, is_moe) per position
    reps: int


def plan_segments(cfg: ModelConfig) -> List[SegmentPlan]:
    """The reference's segmentation for the configs this slice takes:
    one global-attention layer repeated ``num_layers`` times (the layout
    of ``repro``'s parameter tree that ``convert`` reads)."""
    check_supported(cfg)
    return [SegmentPlan((("global", False),), cfg.num_layers)]


# ---------------------------------------------------------------- init ----

def init_params(gen: torch.Generator, cfg: ModelConfig) -> Dict[str, Any]:
    """Random weights on the generator's device, in the compute dtype,
    from the reference's laws (normal / sqrt(fan_in), norms at 0)."""
    check_supported(cfg)
    dt = dtype_of(cfg.dtype)
    dev = gen.device
    embed, unembed = L.init_embed(gen, cfg, dtype=dt)
    layers = []
    for _ in range(cfg.num_layers):
        layers.append({
            "ln1": L.norm_param(cfg.d_model, device=dev, dtype=dt),
            "attn": A.init_attn(gen, cfg, dtype=dt),
            "ln2": L.norm_param(cfg.d_model, device=dev, dtype=dt),
            "mlp": L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype=dt),
        })
    return {"embed": embed, "unembed": unembed,
            "final_norm": L.norm_param(cfg.d_model, device=dev, dtype=dt),
            "layers": layers}


# -------------------------------------------------------------- layers ----

def apply_layer_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                        cache_len: Optional[int], rope, *,
                        plain: bool = False):
    """Full-sequence layer.  ``rope`` is the (cos, sin) pair of the
    sequence's positions.  Returns (x, cache) with K/V padded to
    ``cache_len`` (no cache when ``cache_len`` is None)."""
    h = L.apply_norm(p["ln1"], x, plain=plain)
    y, k, v = A.apply_attn(p["attn"], h, cfg, rope, plain=plain)
    x = x + y
    x = x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x, plain=plain))
    if cache_len is None:
        return x, None
    pad = cache_len - x.shape[1]
    cache = {"k": torch.nn.functional.pad(k, (0, 0, 0, pad)),
             "v": torch.nn.functional.pad(v, (0, 0, 0, pad))}
    return x, cache


def apply_layer_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg: ModelConfig, lengths: torch.Tensor, rope,
                       block_tables=None) -> torch.Tensor:
    """One-token layer step, x: (B, 1, d).  A cache holding ``kp``/``vp``
    is a paged pool pair, quantized when ``ks``/``vs`` scale pools sit
    beside it; one holding ``k``/``v`` a dense slot cache.  The new
    token's K/V is written into it in place."""
    h = L.apply_norm(p["ln1"], x)
    if "kp" in cache:
        scales = (cache["ks"], cache["vs"]) if "ks" in cache else None
        y = A.decode_attn(p["attn"], h, cache["kp"], cache["vp"], lengths,
                          cfg, rope, block_tables=block_tables,
                          cache_scales=scales)
    else:
        y = A.decode_attn(p["attn"], h, cache["k"], cache["v"], lengths, cfg,
                          rope)
    x = x + y
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x))


def apply_layer_spec_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                            cfg: ModelConfig, lengths: torch.Tensor, rope,
                            block_tables) -> torch.Tensor:
    """Speculative K1-token layer step, x: (B, K1, d), over a paged
    (possibly quantized) cache; the window's K/V rows are written into
    it in place.  The norms and the MLP are shape-generic over K1."""
    if "kp" not in cache:
        raise ValueError("spec decode requires paged caches")
    h = L.apply_norm(p["ln1"], x)
    scales = (cache["ks"], cache["vs"]) if "ks" in cache else None
    y = A.spec_decode_attn(p["attn"], h, cache["kp"], cache["vp"], lengths,
                           cfg, rope, block_tables=block_tables,
                           cache_scales=scales)
    x = x + y
    return x + L.apply_mlp(p["mlp"], L.apply_norm(p["ln2"], x))


# --------------------------------------------------------------- model ----

def _logits(params, x: torch.Tensor, cfg: ModelConfig, *,
            plain: bool = False) -> torch.Tensor:
    """f32 logits over the padded vocabulary; the padded tail is -1e30."""
    x = L.apply_norm(params["final_norm"], x, plain=plain)
    logits = (x @ params["unembed"].to(x.dtype)).float()
    v = L.padded_vocab(cfg.vocab_size)
    if v != cfg.vocab_size:
        logits[..., cfg.vocab_size:] = -1e30
    return logits


def _forward(params, cfg: ModelConfig, tokens: torch.Tensor,
             cache_len: Optional[int], *, plain: bool):
    x = L.embed_tokens(params["embed"], tokens, dtype_of(cfg.dtype))
    # every layer rotates the same positions: one cos/sin for the stack
    rope = L.rope_cache(torch.arange(tokens.shape[1], device=x.device),
                        cfg.head_dim, cfg.rope_theta)
    caches = []
    for p in params["layers"]:
        x, c = apply_layer_prefill(p, x, cfg, cache_len, rope, plain=plain)
        caches.append(c)
    return x, caches


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache_len: int):
    """Full-sequence prefill.  tokens: (B, S).  Returns (last-position
    logits (B, Vp), per-layer caches {"k", "v"} (B, Hkv, cache_len, hd))."""
    x, caches = _forward(params, cfg, tokens, cache_len, plain=False)
    # the norm kernel takes dense rows: copy the strided last position
    last = x[:, -1:].contiguous()
    return _logits(params, last, cfg)[:, 0], caches


def forward_logits(params, cfg: ModelConfig, tokens: torch.Tensor, *,
                   plain: bool = False) -> torch.Tensor:
    """Logits at every position (B, S, Vp): the teacher-forced reference
    for served token streams.  ``plain`` takes the plain PyTorch version
    of every kernel, on any device."""
    x, _ = _forward(params, cfg, tokens, None, plain=plain)
    return _logits(params, x, cfg, plain=plain)


def decode_step(params, cfg: ModelConfig, caches: List[Dict], tokens,
                lengths, block_tables=None) -> torch.Tensor:
    """One decode step.  tokens (B,) int; lengths (B,) int32, tokens
    already cached.  Writes the step's K/V into ``caches`` in place and
    returns logits (B, Vp).  ``block_tables`` routes paged pools."""
    x = L.embed_tokens(params["embed"], tokens[:, None], dtype_of(cfg.dtype))
    # each slot's position is its length, the same in every layer
    cos, sin = L.rope_cache(lengths, cfg.head_dim, cfg.rope_theta)
    rope = (cos[:, None, :], sin[:, None, :])
    for p, c in zip(params["layers"], caches):
        x = apply_layer_decode(p, x, c, cfg, lengths, rope, block_tables)
    return _logits(params, x, cfg)[:, 0]


def spec_decode_step(params, cfg: ModelConfig, caches: List[Dict], tokens,
                     lengths, block_tables) -> torch.Tensor:
    """Speculative verify step.  tokens (B, K1) int, the current token
    and K1-1 drafts; lengths (B,) int32, tokens already cached.  Writes
    all K1 rows' K/V into the paged ``caches`` in place and returns
    logits (B, K1, Vp): row i conditions on ``tokens[:, :i+1]``."""
    k1 = tokens.shape[1]
    x = L.embed_tokens(params["embed"], tokens, dtype_of(cfg.dtype))
    # positions lengths + i, the same in every layer: one cos/sin
    pos = lengths[:, None] + torch.arange(k1, dtype=lengths.dtype,
                                          device=lengths.device)[None, :]
    cos, sin = L.rope_cache(pos, cfg.head_dim, cfg.rope_theta)
    rope = (cos[:, :, None, :], sin[:, :, None, :])
    for p, c in zip(params["layers"], caches):
        x = apply_layer_spec_decode(p, x, c, cfg, lengths, rope,
                                    block_tables)
    return _logits(params, x, cfg)


def init_decode_caches(cfg: ModelConfig, batch: int, cache_len: int,
                       device) -> List[Dict[str, torch.Tensor]]:
    shape = (batch, cfg.num_kv_heads, cache_len, cfg.head_dim)
    dt = dtype_of(cfg.dtype)
    return [{"k": torch.zeros(shape, device=device, dtype=dt),
             "v": torch.zeros(shape, device=device, dtype=dt)}
            for _ in range(cfg.num_layers)]
