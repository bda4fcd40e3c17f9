"""Shared building blocks (``repro.models.layers``): init laws, the
norm, RoPE, the gated-SiLU MLP, embeddings."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rmsnorm import ref as rmsnorm_ref
from repro_torch.kernels.rmsnorm.ops import rmsnorm

VOCAB_PAD = 256


def padded_vocab(v: int) -> int:
    return ((v + VOCAB_PAD - 1) // VOCAB_PAD) * VOCAB_PAD


def dense_init(gen: torch.Generator, shape, *, dtype: torch.dtype,
               in_axis_size: Optional[int] = None) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), drawn in f32 on the generator's device
    (the law of ``repro.models.layers.dense_init``)."""
    fan_in = in_axis_size or shape[0]
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def norm_param(d: int, *, device, dtype) -> torch.Tensor:
    """Norm weights start at 0 and apply as ``w + 1``."""
    return torch.zeros((d,), device=device, dtype=dtype)


def apply_norm(w: torch.Tensor, x: torch.Tensor, *,
               plain: bool = False) -> torch.Tensor:
    """RMSNorm with the reference's uniform convention: weights stored
    around 0, applied with offset 1.0 and eps 1e-6, for every family.
    ``plain`` takes the plain PyTorch version on any device (the
    reference forward the chip check compares against)."""
    fn = rmsnorm_ref.rmsnorm_ref if plain else rmsnorm
    return fn(x, w.to(x.dtype), weight_offset=1.0, eps=1e-6)


# -------------------------------------------------------------- RoPE ----

def rope_cache(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) int -> cos/sin (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = -torch.arange(half, dtype=torch.float32,
                         device=positions.device) / half
    # a Python base, not a tensor made from it: that would be a
    # host-to-device copy, and a sync, in every layer of every step
    freqs = torch.pow(float(theta), exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate halves (not interleaved pairs).  x: (..., S, D)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# -------------------------------------------------------------- MLP -----

def init_mlp(gen: torch.Generator, d: int, ff: int, *, dtype):
    return {"w_gate": dense_init(gen, (d, ff), dtype=dtype),
            "w_up": dense_init(gen, (d, ff), dtype=dtype),
            "w_down": dense_init(gen, (ff, d), dtype=dtype,
                                 in_axis_size=ff)}


def apply_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU: (silu(x W_gate) * x W_up) W_down."""
    xd = x.dtype
    up = x @ p["w_up"].to(xd)
    gate = x @ p["w_gate"].to(xd)
    return (F.silu(gate) * up) @ p["w_down"].to(xd)


# --------------------------------------------------------- Embedding ----

def init_embed(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    v = padded_vocab(cfg.vocab_size)
    return (dense_init(gen, (v, cfg.d_model), dtype=dtype,
                       in_axis_size=cfg.d_model),
            dense_init(gen, (cfg.d_model, v), dtype=dtype))


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return table[tokens.long()].to(dtype)
