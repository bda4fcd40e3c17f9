"""Shared building blocks (``repro.models.layers``): init laws, the
norm, RoPE, the MLP (gated SiLU or tanh-GELU, or whisper's ungated
tanh-GELU), embeddings and the encoder's sinusoidal positions."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import dtype_of
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

def init_mlp(gen: torch.Generator, d: int, ff: int, *, dtype,
             activation: str = "silu"):
    """``w_gate`` (drawn first), ``w_up`` and ``w_down``; no ``w_gate``
    for ``activation="gelu_ungated"`` (``repro`` layers.py:71)."""
    p = {}
    if activation != "gelu_ungated":
        p["w_gate"] = dense_init(gen, (d, ff), dtype=dtype)
    p["w_up"] = dense_init(gen, (d, ff), dtype=dtype)
    p["w_down"] = dense_init(gen, (ff, d), dtype=dtype, in_axis_size=ff)
    return p


def apply_mlp(p, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    """Gated MLP: (act(x W_gate) * x W_up) W_down, act SiLU or, for
    ``activation="gelu"``, tanh-approximated GELU (``repro`` layers.py:
    80-90, ``jax.nn.gelu(approximate=True)``); for ``"gelu_ungated"``
    (whisper) gelu(x W_up) W_down, tanh-approximated too: ``jax.nn.gelu``
    defaults to ``approximate=True``, torch's ``F.gelu`` to erf."""
    xd = x.dtype
    up = x @ p["w_up"].to(xd)
    if activation == "gelu_ungated":
        return F.gelu(up, approximate="tanh") @ p["w_down"].to(xd)
    gate = x @ p["w_gate"].to(xd)
    act = F.gelu(gate, approximate="tanh") if activation == "gelu" \
        else F.silu(gate)
    return (act * up) @ p["w_down"].to(xd)


# --------------------------------------------------------- Embedding ----

def init_embed(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    v = padded_vocab(cfg.vocab_size)
    return (dense_init(gen, (v, cfg.d_model), dtype=dtype,
                       in_axis_size=cfg.d_model),
            dense_init(gen, (cfg.d_model, v), dtype=dtype))


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Logits x (..., d) @ table (d, Vp) as float32: the compute-dtype
    products summed in f32 and kept there.  The reference rounds them to
    the compute dtype first; in bf16 that is a resolution of 1/32 at a
    logit of 4, where the top candidates of a 256,000-token vocabulary
    tie or swap by rounding alone, and greedy decoding reads the order.
    On the card cuBLAS writes the f32 output itself; on the CPU the
    operands are widened first, which computes the same sums."""
    if x.device.type == "cuda" and x.dtype != torch.float32:
        flat = torch.mm(x.reshape(-1, x.shape[-1]), table.to(x.dtype),
                        out_dtype=torch.float32)
        return flat.reshape(*x.shape[:-1], table.shape[-1])
    return x.float() @ table.float()


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Rows of the table in the compute dtype; gemma scales them by
    sqrt(d_model), rounded to that dtype first, as the reference's
    ``jnp.asarray(sqrt(d), x.dtype)`` (a Python number: no tensor, so
    no host-to-device copy)."""
    dt = dtype_of(cfg.dtype)
    x = table[tokens.long()].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dt).item()
    return x


def sinusoidal_positions(s: int, d: int, dtype, device) -> torch.Tensor:
    """(s, d) positions of the encoder's frames, [sin | cos] of pos /
    10000^(2i/d), computed in f32 and then cast (``repro`` layers.py:
    110)."""
    pos = torch.arange(s, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
