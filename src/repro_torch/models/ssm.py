"""Mamba (selective SSM) block (``repro.models.ssm``), used by
jamba-1.5.  The full-sequence path runs the selective-scan kernel
(``kernels/mamba_scan``, through ``sharding/kernel_sharding.py``); the
decode path is the closed-form one-token recurrence in plain PyTorch,
as in the reference: one token needs no kernel.

Four parameters stay in f32 whatever the compute dtype, because the
reference computes with them in f32 rather than casting them at use:
``a_log`` (A = -exp(a_log)), ``dt_bias``, ``dt_proj`` and ``d_skip``.
The others are stored in the compute dtype, which the reference casts
them to at each use.

dt is rounded to the compute dtype before the prefill scan, as the
reference hands the kernel ``dt.astype(x.dtype)``, and stays f32 in the
decode step, as the reference's ``decode_mamba`` keeps it: the two
sides differ there by design.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.sharding.kernel_sharding import sharded_mamba_scan

#: Parameters kept in f32 (the reference computes with them in f32).
F32_PARAMS = ("a_log", "dt_bias", "dt_proj", "d_skip")


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_inner, s.d_state, s.d_conv, dt_rank


def init_mamba(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    """The reference's laws: S4D-real A (a_log = log 1..n), dt_bias the
    inverse softplus of dt drawn log-uniform in [1e-3, 1e-1], D at 1,
    projections normal / sqrt(fan_in)."""
    d = cfg.d_model
    d_inner, n, d_conv, dt_rank = _dims(cfg)
    dev, f32 = gen.device, torch.float32
    a_log = torch.log(torch.arange(1, n + 1, dtype=f32, device=dev))
    dt = torch.exp(torch.rand((d_inner,), generator=gen, device=dev)
                   * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    return {
        "in_proj": L.dense_init(gen, (d, 2 * d_inner), dtype=dtype),
        "conv_w": L.dense_init(gen, (d_inner, d_conv), dtype=dtype,
                               in_axis_size=d_conv),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "x_proj": L.dense_init(gen, (d_inner, dt_rank + 2 * n), dtype=dtype,
                               in_axis_size=d_inner),
        "dt_proj": L.dense_init(gen, (dt_rank, d_inner), dtype=f32,
                                in_axis_size=dt_rank),
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),     # inverse softplus
        "a_log": a_log[None, :].expand(d_inner, n).contiguous(),
        "d_skip": torch.ones((d_inner,), dtype=f32, device=dev),
        "out_proj": L.dense_init(gen, (d_inner, d), dtype=dtype,
                                 in_axis_size=d_inner),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 state=None):
    """Depthwise causal conv.  x: (B, S, d_inner); w: (d_inner, width).
    ``state``: (B, width-1, d_inner), the trailing context of the
    previous segment (decode).  Returns (y, new_state)."""
    bsz, s, d_inner = x.shape
    width = w.shape[1]
    if state is None:
        pad = x.new_zeros((bsz, width - 1, d_inner))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                   # (B, S+width-1, d)
    y = 0
    for i in range(width):                            # width 4: unrolled
        y = y + xp[:, i:i + s, :] * w[None, None, :, i].to(x.dtype)
    y = y + b.to(x.dtype)[None, None, :]
    return y, (xp[:, s:, :] if width > 1 else None)


def _conv_tail(x: torch.Tensor, width: int) -> torch.Tensor:
    """The last ``width - 1`` rows of x (B, S, d), zero-padded on the
    left when S is shorter: the causal conv's decode state after x."""
    w, s = width - 1, x.shape[1]
    tail = x[:, s - w:, :] if s >= w else F.pad(x, (0, 0, w - s, 0))
    return tail.contiguous()


def _ssm_inputs(p, x_c: torch.Tensor, cfg: ModelConfig):
    """(B, S, di) conv output -> (dt f32, b f32, c f32, A f32)."""
    _, n, _, dt_rank = _dims(cfg)
    proj = x_c @ p["x_proj"].to(x_c.dtype)            # (B, S, rank + 2n)
    dt_r = proj[..., :dt_rank]
    b_ssm = proj[..., dt_rank:dt_rank + n].float()
    c_ssm = proj[..., dt_rank + n:].float()
    dt = F.softplus(dt_r.float() @ p["dt_proj"].float()
                    + p["dt_bias"].float()[None, None])
    return dt, b_ssm, c_ssm, -torch.exp(p["a_log"].float())


def apply_mamba(p, x: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False, plain: bool = False):
    """Full-sequence mamba mixer.  x: (B, S, d) -> (y (B, S, d), h_T)
    or, with ``return_cache``, (y, {"h", "conv"}), the decode state after
    the sequence.  ``plain`` takes the scan's plain version on any
    device."""
    d_inner, _, d_conv, _ = _dims(cfg)
    xd = x.dtype
    xz = x @ p["in_proj"].to(xd)                      # (B, S, 2 di)
    x_in, z = xz[..., :d_inner], xz[..., d_inner:]
    x_c, _ = _causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_c = F.silu(x_c.float()).to(xd)
    dt, b_ssm, c_ssm, a = _ssm_inputs(p, x_c, cfg)
    y, h_t = sharded_mamba_scan(x_c, dt.to(xd), a, b_ssm.to(xd),
                                c_ssm.to(xd), p["d_skip"].float(),
                                plain=plain)
    y = y.float() * F.silu(z.float())
    out = y.to(xd) @ p["out_proj"].to(xd)
    if not return_cache:
        return out, h_t
    return out, {"h": h_t, "conv": _conv_tail(x_in, d_conv)}


def mamba_cache(cfg: ModelConfig, batch: int, dtype,
                device) -> Dict[str, torch.Tensor]:
    """Zeroed decode state: ``h`` (B, d_inner, d_state) f32 and the conv
    tail ``conv`` (B, d_conv - 1, d_inner) in the compute dtype."""
    d_inner, n, d_conv, _ = _dims(cfg)
    return {"h": torch.zeros((batch, d_inner, n), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype,
                                device=device)}


def decode_mamba(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig) -> torch.Tensor:
    """One-token step, x: (B, 1, d), for every slot.  The new ``h`` and
    ``conv`` are written into ``cache`` IN PLACE (the reference returns
    fresh ones); returns out (B, 1, d)."""
    xd = x.dtype
    d_inner = _dims(cfg)[0]
    xz = x @ p["in_proj"].to(xd)
    x_in, z = xz[..., :d_inner], xz[..., d_inner:]
    x_c, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    x_c = F.silu(x_c.float()).to(xd)
    dt, b_ssm, c_ssm, a = _ssm_inputs(p, x_c, cfg)
    dt, b_ssm, c_ssm = dt[:, 0], b_ssm[:, 0], c_ssm[:, 0]   # (B, di|n)
    xt = x_c.float()[:, 0]                                  # (B, di)
    decay = torch.exp(a[None] * dt[:, :, None])             # (B, di, n)
    h = decay * cache["h"] + (dt * xt)[:, :, None] * b_ssm[:, None, :]
    y = torch.einsum("bdn,bn->bd", h, c_ssm) + p["d_skip"].float()[None] * xt
    y = y * F.silu(z.float()[:, 0])
    out = (y.to(xd) @ p["out_proj"].to(xd))[:, None, :]
    cache["h"].copy_(h)
    cache["conv"].copy_(conv_state)
    return out
