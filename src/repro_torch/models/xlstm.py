"""xLSTM blocks (``repro.models.xlstm``, arXiv:2405.04517), used by
xlstm-1.3b: mLSTM (matrix memory, whose full-sequence recurrence runs
the mLSTM scan kernel ``kernels/mlstm_scan`` through
``sharding/kernel_sharding.py``) and sLSTM (scalar memory with recurrent
gate mixing across each head: inherently sequential, a loop over time
in plain PyTorch, as the reference's is a ``lax.scan`` outside any
kernel).

Both are residually wrapped mixers that subsume the feed-forward (d_ff
= 0 in the config):
  mLSTM block: up-proj (x2) -> conv4/silu -> q,k,v -> mLSTM cell
               -> per-head norm -> gate with silu(z) -> down-proj.
  sLSTM block: conv4/silu -> 4 gates (input + per-head recurrent)
               -> cell -> per-head norm -> gated FFN (factor 4/3).

The prefill with a cache takes the scan's final state from the kernel
itself on the card (the TPU kernel has no state output, so the
reference runs its plain scan there); the one-token decode steps are
the closed-form recurrences in plain PyTorch, as in the reference, and
write the new state into the cache IN PLACE.

Parameters the reference computes with in f32 rather than casting at
use stay f32 whatever the compute dtype (``F32_PARAMS``): the mLSTM
gate projections ``w_i``/``w_f`` and biases ``b_i``/``b_f``, and the
sLSTM gate weights ``w_gates``, ``r_gates`` and ``b_gates``.  The
others are stored in the compute dtype.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.ssm import _causal_conv, _conv_tail
from repro_torch.sharding.kernel_sharding import sharded_mlstm_scan

#: Parameters kept in f32 (the reference computes with them in f32).
F32_PARAMS = ("w_i", "w_f", "b_i", "b_f", "w_gates", "r_gates", "b_gates")

#: The stabiliser of an empty decode state (``repro`` xlstm.py:125,
#: :217); the full-sequence scan starts at -inf instead, and both give
#: the same first step (f' = 0, i' = 1).
M_EMPTY = -1e30


# ------------------------------------------------------------- mLSTM ----

def _mlstm_dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    x = cfg.xlstm
    d_inner = int(cfg.d_model * x.proj_factor_mlstm)
    return d_inner, x.num_heads, d_inner // x.num_heads


def init_mlstm(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    """The reference's laws: projections normal / sqrt(fan_in), the
    forget-gate bias at 3 (long memory at init), the rest at 0."""
    d, width = cfg.d_model, cfg.xlstm.conv_width
    d_inner, h, _ = _mlstm_dims(cfg)
    dev, f32 = gen.device, torch.float32

    def dense(shape, dt=dtype, fan_in=None):
        return L.dense_init(gen, shape, dtype=dt, in_axis_size=fan_in)

    return {
        "w_up1": dense((d, d_inner)),                      # x branch
        "w_up2": dense((d, d_inner)),                      # z gate
        "conv_w": dense((d_inner, width), fan_in=width),
        "conv_b": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "wq": dense((d_inner, d_inner), fan_in=d_inner),
        "wk": dense((d_inner, d_inner), fan_in=d_inner),
        "wv": dense((d_inner, d_inner), fan_in=d_inner),
        "w_i": dense((d_inner, h), f32, d_inner),
        "w_f": dense((d_inner, h), f32, d_inner),
        "b_i": torch.zeros((h,), dtype=f32, device=dev),
        "b_f": torch.full((h,), 3.0, dtype=f32, device=dev),
        "head_norm": torch.zeros((d_inner,), dtype=dtype, device=dev),
        "w_down": dense((d_inner, d), fan_in=d_inner),
    }


def _mlstm_qkvif(p, x_c: torch.Tensor, x_in: torch.Tensor,
                 cfg: ModelConfig):
    """Conv output -> per-head q, k, v (B, H, S, dh) in the compute
    dtype and the scalar gates i, f (B, H, S) in f32."""
    _, h, dh = _mlstm_dims(cfg)
    xd = x_c.dtype
    b, s, _ = x_c.shape

    def heads(t):
        return t.view(b, s, h, dh).transpose(1, 2)

    q = heads(x_c @ p["wq"].to(xd))
    k = heads(x_c @ p["wk"].to(xd))
    v = heads(x_in @ p["wv"].to(xd))       # v from the pre-conv branch
    xf = x_c.float()
    ig = (xf @ p["w_i"].float() + p["b_i"].float()).transpose(1, 2)
    fg = (xf @ p["w_f"].float() + p["b_f"].float()).transpose(1, 2)
    return q, k, v, ig, fg


def _mlstm_out(p, hid: torch.Tensor, z: torch.Tensor, *,
               plain: bool) -> torch.Tensor:
    """Per-head norm (offset 1), the silu(z) gate in f32, down-proj."""
    xd = z.dtype
    hid = L.apply_norm(p["head_norm"], hid.to(xd), plain=plain)
    hid = hid.float() * F.silu(z.float())
    return hid.to(xd) @ p["w_down"].to(xd)


def apply_mlstm(p, x: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False, plain: bool = False):
    """Full-sequence mLSTM block body (the caller adds the pre-norm
    residual).  x: (B, S, d) -> out, or with ``return_cache`` (out,
    {"C", "n", "m", "conv"}), the decode state after the sequence.
    ``plain`` takes the scan's plain version on any device."""
    d_inner, _, _ = _mlstm_dims(cfg)
    xd = x.dtype
    b, s, _ = x.shape
    x_in = x @ p["w_up1"].to(xd)                       # (B, S, di)
    z = x @ p["w_up2"].to(xd)
    x_c, _ = _causal_conv(x_in, p["conv_w"], p["conv_b"])
    x_c = F.silu(x_c.float()).to(xd)
    q, k, v, ig, fg = _mlstm_qkvif(p, x_c, x_in, cfg)
    res = sharded_mlstm_scan(q, k, v, ig, fg, return_state=return_cache,
                             plain=plain)
    hid, state = res if return_cache else (res, None)
    out = _mlstm_out(p, hid.transpose(1, 2).reshape(b, s, d_inner), z,
                     plain=plain)
    if not return_cache:
        return out
    c_t, n_t, m_t = state
    return out, {"C": c_t, "n": n_t, "m": m_t,
                 "conv": _conv_tail(x_in, cfg.xlstm.conv_width)}


def mlstm_cache(cfg: ModelConfig, batch: int, dtype,
                device) -> Dict[str, torch.Tensor]:
    """Empty decode state: ``C`` (B, H, dh, dh), ``n`` (B, H, dh) and
    ``m`` (B, H) in f32 (m at ``M_EMPTY``), the conv tail ``conv`` (B,
    width - 1, d_inner) in the compute dtype."""
    d_inner, h, dh = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), M_EMPTY, **f32),
            "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, d_inner),
                                dtype=dtype, device=device)}


def decode_mlstm(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, plain: bool = False) -> torch.Tensor:
    """One-token step, x: (B, 1, d), for every slot.  The new state is
    written into ``cache`` IN PLACE (C and n updated where they lie,
    with the reference's operations in its order); returns out (B, 1,
    d)."""
    d_inner, _, dh = _mlstm_dims(cfg)
    xd = x.dtype
    b = x.shape[0]
    x_in = x @ p["w_up1"].to(xd)
    z = x @ p["w_up2"].to(xd)
    x_c, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"],
                                   state=cache["conv"])
    x_c = F.silu(x_c.float()).to(xd)
    q, k, v, ig, fg = _mlstm_qkvif(p, x_c, x_in, cfg)
    scale = dh ** -0.5
    qt = q.float()[:, :, 0] * scale                    # (B, H, dh)
    kt = k.float()[:, :, 0] * scale
    vt = v.float()[:, :, 0]
    it, ft = ig[:, :, 0], F.logsigmoid(fg[:, :, 0])
    m = cache["m"]
    m_new = torch.maximum(ft + m, it)
    i_p = torch.exp(it - m_new)
    f_p = torch.exp(ft + m - m_new)
    c = cache["C"].mul_(f_p[..., None, None]).add_(
        i_p[..., None, None] * (kt[..., :, None] * vt[..., None, :]))
    n = cache["n"].mul_(f_p[..., None]).add_(i_p[..., None] * kt)
    num = torch.einsum("bhkv,bhk->bhv", c, qt)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n, qt).abs(),
                        torch.exp(-m_new))
    hid = (num / den[..., None]).reshape(b, 1, d_inner)
    m.copy_(m_new)
    cache["conv"].copy_(conv_state)
    return _mlstm_out(p, hid, z, plain=plain)


# ------------------------------------------------------------- sLSTM ----

def _slstm_dims(cfg: ModelConfig) -> Tuple[int, int]:
    h = cfg.xlstm.num_heads
    return h, cfg.d_model // h


def init_slstm(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    """The reference's laws, its fan-ins included: ``w_gates`` (4, d, d)
    is drawn with fan-in 4 (its leading axis), ``r_gates`` with the
    head's width; the forget-gate bias at 3."""
    d, width = cfg.d_model, cfg.xlstm.conv_width
    h, dh = _slstm_dims(cfg)
    dev, f32 = gen.device, torch.float32
    ff = int(d * cfg.xlstm.proj_factor_slstm)
    b_gates = torch.zeros((4, d), dtype=f32, device=dev)
    b_gates[1] = 3.0
    return {
        "conv_w": L.dense_init(gen, (d, width), dtype=dtype,
                               in_axis_size=width),
        "conv_b": torch.zeros((d,), dtype=dtype, device=dev),
        "w_gates": L.dense_init(gen, (4, d, d), dtype=f32),   # i, f, z, o
        "r_gates": L.dense_init(gen, (4, h, dh, dh), dtype=f32,
                                in_axis_size=dh),
        "b_gates": b_gates,
        "head_norm": torch.zeros((d,), dtype=dtype, device=dev),
        "ffn": L.init_mlp(gen, d, ff, dtype=dtype),
    }


def _slstm_cell(gates: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
                m: torch.Tensor):
    """gates: (4, B, d) pre-activations (recurrent term added) ->
    (c, n, m, h), all (B, d) f32."""
    i_t, f_t, z_t, o_t = gates
    log_f = F.logsigmoid(f_t)
    m_new = torch.maximum(log_f + m, i_t)
    i_p = torch.exp(i_t - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_t)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_t) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, m_new, h_new


def _slstm_recurrent(r_gates: torch.Tensor, h_prev: torch.Tensor,
                     h: int, dh: int) -> torch.Tensor:
    """Per-head recurrent contribution of h_prev (B, d): (4, B, d)."""
    b = h_prev.shape[0]
    hh = h_prev.reshape(b, h, dh)
    return torch.einsum("bhk,ghkl->gbhl", hh, r_gates).reshape(4, b, h * dh)


def _slstm_inputs(p, x: torch.Tensor, conv_state=None):
    """conv4/silu, then the input contributions of all four gates in f32
    with their biases: (4, B, S, d), and the conv's new state."""
    xd = x.dtype
    x_c, conv_new = _causal_conv(x, p["conv_w"], p["conv_b"],
                                 state=conv_state)
    x_c = F.silu(x_c.float()).to(xd)
    gates = torch.einsum("bsd,gdk->gbsk", x_c.float(), p["w_gates"].float())
    return gates + p["b_gates"].float()[:, None, None, :], conv_new


def _slstm_out(p, hid: torch.Tensor, xd, *, plain: bool) -> torch.Tensor:
    hid = L.apply_norm(p["head_norm"], hid.to(xd), plain=plain)
    return hid + L.apply_mlp(p["ffn"], hid, "gelu")


def apply_slstm(p, x: torch.Tensor, cfg: ModelConfig, *,
                return_cache: bool = False, plain: bool = False):
    """Full-sequence sLSTM block body, one step at a time.  x: (B, S, d)
    -> out, or with ``return_cache`` (out, {"c", "n", "m", "h",
    "conv"})."""
    h, dh = _slstm_dims(cfg)
    b, s, d = x.shape
    gates_in, _ = _slstm_inputs(p, x)
    r = p["r_gates"].float()
    f32 = dict(dtype=torch.float32, device=x.device)
    c, n, hs = (torch.zeros((b, d), **f32) for _ in range(3))
    m = torch.full((b, d), M_EMPTY, **f32)
    outs = []
    for t in range(s):
        c, n, m, hs = _slstm_cell(gates_in[:, :, t]
                                  + _slstm_recurrent(r, hs, h, dh), c, n, m)
        outs.append(hs)
    out = _slstm_out(p, torch.stack(outs, dim=1), x.dtype, plain=plain)
    if not return_cache:
        return out
    return out, {"c": c, "n": n, "m": m, "h": hs,
                 "conv": _conv_tail(x, cfg.xlstm.conv_width)}


def slstm_cache(cfg: ModelConfig, batch: int, dtype,
                device) -> Dict[str, torch.Tensor]:
    """Empty decode state: ``c``, ``n``, ``m`` (at ``M_EMPTY``) and
    ``h``, each (B, d) f32, and the conv tail ``conv`` (B, width - 1,
    d) in the compute dtype."""
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "m": torch.full((batch, d), M_EMPTY, **f32),
            "h": torch.zeros((batch, d), **f32),
            "conv": torch.zeros((batch, cfg.xlstm.conv_width - 1, d),
                                dtype=dtype, device=device)}


def decode_slstm(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, plain: bool = False) -> torch.Tensor:
    """One-token step, x: (B, 1, d), for every slot; the new state is
    written into ``cache`` IN PLACE.  Returns out (B, 1, d)."""
    h, dh = _slstm_dims(cfg)
    gates, conv_state = _slstm_inputs(p, x, cache["conv"])
    rec = _slstm_recurrent(p["r_gates"].float(), cache["h"], h, dh)
    c, n, m, h_new = _slstm_cell(gates[:, :, 0] + rec, cache["c"],
                                 cache["n"], cache["m"])
    for name, new in (("c", c), ("n", n), ("m", m), ("h", h_new),
                      ("conv", conv_state)):
        cache[name].copy_(new)
    return _slstm_out(p, h_new[:, None, :], x.dtype, plain=plain)
