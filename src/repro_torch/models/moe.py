"""Mixture-of-Experts (``repro.models.moe``): the single-device path.

Tokens are routed with a capacity-bounded scatter, as the reference
does (DESIGN.md §5): no (T, E, C) one-hot dispatch tensor; each
assignment's place in its expert's queue comes from running counts,
slot-major (every token's first choice before any second choice), and
one index-add per choice writes the tokens into an (E * C + 1, d)
buffer whose last row is the sentinel that dropped assignments land in.
The experts run as three grouped matmuls (``kernels/gmm``) over the
whole capacity, and each token sums its top-k expert outputs, weighted
by its renormalised gates, in f32 in top-k order.

Which assignments drop depends on the capacity, and so on the number
of tokens in the call: group size x prompt length at prefill, every
slot (idle ones too) at decode.  Every step is a device op: no boolean
indexing, ``nonzero`` or ``.item()``, so a call never waits for the
card.

DeepSeek's always-on shared experts are one wider gated MLP beside the
routed ones; arctic's dense residual MLP is another.  With
``return_aux`` a call also returns the load-balance and router z losses
of its tokens (the reference's ``_aux_losses``), which the training
loss weighs in; the expert-parallel mesh path arrives with
distribution (ROADMAP.md, queue A).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.gmm import ref as gmm_ref
from repro_torch.kernels.gmm.ops import gmm
from repro_torch.models import layers as L

# The running count of dropped assignments, when one is kept
# (``count_drops``): a tensor on the card, added to by every MoE call.
_drops: Optional[torch.Tensor] = None


def count_drops(device) -> torch.Tensor:
    """Start counting the assignments that capacity drops, on
    ``device``: returns a zeroed 0-d int64 tensor that every later MoE
    call on that device adds its drops to (no sync; read it when the
    run is over) until ``stop_counting_drops``."""
    global _drops
    _drops = torch.zeros((), dtype=torch.int64, device=device)
    return _drops


def stop_counting_drops() -> None:
    global _drops
    _drops = None


# ------------------------------------------------------------- params ---

def _expert_stack(gen: torch.Generator, e: int, shape, *, dtype,
                  in_axis_size: int) -> torch.Tensor:
    """(E, *shape) weights drawn expert by expert: the f32 draw of a
    whole stack would be a transient twice the stack's bf16 size (12.9
    GB for one of jamba's)."""
    w = torch.empty((e, *shape), dtype=dtype, device=gen.device)
    for i in range(e):
        w[i] = L.dense_init(gen, shape, dtype=dtype,
                            in_axis_size=in_axis_size)
    return w


def init_moe(gen: torch.Generator, cfg: ModelConfig, *, dtype):
    """The reference's laws (normal / sqrt(fan_in)).  The router stays
    in f32, as the reference computes with it (routing is where a bf16
    rounding would change which expert a token reaches)."""
    m = cfg.moe
    d, e, ff = cfg.d_model, m.num_experts, m.d_ff_expert
    p = {"router": L.dense_init(gen, (d, e), dtype=torch.float32),
         "we_gate": _expert_stack(gen, e, (d, ff), dtype=dtype,
                                  in_axis_size=d),
         "we_up": _expert_stack(gen, e, (d, ff), dtype=dtype,
                                in_axis_size=d),
         "we_down": _expert_stack(gen, e, (ff, d), dtype=dtype,
                                  in_axis_size=ff)}
    if m.num_shared_experts > 0:
        p["shared"] = L.init_mlp(gen, d, m.d_ff_shared, dtype=dtype)
    if m.dense_residual:
        p["dense"] = L.init_mlp(gen, d, cfg.d_ff, dtype=dtype)
    return p


# -------------------------------------------------------- dispatch core --

def _capacity(tokens: int, e: int, k: int, cf: float) -> int:
    c = int(math.ceil(tokens * k / e * cf))
    return max(8, -(-c // 8) * 8)        # a multiple of 8, as the reference


def _route(router_w: torch.Tensor, x_flat: torch.Tensor, k: int):
    """x_flat (T, d) -> (gates (T, k) f32 renormalised over the top k,
    idx (T, k) expert ids), from f32 router logits."""
    probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
    gates, idx = torch.topk(probs, k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _one_hot(idx: torch.Tensor, e: int) -> torch.Tensor:
    """(T,) -> (T, E) int32, by comparison: ``F.one_hot`` checks its
    input's range on the host, a sync on the card."""
    return (idx[:, None] == torch.arange(e, device=idx.device)).to(
        torch.int32)


def _positions(idx: torch.Tensor, e: int):
    """Each assignment's position in its expert's queue, slot-major:
    choice j of every token queues after all choices < j.  Returns
    (pos (T, k), counts (E,))."""
    counts = torch.zeros((e,), dtype=torch.int32, device=idx.device)
    pos = []
    for j in range(idx.shape[1]):
        col = idx[:, j]
        oh = _one_hot(col, e)
        rank = torch.cumsum(oh, dim=0, dtype=torch.int32) - oh
        base = rank.gather(1, col[:, None])[:, 0]
        pos.append(base + counts[col])
        counts = counts + oh.sum(0, dtype=torch.int32)
    return torch.stack(pos, dim=1), counts


def _dests(idx: torch.Tensor, pos: torch.Tensor, c: int, e: int):
    """Flat buffer rows (the sentinel ``E * C`` for a dropped
    assignment) and the keep mask."""
    keep = pos < c
    n_rows = e * c
    dest = torch.where(keep, idx * c + pos, torch.full_like(idx, n_rows))
    return dest, keep, n_rows


def _scatter(x_flat: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """(T, d) tokens -> the (n_rows + 1, d) capacity buffer; kept rows
    are unique, dropped ones add zeros to the sentinel."""
    buf = torch.zeros((n_rows + 1, x_flat.shape[1]), dtype=x_flat.dtype,
                      device=x_flat.device)
    for j in range(dest.shape[1]):
        contrib = torch.where(keep[:, j:j + 1], x_flat,
                              torch.zeros_like(x_flat))
        buf.index_add_(0, dest[:, j], contrib)
    return buf


def _gather_combine(y_buf: torch.Tensor, gates: torch.Tensor,
                    dest: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """(n_rows + 1, d) expert outputs -> (T, d) f32 token outputs, the
    k contributions summed in top-k order."""
    out = None
    for j in range(dest.shape[1]):
        yj = y_buf[dest[:, j]].float()
        wj = torch.where(keep[:, j], gates[:, j], torch.zeros_like(gates[:, j]))
        term = yj * wj[:, None]
        out = term if out is None else out + term
    return out


def _expert_ffn(buf_e: torch.Tensor, wg, wu, wd, activation: str, *,
                plain: bool = False) -> torch.Tensor:
    """(E, C, d) -> (E, C, d): the gated FFN of every expert as three
    grouped matmuls over all C rows (padding rows are exact zeros and
    stay zero through the gated FFN, so no mask is needed); the
    activation in f32, cast back before the down projection."""
    e, c, _ = buf_e.shape
    gs = torch.full((e,), c, dtype=torch.int32, device=buf_e.device)
    fn = gmm_ref.gmm_ref if plain else gmm
    h_g = fn(buf_e, wg, gs)
    h_u = fn(buf_e, wu, gs)
    g32 = h_g.float()
    act = F.gelu(g32, approximate="tanh") if activation == "gelu" \
        else F.silu(g32)
    return fn((act * h_u.float()).to(buf_e.dtype), wd, gs)


def _aux_losses(router_w: torch.Tensor, x_flat: torch.Tensor,
                counts: torch.Tensor, e: int, k: int):
    """Switch-style load balance and the router z-loss of one call's
    tokens (``repro`` moe.py:173): e * sum(assignment share x mean
    router probability) over the experts, with every assignment counted
    (dropped ones too), and the mean squared logsumexp of the f32
    router logits."""
    logits = x_flat.float() @ router_w.float()
    frac = counts.float() / max(x_flat.shape[0] * k, 1)
    lb = e * (frac * torch.softmax(logits, dim=-1).mean(0)).sum()
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return {"load_balance": lb, "router_z": z}


def _moe_tokens_local(p, x_flat: torch.Tensor, cfg: ModelConfig, c: int, *,
                      plain: bool = False, return_aux: bool = False):
    m = cfg.moe
    e, k = m.num_experts, m.top_k
    gates, idx = _route(p["router"], x_flat, k)
    pos, counts = _positions(idx, e)
    dest, keep, n_rows = _dests(idx, pos, c, e)
    if _drops is not None and _drops.device == x_flat.device:
        _drops.add_((~keep).sum())
    buf = _scatter(x_flat, dest, keep, n_rows)
    xd = x_flat.dtype
    y_e = _expert_ffn(buf[:n_rows].view(e, c, -1), p["we_gate"].to(xd),
                      p["we_up"].to(xd), p["we_down"].to(xd),
                      cfg.mlp_activation, plain=plain)
    y_buf = torch.cat([y_e.reshape(n_rows, -1),
                       y_e.new_zeros((1, y_e.shape[-1]))])
    y = _gather_combine(y_buf, gates, dest, keep)
    if not return_aux:
        return y
    return y, _aux_losses(p["router"], x_flat, counts, e, k)


# ------------------------------------------------------------- public ---

def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, *,
              plain: bool = False, return_aux: bool = False):
    """x (B, S, d) -> (B, S, d): the routed experts at the capacity of
    B * S tokens, plus the shared experts or the dense residual MLP;
    with ``return_aux`` also the call's {"load_balance", "router_z"}.
    ``plain`` takes the grouped matmul's plain version on any device."""
    m = cfg.moe
    b, s, d = x.shape
    c = _capacity(b * s, m.num_experts, m.top_k, m.capacity_factor)
    res = _moe_tokens_local(p, x.reshape(b * s, d), cfg, c, plain=plain,
                            return_aux=return_aux)
    y_flat, aux = res if return_aux else (res, None)
    y = y_flat.view(b, s, d).to(x.dtype)
    if m.num_shared_experts > 0:
        y = y + L.apply_mlp(p["shared"], x, cfg.mlp_activation)
    if m.dense_residual:
        y = y + L.apply_mlp(p["dense"], x, cfg.mlp_activation)
    return (y, aux) if return_aux else y
