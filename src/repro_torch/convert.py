"""Carry ``repro`` (JAX) parameters over to the port's layout.

The caller turns the JAX tree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
no JAX.  The tree is ``embed.table``, ``unembed.table``, ``final_norm``
and the segments of ``plan_segments``: segment ``i`` holds one leaf
dict per position of its block, each leaf with a leading ``reps`` axis,
so layer ``r * len(block) + j`` of the segment is position ``j`` at
index ``r`` (granite: one segment of one global layer repeated 36
times; gemma2: a (local, global) block repeated 13 times, with the
sandwich norms ``post_ln1``/``post_ln2``; gemma3: a block of five local
layers and one global repeated, then the tail (34 = 5 x 6 + 4, 62 = 10
x 6 + 2), each ``attn`` leaf with its qk-norm weights ``q_norm`` and
``k_norm`` (head_dim,); deepseek: a dense first MLA
layer, then one MLA + MoE layer repeated 26 times, its ``moe`` leaf
holding the router, the stacked expert weights and the shared
experts' MLP; jamba: the 8-layer block of one attention and seven mamba
layers, MoE on the odd positions (``every_2``), repeated, then the
tail, each mamba layer's ``mamba`` leaf holding its projections, conv
and SSM parameters; xlstm: the 8-layer block of seven mLSTM layers and
one sLSTM layer, repeated, each with ``ln1`` and its ``mlstm`` or
``slstm`` leaf and no FFN sublayer, the sLSTM's gated FFN under
``ffn``; whisper: one decoder layer repeated, each with ``ln_cross`` and
its ``cross_attn`` leaf and an MLP without ``w_gate``, and
``encoder.segments`` (one global layer repeated, in the encoder's
``plan_segments``) with ``encoder.final_norm``; internvl2: granite's
layout).  The router, mamba's ``ssm.F32_PARAMS`` and the xLSTM gates'
``xlstm.F32_PARAMS`` stay in f32, as the reference computes with them.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models import ssm, xlstm
from repro_torch.models.transformer import plan_segments


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)

    def t(a, shape=None, dtype=None):
        a = np.array(a, dtype=np.float32)          # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a).to(dev, dtype or dt)

    d, hd = cfg.d_model, cfg.head_dim
    norms = ("ln1", "ln_cross", "ln2") + (("post_ln1", "post_ln2")
                                          if cfg.use_post_norms else ())

    def mlp(m, r):
        return {w: t(m[w][r]) for w in ("w_gate", "w_up", "w_down")
                if w in m}

    def attn(a, r):
        if cfg.mla is None:
            p = {"wq": t(a["wq"][r], (d, cfg.num_heads * hd)),
                 "wk": t(a["wk"][r], (d, cfg.num_kv_heads * hd)),
                 "wv": t(a["wv"][r], (d, cfg.num_kv_heads * hd)),
                 "wo": t(a["wo"][r], (cfg.num_heads * hd, d))}
            for name in ("q_norm", "k_norm"):
                if name in a:
                    p[name] = t(a[name][r])
            return p
        lora = cfg.mla.kv_lora_rank
        return {"wq_mla": t(a["wq_mla"][r], (d, -1)),
                "wkv_a": t(a["wkv_a"][r]),
                "wkv_b": t(a["wkv_b"][r], (lora, -1)),
                "wo_mla": t(a["wo_mla"][r], (-1, d))}

    def moe(m, r):
        p = {"router": t(m["router"][r], dtype=torch.float32),
             **{w: t(m[w][r]) for w in ("we_gate", "we_up", "we_down")}}
        for name in ("shared", "dense"):
            if name in m:
                p[name] = mlp(m[name], r)
        return p

    def mixer(m, r, f32_params):
        """A recurrent layer's leaves (an sLSTM's ``ffn`` is an MLP)."""
        return {name: mlp(leaf, r) if isinstance(leaf, dict) else
                t(leaf[r], dtype=torch.float32 if name in f32_params
                  else None) for name, leaf in m.items()}

    def layers(segments, plans, n_layers):
        if (len(segments) != len(plans)
                or [len(s) for s in segments]
                != [len(p.block) for p in plans]):
            raise ValueError(
                f"expected segments of {[len(p.block) for p in plans]} "
                f"block positions for {cfg.name}, got "
                f"{[len(s) for s in segments]}")
        out = []
        for seg, plan in zip(segments, plans):
            n = np.asarray(seg[0]["ln1"]).shape[0]
            if n != plan.reps:
                raise ValueError(f"tree holds {n} repeats of a segment, "
                                 f"config {n_layers} layers ({plan.reps})")
            for r in range(n):
                for blk in seg:
                    out.append(layer(blk, r))
        return out

    def layer(blk, r):
        out = {name: t(blk[name][r]) for name in norms if name in blk}
        if "mamba" in blk:
            out["mamba"] = mixer(blk["mamba"], r, ssm.F32_PARAMS)
        elif "mlstm" in blk or "slstm" in blk:
            kind = "mlstm" if "mlstm" in blk else "slstm"
            out[kind] = mixer(blk[kind], r, xlstm.F32_PARAMS)
        else:
            out["attn"] = attn(blk["attn"], r)
        if "cross_attn" in blk:
            out["cross_attn"] = attn(blk["cross_attn"], r)
        if "moe" in blk:
            out["moe"] = moe(blk["moe"], r)
        elif "mlp" in blk:
            out["mlp"] = mlp(blk["mlp"], r)
        return out

    params = {"embed": t(tree["embed"]["table"]),
              "unembed": t(tree["unembed"]["table"]),
              "final_norm": t(tree["final_norm"]),
              "layers": layers(tree["segments"], plan_segments(cfg),
                               cfg.num_layers)}
    if cfg.is_encoder_decoder:
        enc = tree["encoder"]
        params["encoder"] = {
            "layers": layers(enc["segments"],
                             plan_segments(cfg, encoder=True),
                             cfg.encoder_layers),
            "final_norm": t(enc["final_norm"])}
    return params
