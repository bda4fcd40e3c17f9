"""Carry ``repro`` (JAX) parameters over to the port's layout.

The caller turns the JAX tree into numpy first
(``jax.tree_util.tree_map(np.asarray, params)``), so this module needs
no JAX.  A dense global-attention model's tree is ``embed.table``,
``unembed.table``, ``final_norm`` and one segment holding one block
whose leaves carry a leading ``reps = num_layers`` axis.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.transformer import plan_segments


def from_jax_params(tree: Dict[str, Any], cfg: ModelConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)

    def t(a, shape=None):
        a = np.array(a, dtype=np.float32)          # a writable copy
        if shape is not None:
            a = a.reshape(shape)
        return torch.from_numpy(a).to(dev, dt)

    segments = tree["segments"]
    plans = plan_segments(cfg)
    if (len(segments) != len(plans)
            or [len(s) for s in segments] != [len(p.block) for p in plans]):
        raise ValueError(f"expected {len(plans)} segment of one block for "
                         f"a dense global model, got {len(segments)}")
    blk = segments[0][0]
    n = np.asarray(blk["ln1"]).shape[0]
    if n != plans[0].reps:
        raise ValueError(f"tree holds {n} layers, config {cfg.num_layers}")
    d, hd = cfg.d_model, cfg.head_dim
    layers = []
    for i in range(n):
        a, m = blk["attn"], blk["mlp"]
        layers.append({
            "ln1": t(blk["ln1"][i]),
            "attn": {"wq": t(a["wq"][i], (d, cfg.num_heads * hd)),
                     "wk": t(a["wk"][i], (d, cfg.num_kv_heads * hd)),
                     "wv": t(a["wv"][i], (d, cfg.num_kv_heads * hd)),
                     "wo": t(a["wo"][i], (cfg.num_heads * hd, d))},
            "ln2": t(blk["ln2"][i]),
            "mlp": {"w_gate": t(m["w_gate"][i]), "w_up": t(m["w_up"][i]),
                    "w_down": t(m["w_down"][i])},
        })
    return {"embed": t(tree["embed"]["table"]),
            "unembed": t(tree["unembed"]["table"]),
            "final_norm": t(tree["final_norm"]),
            "layers": layers}
