"""Reduced same-family configs for CPU tests (``repro.configs.smoke``).

Same layer pattern, tiny widths, and the reference's window of 16 for
sliding-window configs.  The MoE/MLA/SSM/xLSTM shrink rules of the
reference arrive with the slices that port those families.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig


def smoke_config(arch_id: str, *, num_layers: int = 0) -> ModelConfig:
    cfg = get_config(arch_id)
    n = num_layers or 2 * len(cfg.layer_pattern)
    n = min(n, cfg.num_layers)
    kw = dict(num_layers=n, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=256)
    if cfg.window is not None:
        kw["window"] = 16
    return dataclasses.replace(cfg, **kw)
