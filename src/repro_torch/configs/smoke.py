"""Reduced same-family configs for CPU tests (``repro.configs.smoke``).

Same layer pattern, tiny widths, the reference's window of 16 for
sliding-window configs, 8 patch positions for a vision frontend, 2
encoder layers for an encoder-decoder, and its MLA, MoE, SSM and xLSTM
shrink rules (with the leading dense layer of ``moe_layers=
"all_but_first"`` kept).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig, XLSTMConfig)


def smoke_config(arch_id: str, *, num_layers: int = 0) -> ModelConfig:
    cfg = get_config(arch_id)
    # 2 pattern periods, +1 leading dense layer for "all_but_first"
    n = num_layers or (2 * len(cfg.layer_pattern)
                       + (1 if cfg.moe_layers == "all_but_first" else 0))
    n = min(n, cfg.num_layers)
    kw = dict(num_layers=n, d_model=64, num_heads=4, num_kv_heads=2,
              head_dim=16, d_ff=0 if cfg.d_ff == 0 else 128, vocab_size=256,
              frontend_tokens=(8 if cfg.frontend == "vision"
                               else cfg.frontend_tokens))
    if cfg.encoder_layers:
        kw["encoder_layers"] = 2
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
        kw["num_kv_heads"] = 4          # MLA is effectively MHA
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(
            num_experts=8, top_k=min(cfg.moe.top_k, 2), d_ff_expert=64,
            num_shared_experts=cfg.moe.num_shared_experts,
            d_ff_shared=128 if cfg.moe.num_shared_experts else 0,
            dense_residual=cfg.moe.dense_residual,
            capacity_factor=2.0)
    if cfg.ssm is not None:
        kw["ssm"] = SSMConfig(d_state=8, d_conv=4, expand=2)
    if cfg.xlstm is not None:
        kw["xlstm"] = XLSTMConfig(num_heads=2, conv_width=4)
    if cfg.window is not None:
        kw["window"] = 16
    return dataclasses.replace(cfg, **kw)
