"""arctic-480b [moe] — hf:Snowflake/snowflake-arctic-base (hf-verified).

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000.
128 routed experts top-2 PLUS an always-on dense residual MLP
(dense-MoE hybrid), every layer.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    head_dim=128,
    d_ff=4864,               # dense-residual MLP width
    vocab_size=32000,
    layer_pattern=("global",),
    moe=MoEConfig(num_experts=128, top_k=2, d_ff_expert=4864,
                  dense_residual=True),
    moe_layers="all",
    supports_long_context=False,
)
