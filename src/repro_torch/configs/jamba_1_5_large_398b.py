"""jamba-1.5-large-398b [hybrid] — arXiv:2403.19887 (hf-verified).

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Mamba:attention 7:1 interleave (8-layer blocks, attn first), MoE 16e
top-2 on every other layer.  Hybrid/recurrent -> long_500k runs.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    layer_pattern=("attn", "mamba", "mamba", "mamba",
                   "mamba", "mamba", "mamba", "mamba"),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576),
    moe_layers="every_2",
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
    supports_long_context=True,
)
