"""deepseek-v2-lite-16b [moe] — arXiv:2405.04434 (hf-verified).

27L d_model=2048 16H (MLA) moe-d_ff=1408 vocab=102400.
MLA kv_lora=512; 2 shared + 64 routed experts, top-6.  The first layer
is dense (d_ff=10944 per the HF config); the rest are MoE.
"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,            # MLA v_head_dim; qk dims in MLAConfig
    d_ff=10944,              # dense first layer (HF: intermediate_size)
    vocab_size=102400,
    layer_pattern=("global",),
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128,
                  qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=2 * 1408),
    moe_layers="all_but_first",
    rope_theta=10_000.0,
    supports_long_context=False,   # full (MLA) attention
)
