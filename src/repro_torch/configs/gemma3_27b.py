"""gemma3-27b [dense] — hf:google/gemma-3-27b-pt family.

62L d_model=5376 32H (GQA kv=16) d_ff=21504 vocab=262144.
5:1 local:global attention (window 1024), qk-norm, sandwich norms,
head_dim=128.  62 = 6 x 10 + 2: the stack ends mid-cycle, on two local
layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    layer_pattern=("local", "local", "local", "local", "local", "global"),
    window=1024,
    use_qk_norm=True,
    use_post_norms=True,
    rms_weight_offset=1.0,
    embed_scale=True,
    mlp_activation="gelu",
    rope_theta=1_000_000.0,
    rope_theta_local=10_000.0,
    supports_long_context=True,
)
