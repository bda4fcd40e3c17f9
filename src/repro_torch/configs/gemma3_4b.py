"""gemma3-4b [dense] — hf:google/gemma-3-4b-pt family.

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144.
5:1 local:global (window 1024), qk-norm, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    num_layers=34,
    d_model=2560,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=10240,
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
