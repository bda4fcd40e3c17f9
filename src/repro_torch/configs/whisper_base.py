"""whisper-base [audio] — arXiv:2212.04356.

6L enc + 6L dec, d_model=512 8H d_ff=2048 vocab=51865.
The conv/mel frontend is a STUB: input_specs feeds precomputed frame
embeddings to the encoder (per the brief).  Ungated GELU MLPs.
Positional handling adapted to RoPE (DESIGN.md §7).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,            # decoder layers
    encoder_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    layer_pattern=("global",),
    mlp_activation="gelu_ungated",
    frontend="audio",
    supports_long_context=False,
)
