"""internvl2-26b [vlm] — arXiv:2404.16821 (hf-verified).

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92553.
InternViT frontend is a STUB (input_specs provides patch embeddings,
prepended to the token stream); backbone is InternLM2-20B-style.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92553,
    layer_pattern=("global",),
    frontend="vision",
    frontend_tokens=256,
    supports_long_context=False,
)
