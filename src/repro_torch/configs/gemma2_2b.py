"""gemma2-2b [dense] — arXiv:2408.00118 (hf-verified).

26L d_model=2304 8H (GQA kv=4) d_ff=9216 vocab=256000.
Alternating local(4096)/global attention, logit softcaps (attn 50,
final 30), sandwich norms, head_dim=256.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    num_heads=8,
    num_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern=("local", "global"),
    window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    use_post_norms=True,
    rms_weight_offset=1.0,
    embed_scale=True,
    mlp_activation="gelu",
    supports_long_context=False,   # half the layers are full attention
)
