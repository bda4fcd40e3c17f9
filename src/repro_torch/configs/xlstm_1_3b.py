"""xlstm-1.3b [ssm] — arXiv:2405.04517.

48L d_model=2048 4H d_ff=0 vocab=50304.  sLSTM + mLSTM blocks (7:1
mLSTM:sLSTM); d_ff=0 means the feed-forward is folded into the blocks
(up/down projections inside mLSTM, post-FFN factor 4/3 in sLSTM).
Fully recurrent -> long_500k runs (O(1) state per token).
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    head_dim=512,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=("mlstm", "mlstm", "mlstm", "mlstm",
                   "mlstm", "mlstm", "mlstm", "slstm"),
    xlstm=XLSTMConfig(num_heads=4, proj_factor_mlstm=2.0,
                      proj_factor_slstm=4.0 / 3.0, conv_width=4),
    supports_long_context=True,
)
