"""Architecture descriptions (a jax-free copy of ``repro.configs.base``).

Only the model description is kept; the dry-run shape cells and their
``ShapeDtypeStruct`` input specs stay in the JAX package.  The sub-
configs are kept so every ``ModelConfig`` field exists with its
reference meaning, even where this slice of the port rejects it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    dense_residual: bool = False
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.01


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    num_heads: int = 4
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 4.0 / 3.0
    conv_width: int = 4
    slstm_every: int = 8


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    layer_pattern: Tuple[str, ...] = ("global",)
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    use_qk_norm: bool = False
    use_post_norms: bool = False
    rms_weight_offset: float = 0.0
    rope_theta: float = 10_000.0
    rope_theta_local: Optional[float] = None
    mlp_activation: str = "silu"

    moe: Optional[MoEConfig] = None
    moe_layers: str = "none"
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None

    encoder_layers: int = 0
    frontend: Optional[str] = None
    frontend_tokens: int = 256

    embed_scale: bool = False
    dtype: str = "bfloat16"
    remat_policy: str = "full"

    supports_long_context: bool = False

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer kinds: the pattern cycles and truncates; 'attn' is
        an alias for 'global'."""
        reps = -(-self.num_layers // len(self.layer_pattern))
        kinds = (tuple(self.layer_pattern) * reps)[: self.num_layers]
        return tuple("global" if k == "attn" else k for k in kinds)

    def is_moe_layer(self, idx: int) -> bool:
        if self.moe is None or self.moe_layers == "none":
            return False
        if self.moe_layers == "all":
            return True
        if self.moe_layers == "every_2":
            return idx % 2 == 1
        if self.moe_layers == "all_but_first":
            return idx > 0
        raise ValueError(self.moe_layers)
