"""Architecture registry: ``--arch <id>`` resolves here.

The port carries the dense GQA decoder (granite-8b), the local/global
sliding-window decoder (gemma2-2b), the MLA + MoE decoder
(deepseek-v2-lite-16b), the attention/mamba hybrid with MoE on every
other layer (jamba-1.5-large-398b), the recurrent xLSTM stack of mLSTM
and sLSTM blocks (xlstm-1.3b) and the GQA decoder with 128 experts and
a dense residual MLP on every layer (arctic-480b) and the 5:1
local/global decoder with qk-norm and a local RoPE base (gemma3-4b,
gemma3-27b), the encoder-decoder with cross-attention and an ungated
GELU MLP (whisper-base) and the GQA decoder whose first positions carry
patch embeddings (internvl2-26b): all ten of the reference's
architectures.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

_MODULES = {"granite-8b": "granite_8b", "gemma2-2b": "gemma2_2b",
            "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
            "jamba-1.5-large-398b": "jamba_1_5_large_398b",
            "xlstm-1.3b": "xlstm_1_3b", "arctic-480b": "arctic_480b",
            "gemma3-4b": "gemma3_4b", "gemma3-27b": "gemma3_27b",
            "whisper-base": "whisper_base", "internvl2-26b": "internvl2_26b"}

#: Architectures of the reference that later slices of the port add:
#: none are left.
LATER_SLICES = ()


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG
