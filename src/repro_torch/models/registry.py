"""Model facade (``repro.models.registry``): one object per architecture
bundling init, the serving modes and the training loss (forward)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        T.check_supported(self.cfg)

    def init(self, generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Dict[str, Any]:
        """Random full-width weights on ``device`` (the CUDA device by
        default).  ``generator`` must live on that device; None seeds a
        fresh one with 0."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        if generator.device.type != dev.type:
            raise ValueError(f"generator on {generator.device}, weights "
                             f"asked on {dev}")
        return T.init_params(generator, self.cfg)

    def prefill(self, params, tokens, cache_len: int, extras=None, *,
                plain: bool = False):
        """(last-position logits, caches); ``extras`` the batch's stub
        inputs ("vision_embeds", "encoder_embeds"), as the reference's
        ``Model.prefill`` takes them."""
        return T.prefill(params, self.cfg, tokens, cache_len, extras,
                         plain=plain)

    def forward_logits(self, params, tokens, *, plain: bool = False,
                       start: int = 0):
        return T.forward_logits(params, self.cfg, tokens, plain=plain,
                                start=start)

    def loss(self, params, batch, *, plain: bool = False):
        """(loss, metrics) of a batch {"tokens", "labels"} (B, S) and
        the config's stub inputs ("vision_embeds", "encoder_embeds"):
        the training forward and its loss, without a backward (that
        arrives with training, ROADMAP.md queue A); metrics "loss",
        "ce", "z_loss", "load_balance" and "router_z", as the
        reference's."""
        with torch.no_grad():
            return T.forward_train(params, self.cfg, batch, plain=plain)

    def decode_step(self, params, caches, tokens, lengths,
                    block_tables=None, *, plain: bool = False):
        return T.decode_step(params, self.cfg, caches, tokens, lengths,
                             block_tables=block_tables, plain=plain)

    def spec_decode_step(self, params, caches, tokens, lengths,
                         block_tables, *, plain: bool = False):
        return T.spec_decode_step(params, self.cfg, caches, tokens, lengths,
                                  block_tables, plain=plain)

    def init_decode_caches(self, batch: int, cache_len: int,
                           device: DeviceLike = None, *,
                           enc_len: int = 0) -> List[Dict]:
        """Dense caches per layer kind: (B, Hkv, cache_len, hd), or the
        window's ring for a local layer whose window is shorter; an
        encoder-decoder's also hold the encoder's K/V of ``enc_len``
        rows."""
        return T.init_decode_caches(self.cfg, batch, cache_len,
                                    resolve_device(device), enc_len=enc_len)


def build_model(arch_or_cfg) -> Model:
    if isinstance(arch_or_cfg, ModelConfig):
        return Model(arch_or_cfg)
    return Model(get_config(arch_or_cfg))
