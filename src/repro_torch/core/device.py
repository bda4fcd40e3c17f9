"""Device choice: the port's counterpart of ``repro.core.context``.

The reference picks a lowering target (tpu / interpret / generic) from
the JAX backend.  The port has one rule instead: entry points run on
the CUDA device unless the caller names another device, and a missing
card is an error, never a silent fall back to the CPU.  Kernel wrappers
then dispatch on the device of the tensors they are handed
(``kernels/*/ops.py``): a CPU tensor takes the plain PyTorch version, a
CUDA tensor takes the hand-written kernel.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means the CUDA device; raises when it is asked for and
    no card is present."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    return dev


def dtype_of(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    try:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]
    except KeyError:
        raise NotImplementedError(
            f"compute dtype {name!r} is not ported (bfloat16, float32)"
        ) from None
