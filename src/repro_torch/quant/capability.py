"""Which KV-cache dtypes a device can hold (``repro.quant.capability``).

The reference asks a variant-dispatched query per TPU generation; the
port has one card family and one rule instead:

* a CUDA device of compute capability (8, 9) or higher (Ada, Hopper)
  holds bf16, int8 and fp8-e4m3 (native e4m3 conversions);
* an older CUDA device holds bf16 and int8;
* the CPU holds all three when torch has ``float8_e4m3fn``, as the
  reference's interpret variant does: the plain versions emulate fp8
  through torch's software conversion.

Callers that need a fallback walk :data:`FALLBACK` (fp8 -> int8 ->
bf16) until they reach a dtype the device holds (``spec.resolve_kv_spec``).
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["KV_DTYPES", "FALLBACK", "FP8_MIN_CAPABILITY",
           "dtypes_for_capability", "kv_cache_dtypes"]

#: Every dtype the subsystem knows how to store, widest first.
KV_DTYPES = ("bf16", "int8", "fp8_e4m3")

#: Degradation chain when a device lacks the requested dtype.
FALLBACK = {"fp8_e4m3": "int8", "int8": "bf16"}

#: The first CUDA compute capability with e4m3 conversions in hardware.
FP8_MIN_CAPABILITY = (8, 9)

_HOST_HAS_FP8 = hasattr(torch, "float8_e4m3fn")


def dtypes_for_capability(capability: Tuple[int, int]) -> Tuple[str, ...]:
    """The KV dtypes a CUDA device of compute ``capability`` holds."""
    if tuple(capability) >= FP8_MIN_CAPABILITY:
        return KV_DTYPES
    return ("bf16", "int8")


def kv_cache_dtypes(device=None) -> Tuple[str, ...]:
    """The KV dtypes ``device`` holds (default: the current CUDA device)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return KV_DTYPES if _HOST_HAS_FP8 else ("bf16", "int8")
    if dev.type != "cuda":
        raise ValueError(f"no KV dtype rule for device {dev}")
    return dtypes_for_capability(torch.cuda.get_device_capability(dev))
