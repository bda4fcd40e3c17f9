"""KVQuantSpec: how a paged KV pool is stored, scaled and bounded
(``repro.quant.spec``).

A spec names the storage dtype, the quantization ceiling ``qmax`` and
the documented decode tolerance of one KV-cache dtype.  Scales are
per page per head: one f32 scale per ``(head, page)`` block of
``(page_size, head_dim)`` values, in a scale pool beside the KV pool
(``serve/paging.py``).  The decode write path re-quantizes the tail
page when a new row raises its absmax (``sharding/kernel_sharding.py``).
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch

from repro_torch.quant import blockwise
from repro_torch.quant.capability import FALLBACK, KV_DTYPES, kv_cache_dtypes

__all__ = ["KVQuantSpec", "resolve_kv_spec", "spec_for_storage",
           "DECODE_TOL"]

#: Documented absolute tolerance of quantized paged decode attention
#: against bf16, for unit-variance K/V: int8 per-page absmax keeps the
#: per-element error within absmax/254; fp8 e4m3 is relative (3
#: mantissa bits), so its bound is looser.
DECODE_TOL = {"int8": 0.05, "fp8_e4m3": 0.25}


@dataclasses.dataclass(frozen=True)
class KVQuantSpec:
    """Storage contract for one paged-KV dtype."""
    dtype: str                      # "bf16" | "int8" | "fp8_e4m3"
    storage: torch.dtype            # pool element dtype
    qmax: Optional[float]           # None = passthrough (no scales)

    @property
    def quantized(self) -> bool:
        return self.qmax is not None

    @property
    def scale_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def decode_tol(self) -> Optional[float]:
        return DECODE_TOL.get(self.dtype)

    def quantize_pages(self, x: torch.Tensor):
        """Quantize ``(..., page_size, D)`` blocks -> (q, scales)."""
        return blockwise.quantize_absmax(x, dtype=self.storage,
                                         axis=(-2, -1))


_SPECS = {
    "bf16": KVQuantSpec("bf16", torch.bfloat16, None),
    "int8": KVQuantSpec("int8", torch.int8, blockwise.QMAX_INT8),
}
if hasattr(torch, "float8_e4m3fn"):
    _SPECS["fp8_e4m3"] = KVQuantSpec("fp8_e4m3", torch.float8_e4m3fn,
                                     blockwise.FP8_E4M3_MAX)


def spec_for_storage(dtype: torch.dtype) -> KVQuantSpec:
    """The spec whose storage dtype is ``dtype`` (the write path
    recovers qmax from the pool itself)."""
    for spec in _SPECS.values():
        if spec.storage == dtype:
            return spec
    raise ValueError(f"no KV quant spec stores dtype {dtype}")


def resolve_kv_spec(requested: Optional[str], device=None, *,
                    strict: bool = False) -> Optional[KVQuantSpec]:
    """Map a requested KV dtype onto what ``device`` holds.

    ``None`` means model-dtype passthrough (no spec).  A named dtype
    that the device lacks degrades along :data:`FALLBACK` with a
    warning, or raises when ``strict``."""
    if requested is None:
        return None
    name = requested.replace("-", "_").lower()
    if name == "bfloat16":
        name = "bf16"
    if name == "fp8":
        name = "fp8_e4m3"
    if name not in KV_DTYPES:
        raise ValueError(f"unknown kv dtype {requested!r}; "
                         f"known: {KV_DTYPES}")
    supported = kv_cache_dtypes(device)
    asked = name
    while name not in supported or name not in _SPECS:
        if strict:
            raise ValueError(
                f"kv dtype {asked!r} is not supported on this device "
                f"(supported: {supported})")
        nxt = FALLBACK.get(name)
        if nxt is None:
            raise ValueError(
                f"kv dtype {asked!r} has no supported fallback on this "
                f"device (supported: {supported})")
        name = nxt
    if name != asked:
        warnings.warn(f"kv dtype {asked!r} unsupported on this device; "
                      f"falling back to {name!r}", stacklevel=2)
    return _SPECS[name]
