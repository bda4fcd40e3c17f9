"""Blockwise absmax quantize/dequantize (``repro.quant.blockwise``, the
parts the KV pools use).

One law: ``q = round_or_cast(x / scale)`` with ``scale = absmax(block)
/ qmax`` over any set of block axes, stored as ``int8`` (round half to
even, clip to +-127) or ``float8_e4m3fn`` (a plain cast; the scale maps
the block's absmax onto the e4m3 ceiling of 448).  The arithmetic is
the reference's step for step (f32 absmax, a division by the scale, not
a multiply by its reciprocal), so both packages store the same bytes.

All-zero blocks quantize to zeros with scale 1, never 0, so dequantize
is total and a zero pool round-trips to zeros.  The optimizer's flat
``QBLOCK`` helpers arrive with the training slice.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

__all__ = ["QMAX_INT8", "FP8_E4M3_MAX", "absmax_scale", "quantize_absmax",
           "dequantize_absmax"]

QMAX_INT8 = 127.0
#: torch.finfo(torch.float8_e4m3fn).max: the scale maps absmax onto this.
FP8_E4M3_MAX = 448.0

_Axes = Union[int, Sequence[int]]


def _norm_axes(axis: _Axes, ndim: int) -> Tuple[int, ...]:
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    return tuple(sorted(a % ndim for a in axes))


def _qmax_for(dtype: torch.dtype) -> float:
    if dtype == torch.int8:
        return QMAX_INT8
    if dtype == torch.float8_e4m3fn:
        return FP8_E4M3_MAX
    raise ValueError(f"unsupported quantization storage dtype {dtype}")


def absmax_scale(x: torch.Tensor, axis: _Axes, qmax: float) -> torch.Tensor:
    """Per-block scale ``absmax / qmax`` (keepdims; 1.0 for all-zero)."""
    amax = x.float().abs().amax(dim=_norm_axes(axis, x.dim()), keepdim=True)
    return torch.where(amax == 0, torch.ones_like(amax), amax / qmax)


def quantize_absmax(x: torch.Tensor, *, dtype: torch.dtype,
                    axis: _Axes = -1, keepdims: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ``x`` blockwise over ``axis`` into storage ``dtype``.

    Returns ``(q, scales)``, the scales squeezed over the reduced axes
    (a ``(H, P, ps, D)`` pool over ``(-2, -1)`` gets ``(H, P)`` scales)
    unless ``keepdims``."""
    axes = _norm_axes(axis, x.dim())
    xf = x.float()
    scale = absmax_scale(xf, axes, _qmax_for(dtype))
    u = xf / scale
    if dtype == torch.int8:
        q = torch.clamp(torch.round(u), -QMAX_INT8, QMAX_INT8).to(torch.int8)
    else:
        q = u.to(dtype)
    if keepdims:
        return q, scale
    return q, scale.squeeze(axes)


def dequantize_absmax(q: torch.Tensor, scales: torch.Tensor,
                      axis: _Axes = -1) -> torch.Tensor:
    """Inverse of :func:`quantize_absmax` up to its rounding: ``f32(q) *
    scale``, the arithmetic the kernels use."""
    s = scales
    for a in _norm_axes(axis, q.dim()):
        s = s.unsqueeze(a)
    return q.float() * s
