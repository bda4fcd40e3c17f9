"""Base declarations of the device runtime's target-dependent
intrinsics, on the host (counterpart of ``repro.core.intrinsics``).

Every function here is a ``declare_target`` base whose body is either
a portable implementation over torch tensors (the common part, §3.1 of
the paper) or the paper's stub that raises (§3.2, Listing 4) where no
portable form exists.  ``repro_torch.core.targets.{cuda,generic,cpu}``
register the variants.

The kernels' own intrinsics are CUDA C++ (``csrc/rt/``); the one host
intrinsic they depend on is :func:`compiler_params`, whose variant for
the active context gives the nvcc flags a kernel is built with, and so
selects the target part of ``csrc/rt/`` at compile time.
"""
from __future__ import annotations

import torch

from repro_torch.core.variant import VariantError, declare_target

# ---------------------------------------------------------------------------
# Portable common part.
# ---------------------------------------------------------------------------


@declare_target
def iota(shape, dim, dtype=torch.int32, device=None):
    """Index along ``dim``, broadcast to ``shape``."""
    idx = torch.arange(shape[dim], dtype=dtype, device=device)
    view = [1] * len(shape)
    view[dim] = shape[dim]
    return idx.view(view).expand(tuple(shape))


@declare_target
def reduce_sum(x, axis=None, keepdims=False):
    if axis is None:
        return x.sum()
    return x.sum(dim=axis, keepdim=keepdims)


@declare_target
def reduce_max(x, axis=None, keepdims=False):
    if axis is None:
        return x.max()
    return x.amax(dim=axis, keepdim=keepdims)


@declare_target
def exp(x):
    return torch.exp(x)


@declare_target
def approx_reciprocal(x):
    """1/x.  The card has an approximate reciprocal (``rcp.approx``,
    ``csrc/rt/targets/sm90.cuh``); the portable fallback divides."""
    return 1.0 / x


@declare_target
def repeat(x, repeats, axis):
    """Tile ``x`` ``repeats`` times along ``axis``."""
    return torch.cat([x] * repeats, dim=axis)


@declare_target
def roll(x, shift, axis):
    """Cyclic shift along ``axis``."""
    return torch.roll(x, shift, dims=axis)


# ---------------------------------------------------------------------------
# Target-dependent intrinsics (the paper's Listing-4 pattern).
# ---------------------------------------------------------------------------


@declare_target
def make_async_copy(src, dst):
    """Copy ``src`` into ``dst`` without waiting for it.  No portable
    form: the base raises, targets must provide it."""
    raise VariantError("make_async_copy: target dependent implementation "
                       "missing")


@declare_target
def compiler_params():
    """The nvcc flags that select the active target (a tuple of
    strings).  A target nothing is compiled for has none: the base
    raises."""
    raise VariantError("compiler_params: target dependent implementation "
                       "missing")
