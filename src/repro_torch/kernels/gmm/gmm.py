"""Launcher of the CUDA grouped-matmul kernel (``csrc/gmm.cu``).

The kernel has two builds of the capacity tile: ``block_c`` 8, which
covers all of an expert's rows at decode (C <= 8) so each weight tile
is read once, and the tuning table's 64 for larger C; ``block_n`` and
``block_k`` are compiled in.  ``group_sizes`` stays on the device: the
kernel reads it there, so a call never waits for the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

_i, _p = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("gmm", "gmm.cu", "gmm_fwd", [_p] * 4 + [_i] * 8 + [_p])

#: The capacity tile of the decode build (csrc/gmm.cu).
DECODE_BLOCK_C = 8


def block_c_for(c: int) -> int:
    """The capacity tile the launch takes for C rows per expert."""
    return (DECODE_BLOCK_C if c <= DECODE_BLOCK_C
            else tuning.block_size("gmm", "block_c"))


def gmm_fwd(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs (E, C, K), rhs (E, K, N), group_sizes (E,) int32 on the card
    -> (E, C, N) in lhs's dtype."""
    if lhs.dim() != 3 or rhs.dim() != 3 or rhs.shape[0] != lhs.shape[0] \
            or rhs.shape[1] != lhs.shape[2]:
        raise ValueError(f"gmm: want lhs (E, C, K) and rhs (E, K, N), got "
                         f"{tuple(lhs.shape)}, {tuple(rhs.shape)}")
    e, c, k = lhs.shape
    n = rhs.shape[2]
    if group_sizes.shape != (e,) or group_sizes.dtype != torch.int32:
        raise ValueError(f"gmm: group_sizes must be ({e},) int32, got "
                         f"{tuple(group_sizes.shape)} {group_sizes.dtype}")
    if lhs.dtype != rhs.dtype:
        raise TypeError(f"gmm: mixed dtypes {lhs.dtype}, {rhs.dtype}")
    vec = 16 // lhs.element_size()
    if k % vec or n % vec:
        raise ValueError(f"gmm: K {k} and N {n} must be multiples of {vec} "
                         f"(16-byte loads of {lhs.dtype})")
    check_cuda("gmm", lhs, rhs, group_sizes)
    out = torch.empty((e, c, n), dtype=lhs.dtype, device=lhs.device)
    KERNEL.launch(ptr(lhs), ptr(rhs), ptr(group_sizes), ptr(out), e, c, k, n,
                  block_c_for(c), tuning.block_size("gmm", "block_n"),
                  tuning.block_size("gmm", "block_k"), dtype_code(lhs),
                  stream_of(lhs))
    return out
