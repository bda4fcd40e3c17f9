"""Launcher of the CUDA selective-scan kernel (``csrc/mamba_scan.cu``).

The kernel takes x, dt, Bm and Cm in one activation type (f32 or bf16)
and A and D in f32, exactly as the mamba layer hands them over; its
time chunk and channel block are compiled in (the chunk is the tuning
table's, and the kernel refuses any other), and it builds for 8 and 16
states.  Every other mix, shape or device is refused here, by name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

_i, _p = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("mamba_scan", "mamba_scan.cu", "mamba_scan_fwd",
                    [_p] * 8 + [_i] * 6 + [_p])

#: State sizes the kernel is built for (jamba's 16, the smoke rule's 8).
D_STATES = (8, 16)
_ACTIVATIONS = (torch.float32, torch.bfloat16)


def check_scan_operands(x, dt, A, Bm, Cm, D) -> None:
    """Raise unless the operands are x/dt (B, S, d) and Bm/Cm (B, S, n)
    in one activation type, with A (d, n) and D (d,) in f32."""
    if x.dim() != 3:
        raise ValueError(f"mamba_scan: x must be (B, S, d_inner), got "
                         f"{tuple(x.shape)}")
    b, s, d = x.shape
    n = A.shape[-1] if A.dim() == 2 else -1
    want = {"dt": (dt, (b, s, d)), "A": (A, (d, n)), "Bm": (Bm, (b, s, n)),
            "Cm": (Cm, (b, s, n)), "D": (D, (d,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_scan: {name} must be {shape} for x "
                             f"{tuple(x.shape)} and A (d_inner, d_state), "
                             f"got {tuple(t.shape)}")
    if x.dtype not in _ACTIVATIONS or any(
            t.dtype != x.dtype for t in (dt, Bm, Cm)):
        raise TypeError(f"mamba_scan: x, dt, Bm and Cm must share float32 "
                        f"or bfloat16, got {x.dtype}, {dt.dtype}, "
                        f"{Bm.dtype}, {Cm.dtype}")
    if A.dtype != torch.float32 or D.dtype != torch.float32:
        raise TypeError(f"mamba_scan: A and D must be float32, got "
                        f"{A.dtype}, {D.dtype}")
    if n not in D_STATES:
        raise NotImplementedError(f"mamba_scan: d_state {n} is not built "
                                  f"(d_state in {D_STATES})")
    vec = 16 // x.element_size()
    if d % vec:
        raise ValueError(f"mamba_scan: d_inner {d} must be a multiple of "
                         f"{vec} (16-byte loads of {x.dtype})")


def mamba_scan_fwd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor):
    """-> (y (B, S, d_inner) in x's dtype, h_T (B, d_inner, d_state)
    f32), after exactly S steps from a zero state."""
    check_scan_operands(x, dt, A, Bm, Cm, D)
    check_cuda("mamba_scan", x, dt, A, Bm, Cm, D)
    b, s, d = x.shape
    n = A.shape[1]
    y = torch.empty_like(x)
    h_t = torch.empty((b, d, n), dtype=torch.float32, device=x.device)
    KERNEL.launch(ptr(x), ptr(dt), ptr(A), ptr(Bm), ptr(Cm), ptr(D), ptr(y),
                  ptr(h_t), b, s, d, n,
                  tuning.block_size("mamba_scan", "chunk"), dtype_code(x),
                  stream_of(x))
    return y, h_t
