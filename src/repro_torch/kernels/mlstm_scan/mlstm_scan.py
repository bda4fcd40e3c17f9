"""Launcher of the CUDA mLSTM scan kernel (``csrc/mlstm_scan.cu``).

The kernel takes q, k and v in one activation type (f32 or bf16) and
the two gates in f32, exactly as the mLSTM layer hands them over; it is
built for head dims Dk of 32 (the reference's registry example) and
1024 (xlstm-1.3b), with Dv a multiple of 32.  bf16 runs the chunkwise
body on the tensor cores, f32 the recurrent one; the chunkwise body's
chunk is compiled in (the tuning table's "chunk"; the kernel refuses any
other).  Every other mix, shape or device is refused here, by name.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import tuning
from repro_torch.core.build import (CudaKernel, check_cuda, dtype_code, ptr,
                                    stream_of)

_i, _p = ctypes.c_int, ctypes.c_void_p
KERNEL = CudaKernel("mlstm_scan", "mlstm_scan.cu", "mlstm_scan_fwd",
                    [_p] * 9 + [_i] * 6 + [ctypes.c_float, _i, _p])

#: Key head dims the kernel is built for (the registry example's 32,
#: xlstm-1.3b's 1024); value head dims must be whole CTA tiles of 32.
HEAD_DIMS = (32, 1024)
V_TILE = 32
_ACTIVATIONS = (torch.float32, torch.bfloat16)


def check_scan_operands(q, k, v, i_gate, f_gate) -> None:
    """Raise unless q/k are (B, H, S, Dk) and v (B, H, S, Dv) in one
    activation type, with the gates (B, H, S) in f32."""
    if q.dim() != 4:
        raise ValueError(f"mlstm_scan: q must be (B, H, S, Dk), got "
                         f"{tuple(q.shape)}")
    b, h, s, dk = q.shape
    dv = v.shape[-1] if v.dim() == 4 else -1
    want = {"k": (k, (b, h, s, dk)), "v": (v, (b, h, s, dv)),
            "i_gate": (i_gate, (b, h, s)), "f_gate": (f_gate, (b, h, s))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mlstm_scan: {name} must be {shape} for q "
                             f"{tuple(q.shape)}, got {tuple(t.shape)}")
    if q.dtype not in _ACTIVATIONS or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"mlstm_scan: q, k and v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if i_gate.dtype != torch.float32 or f_gate.dtype != torch.float32:
        raise TypeError(f"mlstm_scan: the gates must be float32, got "
                        f"{i_gate.dtype}, {f_gate.dtype}")
    if dk not in HEAD_DIMS:
        raise NotImplementedError(f"mlstm_scan: key head dim {dk} is not "
                                  f"built (Dk in {HEAD_DIMS})")
    if dv <= 0 or dv % V_TILE:
        raise NotImplementedError(f"mlstm_scan: value head dim {dv} must be "
                                  f"a multiple of {V_TILE} (one CTA's "
                                  f"columns)")


def plain_chunk(dtype: torch.dtype) -> int | None:
    """``chunk=`` of the plain version that the kernel's body for
    ``dtype`` computes: the chunkwise form at the bf16 body's L, the
    recurrence (None) for the f32 body."""
    return (tuning.block_size("mlstm_scan", "chunk")
            if dtype == torch.bfloat16 else None)


def mlstm_scan_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                   return_state: bool = False):
    """-> h (B, H, S, Dv) in q's dtype after exactly S steps from the
    zero state (m at -inf), and with ``return_state`` the final (C (B,
    H, Dk, Dv), n (B, H, Dk), m (B, H)) in f32."""
    check_scan_operands(q, k, v, i_gate, f_gate)
    check_cuda("mlstm_scan", q, k, v, i_gate, f_gate)
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    out = torch.empty((b, h, s, dv), dtype=q.dtype, device=q.device)
    state = None
    if return_state:
        f32 = dict(dtype=torch.float32, device=q.device)
        state = (torch.empty((b, h, dk, dv), **f32),
                 torch.empty((b, h, dk), **f32), torch.empty((b, h), **f32))
    c_t, n_t, m_t = (ptr(t) for t in state) if state else (None,) * 3
    KERNEL.launch(ptr(q), ptr(k), ptr(v), ptr(i_gate), ptr(f_gate), ptr(out),
                  c_t, n_t, m_t, b, h, s, dk, dv,
                  tuning.block_size("mlstm_scan", "chunk"), dk ** -0.5,
                  dtype_code(q), stream_of(q))
    return (out, state) if return_state else out
