"""The plain, sequential semantics of the device runtime's atomics
(counterpart of ``repro.core.atomics``; paper §3.1, Listing 3).

On the card these are ``csrc/rt/atomics.cuh`` (add, max, min, exchange
and cas, portable through ``cuda::atomic_ref`` at ``seq_cst``) and the
sm_90 target part's ``atomic_inc`` (CUDA's native ``atomicInc``, the
one atomic OpenMP 5.1 cannot express).  Here each acts on ``t[idx]``
(all of ``t`` when ``idx`` is None) one call at a time and returns the
captured old value, as the ``capture`` clause does.  The CPU tests and
the card's runtime test kernel (``core/selftest.py``) are held to them.
"""
from __future__ import annotations

import torch

__all__ = [
    "atomic_add", "atomic_max", "atomic_min", "atomic_exchange",
    "atomic_cas", "atomic_inc",
]


def _read(t, idx):
    return (t if idx is None else t[idx]).clone()


def _write(t, idx, v):
    if idx is None:
        t.copy_(torch.as_tensor(v, dtype=t.dtype).expand(t.shape))
    else:
        t[idx] = v


def atomic_add(t, value, idx=None):
    """{ v = x; x += e; } return v;   (atomic capture seq_cst)"""
    v = _read(t, idx)
    _write(t, idx, v + value)
    return v


def atomic_max(t, value, idx=None):
    """{ v = x; if (x < e) x = e; } return v;   (atomic compare capture)"""
    v = _read(t, idx)
    _write(t, idx, torch.maximum(v, torch.as_tensor(value, dtype=v.dtype)))
    return v


def atomic_min(t, value, idx=None):
    """{ v = x; if (x > e) x = e; } return v;"""
    v = _read(t, idx)
    _write(t, idx, torch.minimum(v, torch.as_tensor(value, dtype=v.dtype)))
    return v


def atomic_exchange(t, value, idx=None):
    """{ v = x; x = e; } return v;"""
    v = _read(t, idx)
    _write(t, idx, value)
    return v


def atomic_cas(t, expected, desired, idx=None):
    """{ v = x; if (x == e) x = d; } return v;"""
    v = _read(t, idx)
    _write(t, idx, torch.where(v == expected,
                               torch.as_tensor(desired, dtype=v.dtype), v))
    return v


def atomic_inc(t, bound, idx=None):
    """CUDA's wraparound increment: { v = x; x = x >= e ? 0 : x + 1; }"""
    v = _read(t, idx)
    _write(t, idx, torch.where(v >= bound, torch.zeros_like(v), v + 1))
    return v
