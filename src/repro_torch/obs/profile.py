"""Opt-in dispatch timers (``REPRO_PROFILE=1``), ``repro.obs.profile``
ported.

When enabled, every public op of ``kernels/*/ops.py`` (label
``device_op.<name>``, through :func:`device_op`) and every
``CudaKernel.launch`` (label ``kernel_call.<name>``) is timed on the
host clock into a module-level
:class:`~repro_torch.obs.metrics.MetricsRegistry`: a ``.calls`` counter
and a ``.s`` histogram per label.

Off by default: a dispatch then pays one module-global bool check.

What the times are: host wall clock around the call.  On the CPU the
ops run their plain versions synchronously, so a ``device_op`` time is
the op's cost.  On the card a kernel launch is asynchronous, so both
labels time the host's dispatch (argument checks, ctypes, the enqueue),
not the kernel: read them as where the host's time goes, and take
kernel times from CUDA events or the profiler.
"""
from __future__ import annotations

import functools
import os
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict

from repro_torch.obs.metrics import MetricsRegistry

__all__ = ["enabled", "enable", "registry", "reset", "record", "timed",
           "wrap", "device_op", "summary"]

_ENABLED = os.environ.get("REPRO_PROFILE", "") == "1"
_REGISTRY = MetricsRegistry()

# duration histograms: 100 ns .. 100 s at ~25% relative resolution
_LO, _HI = 1e-7, 1e2


def enabled() -> bool:
    return _ENABLED


def enable(on: bool = True) -> None:
    """Turn profiling on or off at run time."""
    global _ENABLED
    _ENABLED = bool(on)


def registry() -> MetricsRegistry:
    return _REGISTRY


def reset() -> None:
    """Drop every aggregated timing (a fresh registry)."""
    global _REGISTRY
    _REGISTRY = MetricsRegistry()


def record(label: str, seconds: float) -> None:
    _REGISTRY.counter(f"{label}.calls").inc()
    _REGISTRY.histogram(f"{label}.s", lo=_LO, hi=_HI).observe(seconds)


@contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(label, time.perf_counter() - t0)


def wrap(label: str, fn: Callable[..., Any]) -> Callable[..., Any]:
    """``fn`` wrapped in a per-call timer under ``label``."""

    @functools.wraps(fn)
    def timed_fn(*args: Any, **kwargs: Any) -> Any:
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            record(label, time.perf_counter() - t0)

    return timed_fn


def device_op(fn: Callable[..., Any]) -> Callable[..., Any]:
    """Decorator of a public op: timed as ``device_op.<fn name>`` while
    profiling is on, a bool check and the call while it is off."""
    timed_fn = wrap(f"device_op.{fn.__name__}", fn)

    @functools.wraps(fn)
    def dispatch(*args: Any, **kwargs: Any) -> Any:
        if _ENABLED:
            return timed_fn(*args, **kwargs)
        return fn(*args, **kwargs)

    return dispatch


def summary() -> Dict[str, Any]:
    """Snapshot of everything profiled so far (JSON-serializable)."""
    return _REGISTRY.snapshot()
