"""Target context: the OpenMP 5.1 "OpenMP context" of the port
(counterpart of ``repro.core.context``).

A context is the set of traits active at a point of the program,
``device={kind, arch, isa}`` and ``implementation={vendor}``, against
which ``declare_variant`` selectors are matched
(``repro_torch.core.variant``).  Here it names what a CUDA source is
compiled for, and so which target part of the device runtime
(``csrc/rt/``) a kernel is built with:

* ``cuda``: the card, with the runtime's target part for its isa
  (``sm_90a`` on an H100): warp shuffles, ``rcp.approx``, native
  ``atomicInc``, ``cp.async``.  The nvptx64 of this port.
* ``generic``: the same card with only the runtime's portable part,
  the paper's new target that costs a few intrinsics; the kernels
  build unchanged and an intrinsic with no portable form fails to
  compile.
* ``cpu``: the plain PyTorch path, nothing is compiled (the
  counterpart of ``generic``/``interpret`` in ``repro``).

The default context is the card's, detected the way
``core/device.py`` picks the device: a missing card is an error, never
a silent fall back to ``cpu``.  ``with target(...)`` overrides it for
the current thread.
"""
from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional, Tuple

import torch

from repro_torch.core.device import resolve_device

ARCH_CUDA = "cuda"        # the card with its target part (the "nvptx64")
ARCH_GENERIC = "generic"  # the card with the portable part only
ARCH_CPU = "cpu"          # plain PyTorch on the host

KNOWN_ARCHS = (ARCH_CUDA, ARCH_GENERIC, ARCH_CPU)


@dataclasses.dataclass(frozen=True)
class DeviceTraits:
    kind: str = "gpu"
    arch: str = ARCH_CUDA
    isa: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class ImplementationTraits:
    vendor: str = "nvidia"


@dataclasses.dataclass(frozen=True)
class TargetContext:
    device: DeviceTraits = dataclasses.field(default_factory=DeviceTraits)
    implementation: ImplementationTraits = dataclasses.field(
        default_factory=ImplementationTraits)

    @property
    def arch(self) -> str:
        return self.device.arch


def context_for(arch: str, isa: Optional[str] = None) -> TargetContext:
    """The context of ``arch`` (kind and vendor follow from it)."""
    if arch not in KNOWN_ARCHS:
        raise ValueError(f"unknown target arch {arch!r}; known: "
                         f"{KNOWN_ARCHS}")
    host = arch == ARCH_CPU
    return TargetContext(
        DeviceTraits(kind="cpu" if host else "gpu", arch=arch, isa=isa),
        ImplementationTraits(vendor="pytorch" if host else "nvidia"))


def isa_of(capability: Tuple[int, int]) -> str:
    """``torch.cuda.get_device_capability`` -> the isa the kernels are
    compiled for: Hopper's arch-specific ``sm_90a`` (wgmma, setmaxnreg),
    otherwise the plain ``sm_XY``."""
    major, minor = capability
    return f"sm_{major}{minor}" + ("a" if major == 9 else "")


def detect_default_context() -> TargetContext:
    """The card's context; raises when there is no card."""
    dev = resolve_device(None)
    return context_for(ARCH_CUDA,
                       isa_of(torch.cuda.get_device_capability(dev)))


@functools.lru_cache(maxsize=None)
def _default_context() -> TargetContext:
    # a process keeps its card: detect once (a raise is not cached)
    return detect_default_context()


class _ContextStack(threading.local):
    def __init__(self):
        self.stack = []


_STACK = _ContextStack()


def current_context() -> TargetContext:
    if _STACK.stack:
        return _STACK.stack[-1]
    return _default_context()


class target:
    """``with target("generic"):`` overrides the active target context
    (the analogue of choosing the device pass for a region of code)."""

    def __init__(self, arch: str, *, isa: Optional[str] = None):
        self._ctx = context_for(arch, isa)

    def __enter__(self) -> TargetContext:
        _STACK.stack.append(self._ctx)
        return self._ctx

    def __exit__(self, *exc) -> None:
        _STACK.stack.pop()
