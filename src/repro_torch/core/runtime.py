"""DeviceRuntime: the facade of the device runtime on the host
(counterpart of ``repro.core.runtime``).

The kernels themselves are written against the CUDA C++ facade
``csrc/rt/runtime.cuh``.  On the host, a :class:`DeviceRuntime` binds a
target context: ``compiler_params()`` resolves, through the
``declare_variant`` registry, the nvcc flags that select the target
part of ``csrc/rt/`` (``core/build.py`` builds every kernel with them),
which is the variant dispatch of ``repro``'s ``kernel_call``, decided at
build time as the reference decides it at trace time.
``static_partition`` is the same ``[lo, hi)`` as ``rt::static_partition``
on the card, so the launchers and the tests share the index math.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import context as _context
from repro_torch.core import intrinsics as _intrinsics
import repro_torch.core.targets  # noqa: F401  (register all variants)

__all__ = ["DeviceRuntime", "runtime"]


@dataclasses.dataclass(frozen=True)
class DeviceRuntime:
    """Runtime bound to the target context active at construction."""

    ctx: _context.TargetContext

    @property
    def arch(self) -> str:
        return self.ctx.arch

    def compiler_params(self) -> Tuple[str, ...]:
        """The nvcc flags of the bound target (raises
        ``VariantError`` for a target no kernel is compiled for)."""
        return _intrinsics.compiler_params.resolve(self.ctx)()

    @staticmethod
    def static_partition(total: int, num_teams: int,
                         team: int) -> Tuple[int, int]:
        """Contiguous static schedule (``#pragma omp for
        schedule(static)``): ``[lo, hi)`` owned by ``team``."""
        chunk = -(-total // num_teams)
        lo = team * chunk
        return lo, min(lo + chunk, total)


def runtime() -> DeviceRuntime:
    """Bind a DeviceRuntime to the current target context."""
    return DeviceRuntime(_context.current_context())
