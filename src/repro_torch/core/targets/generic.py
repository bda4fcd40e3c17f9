"""The generic target: the card with the runtime's portable part only,
"a new GPU target for a few intrinsics" (paper §1).

It registers one variant, the define that makes ``csrc/rt/runtime.cuh``
take ``csrc/rt/targets/generic.cuh``, which provides no intrinsic:
reductions go through shared memory, the reciprocal divides, and a
kernel that calls ``atomic_inc`` or ``make_async_copy`` fails to
compile with "target dependent implementation missing".  Every other
host intrinsic keeps its portable base, and ``make_async_copy`` raises.
"""
from __future__ import annotations

from repro_torch.core import intrinsics as I
from repro_torch.core.targets.cuda import SM90A_FLAGS
from repro_torch.core.variant import arch, declare_variant, match

GENERIC_DEFINE = "-DREPRO_RT_TARGET_GENERIC"


@declare_variant(I.compiler_params, match=match(device=arch("generic")))
def _compiler_params_generic():
    return SM90A_FLAGS + (GENERIC_DEFINE,)
