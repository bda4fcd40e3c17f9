"""The host target: plain PyTorch, nothing compiled (the counterpart of
``repro``'s interpret/generic targets).  It provides the one intrinsic
that has no portable base, as a synchronous copy; ``compiler_params``
keeps its raising base, since no kernel is built for the host."""
from __future__ import annotations

from repro_torch.core import intrinsics as I
from repro_torch.core.variant import arch, declare_variant, match


@declare_variant(I.make_async_copy, match=match(device=arch("cpu")))
def _make_async_copy_cpu(src, dst):
    return dst.copy_(src)
