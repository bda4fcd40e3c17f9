"""The card's target part on the host (the nvptx implementation file
of the paper): selected by ``match(device={arch(cuda), isa(sm_90a)})``.
Its device side is ``csrc/rt/targets/sm90.cuh``."""
from __future__ import annotations

from repro_torch.core import intrinsics as I
from repro_torch.core.variant import arch, declare_variant, isa, match

#: nvcc's target flags for Hopper; the ``a`` keeps wgmma and setmaxnreg
SM90A_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_CUDA = match(device=arch("cuda"))
_SM90A = match(device=[arch("cuda"), isa("sm_90a")])


@declare_variant(I.compiler_params, match=_SM90A)
def _compiler_params_sm90a():
    return SM90A_FLAGS


@declare_variant(I.make_async_copy, match=_CUDA)
def _make_async_copy_cuda(src, dst):
    return dst.copy_(src, non_blocking=True)
