"""Plain PyTorch grouped matmul (transcribed from
``repro.kernels.gmm.ref``): the capacity-layout expert product of MoE
layers."""
from __future__ import annotations

import torch


def gmm_ref(lhs: torch.Tensor, rhs: torch.Tensor,
            group_sizes: torch.Tensor) -> torch.Tensor:
    """lhs: (E, C, K) capacity-layout tokens; rhs: (E, K, N);
    group_sizes: (E,) valid rows per expert.  The product is summed in
    f32, rows >= size are zeroed, and the result is cast to lhs's
    dtype."""
    out = torch.einsum("eck,ekn->ecn", lhs.float(), rhs.float())
    row = torch.arange(lhs.shape[1], device=lhs.device)[None, :, None]
    out = torch.where(row < group_sizes[:, None, None], out,
                      torch.zeros_like(out))
    return out.to(lhs.dtype)
