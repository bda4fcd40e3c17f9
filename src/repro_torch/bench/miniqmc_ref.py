"""Plain PyTorch versions of miniQMC's two hot regions B18-B19 (paper
Table 1), their inputs and their shapes (the counterpart of the kernel
bodies and ``run`` of ``benchmarks/miniqmc.py``).

Each function is transcribed from the reference's Pallas body, runs
eagerly on any device, and is what the kernels of ``csrc/miniqmc/`` are
held to (``bench/miniqmc.py``).  Inputs are drawn with numpy from a
seed, in the distributions of the reference's ``run`` (``jax.random``'s
numbers cannot be reproduced, and need not be).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch

#: the regions, in the reference's order and under its names
NAMES = ("evaluate_vgh", "evaluateDetRatios")
N_CALLS = 40                    # calls per region and build, the reference's
WALKER_BLOCK = 8                # evaluate_vgh's walkers a block, the reference's
#: (label, name) -> shape: the reference's ``run``; a card shape, large
#: enough that a launch is not launch-bound (chosen to time the runtime,
#: not taken from miniQMC); and a small legal shape off the reference's
#: for the CPU tests.  evaluate_vgh coefs4 (NW, 4, NS); evaluateDetRatios
#: a_inv (NW, N, N).
SHAPES: Dict[str, Dict[str, tuple]] = {
    "reference": {"evaluate_vgh": (32, 4, 256),
                  "evaluateDetRatios": (32, 128, 128)},
    "card": {"evaluate_vgh": (512, 4, 16384),
             "evaluateDetRatios": (256, 1024, 1024)},
    "small": {"evaluate_vgh": (24, 4, 200),
              "evaluateDetRatios": (12, 80, 80)},
}


def inputs(name: str, label: str, seed: int = 0) -> Tuple[np.ndarray, ...]:
    """The region's operands at ``SHAPES[label][name]`` as numpy arrays,
    from ``seed``, in the reference's distributions: evaluate_vgh coefs4
    ~ N(0, 1) (NW, 4, NS) and t ~ U(0, 1) (NW, 1); evaluateDetRatios
    a_inv ~ N(0, 1) (NW, N, N) and phi ~ N(0, 1) (NW, N)."""
    shape = SHAPES[label][name]
    rng = np.random.default_rng(seed)
    if name == "evaluate_vgh":
        return (rng.standard_normal(shape, dtype=np.float32),
                rng.random((shape[0], 1), dtype=np.float32))
    if name == "evaluateDetRatios":
        return (rng.standard_normal(shape, dtype=np.float32),
                rng.standard_normal(shape[:2], dtype=np.float32))
    raise KeyError(name)


def basis(t: torch.Tensor) -> torch.Tensor:
    """(NW, 3, 4): for each walker's t (NW, 1) the cubic B-spline's
    value, gradient and hessian weights, in the reference's expressions
    (the divisions by 6 and 2 as written)."""
    t2 = t * t
    t3 = t2 * t
    return torch.stack([
        torch.cat([(1 - 3 * t + 3 * t2 - t3) / 6, (4 - 6 * t2 + 3 * t3) / 6,
                   (1 + 3 * t + 3 * t2 - 3 * t3) / 6, t3 / 6], dim=1),
        torch.cat([(-1 + 2 * t - t2) / 2, (-4 * t + 3 * t2) / 2,
                   (1 + 2 * t - 3 * t2) / 2, t2 / 2], dim=1),
        torch.cat([1 - t, 3 * t - 2, 1 - 3 * t, t], dim=1)], dim=1)


def evaluate_vgh_ref(coefs4: torch.Tensor, t: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, grad, hess), each (NW, NS): the four taps of coefs4
    (NW, 4, NS) weighted by :func:`basis` of t (NW, 1), summed left to
    right."""
    w = basis(t)
    return tuple(w[:, k, 0:1] * coefs4[:, 0] + w[:, k, 1:2] * coefs4[:, 1]
                 + w[:, k, 2:3] * coefs4[:, 2] + w[:, k, 3:4] * coefs4[:, 3]
                 for k in range(3))


@contextlib.contextmanager
def no_tf32():
    """f32 products in f32 on the card: ``torch.matmul`` there may take
    TF32 (about three decimal digits) unless told not to."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def evaluate_det_ratios_ref(a_inv: torch.Tensor,
                            phi: torch.Tensor) -> torch.Tensor:
    """(NW, N): each walker's phi (1, N) times its A_inv (N, N), summed
    in f32 (TF32 off)."""
    with no_tf32():
        return torch.matmul(phi[:, None, :], a_inv)[:, 0]
