"""Plain PyTorch versions of the SPEC ACCEL stand-ins B12-B17, their
inputs and their shapes (the counterpart of the bodies and ``_inputs``
of ``benchmarks/spec_accel.py``).

Each function is transcribed from the reference's Pallas body and the
code around it, runs eagerly on any device, and is what the kernels of
``csrc/spec_accel/`` are held to (``bench/spec_accel.py``).  Inputs are
drawn with numpy from a seed, in the distributions of the reference's
``_inputs`` (``jax.random``'s numbers cannot be reproduced, and need not
be).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch

#: the stand-ins of this slice, in the reference's order
NAMES = ("503.postencil", "504.polbm", "514.pomriq", "552.pep", "554.pcg",
         "570.pbt")
#: (name, label) -> shape: the reference's ``_inputs``; a card shape
#: with the same block laws, large enough that one launch is not
#: launch-bound (chosen to time the runtime, not taken from SPEC ACCEL);
#: and a small legal shape off the reference's for the CPU tests.
#: postencil (h, w); polbm (h, w, 9); pomriq (nx, nk); pep n seeds;
#: pcg n unknowns; pbt (nb systems, n unknowns).
SHAPES: Dict[str, Dict[str, tuple]] = {
    "reference": {"503.postencil": (256, 256), "504.polbm": (128, 128, 9),
                  "514.pomriq": (512, 512), "552.pep": (1 << 14,),
                  "554.pcg": (1024,), "570.pbt": (8, 512)},
    "card": {"503.postencil": (8192, 8192), "504.polbm": (2048, 2048, 9),
             "514.pomriq": (262144, 2048), "552.pep": (1 << 26,),
             "554.pcg": (1 << 24,), "570.pbt": (65536, 512)},
    "small": {"503.postencil": (128, 192), "504.polbm": (64, 96, 9),
              "514.pomriq": (256, 384), "552.pep": (1 << 12,),
              "554.pcg": (1000,), "570.pbt": (5, 300)},
}
ITERS = 4                       # postencil's sweeps, the reference's
CG_ITERS = 8                    # pcg's iterations, the reference's
#: the D2Q9 velocities (column 0 moves axis 0) and weights, as the
#: reference's _D2Q9 and _W9
D2Q9 = np.array([(0, 0), (1, 0), (-1, 0), (0, 1), (0, -1),
                 (1, 1), (-1, -1), (1, -1), (-1, 1)], np.int32)
W9 = np.array([4 / 9] + [1 / 9] * 4 + [1 / 36] * 4, np.float32)
TAU = 0.6
BLOCK_K = 128                   # pomriq's k-block, the reference's
PEP_BLOCK = 256                 # pep's seeds a block, the reference's
_U32 = 0xFFFFFFFF


def inputs(name: str, label: str, seed: int = 0) -> Tuple[np.ndarray, ...]:
    """The stand-in's operands at ``SHAPES[label][name]`` as numpy
    arrays, from ``seed``: postencil x ~ N(0, 1); polbm f ~ U(0.5,
    1.5); pomriq x, k ~ N(0, 1) (n, 3) and phi ~ N(0, 1); pep the seeds
    0 .. n - 1 (int32); pcg diag 2 + U(0, 1), off ~ U(0, 0.4) and
    b ~ N(0, 1), each (n,); pbt lower and upper ~ U(0, 0.4), diag 2 +
    U(0, 1) and rhs ~ N(0, 1), each (nb, n)."""
    shape = SHAPES[label][name]
    rng = np.random.default_rng(seed)
    if name == "503.postencil":
        return (rng.standard_normal(shape, dtype=np.float32),)
    if name == "504.polbm":
        return (rng.random(shape, dtype=np.float32) + np.float32(0.5),)
    if name == "514.pomriq":
        nx, nk = shape
        return (rng.standard_normal((nx, 3), dtype=np.float32),
                rng.standard_normal((nk, 3), dtype=np.float32),
                rng.standard_normal(nk, dtype=np.float32))
    if name == "552.pep":
        return (np.arange(shape[0], dtype=np.int32),)
    if name == "554.pcg":
        off = (0.4 * rng.random(shape)).astype(np.float32)
        diag = (2.0 + rng.random(shape)).astype(np.float32)
        return (diag, off, rng.standard_normal(shape, dtype=np.float32))
    if name == "570.pbt":
        lo = (0.4 * rng.random(shape)).astype(np.float32)
        up = (0.4 * rng.random(shape)).astype(np.float32)
        diag = (2.0 + rng.random(shape)).astype(np.float32)
        return (lo, diag, up, rng.standard_normal(shape, dtype=np.float32))
    raise KeyError(name)


def postencil_ref(x: torch.Tensor, iters: int = ITERS) -> torch.Tensor:
    """``iters`` sweeps of 0.2 (c + n + s + e + w) over a zero border."""
    for _ in range(iters):
        xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
        c, n, s = xp[1:-1, 1:-1], xp[:-2, 1:-1], xp[2:, 1:-1]
        e, w = xp[1:-1, 2:], xp[1:-1, :-2]
        x = 0.2 * (c + n + s + e + w)
    return x


def polbm_ref(f: torch.Tensor) -> torch.Tensor:
    """One D2Q9 BGK collision (tau 0.6), then periodic streaming by
    ``torch.roll``, plane by plane, as the reference does."""
    cx = torch.from_numpy(D2Q9[:, 0].astype(np.float32)).to(f.device)
    cy = torch.from_numpy(D2Q9[:, 1].astype(np.float32)).to(f.device)
    wq = torch.from_numpy(W9).to(f.device)
    rho = f.sum(dim=2)
    ux = (f * cx).sum(dim=2) / rho
    uy = (f * cy).sum(dim=2) / rho
    cu = cx * ux[..., None] + cy * uy[..., None]
    usq = (ux * ux + uy * uy)[..., None]
    feq = rho[..., None] * wq * (1 + 3 * cu + 4.5 * cu * cu - 1.5 * usq)
    out = f - (f - feq) / TAU
    return torch.stack([torch.roll(out[..., k], shifts=(int(D2Q9[k, 0]),
                                                        int(D2Q9[k, 1])),
                                   dims=(0, 1)) for k in range(9)], dim=-1)


def pomriq_ref(x: torch.Tensor, kgrid: torch.Tensor,
               phi: torch.Tensor) -> torch.Tensor:
    """Q(x_i) = sum_k phi_k cos(2 pi k . x_i), (nx, 1): each k-block's
    sum added to the accumulator in turn, as the reference's grid does;
    the phase as f32(2 pi) (x0 k0 + x1 k1 + x2 k2)."""
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
    for k0 in range(0, kgrid.shape[0], BLOCK_K):
        kb, pb = kgrid[k0:k0 + BLOCK_K], phi[k0:k0 + BLOCK_K]
        d = (x[:, 0:1] * kb[:, 0] + x[:, 1:2] * kb[:, 1]
             + x[:, 2:3] * kb[:, 2])
        acc = acc + (torch.cos(2 * math.pi * d) * pb).sum(dim=1)
    return acc[:, None]


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for a in [0, 2^32) held in int64, without
    overflowing int64: c split into 16-bit halves."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def pep_hash(seeds: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's uint32 hash of int32 seeds, (a, b) in int64:
    a = s 1664525 + 1013904223, b = (a ^ (a >> 16)) 2246822519, mod 2^32
    (torch has no uint32 arithmetic)."""
    s = seeds.to(torch.int64) & _U32
    a = (_mul_u32(s, 1664525) + 1013904223) & _U32
    b = _mul_u32(a ^ (a >> 16), 2246822519)
    return a, b


def pep_ref(seeds: torch.Tensor) -> torch.Tensor:
    """Per block of 256 seeds: hash, uniforms (f32(a) + 1) / 2^32,
    Box-Muller, then [sum z, sum z^2, max z, sum |z|] -> (n / 256, 4)."""
    a, b = pep_hash(seeds)
    u1 = (a.to(torch.float32) + 1.0) / 4294967296.0
    u2 = (b.to(torch.float32) + 1.0) / 4294967296.0
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2 * math.pi * u2)
    z = z.view(-1, PEP_BLOCK)
    return torch.stack([z.sum(dim=1), (z * z).sum(dim=1),
                        z.max(dim=1).values, z.abs().sum(dim=1)], dim=1)


def pcg_spmv_ref(diag: torch.Tensor, off: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y = diag x + off (x_{i+1} + x_{i-1}), zero past both ends: the
    reference's operator, A[i, i+1] = off_i and A[i+1, i] = off_{i+1},
    which is not symmetric (and is not symmetrised here)."""
    zero = x.new_zeros(1)
    up = torch.cat([x[1:], zero])
    down = torch.cat([zero, x[:-1]])
    return diag * x + off * (up + down)


def cg(spmv: Callable[[torch.Tensor], torch.Tensor], b: torch.Tensor,
       iters: int = CG_ITERS) -> torch.Tensor:
    """``iters`` CG iterations from x = 0 on A x = b, A applied by
    ``spmv``, as the reference's loop: the scalars stay 0-d tensors on
    b's device, so nothing waits on the host."""
    x = torch.zeros_like(b)
    r = b - spmv(x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = spmv(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
    return x


def pcg_ref(diag: torch.Tensor, off: torch.Tensor, b: torch.Tensor,
            iters: int = CG_ITERS) -> torch.Tensor:
    """:func:`cg` with the operator of :func:`pcg_spmv_ref`."""
    return cg(lambda v: pcg_spmv_ref(diag, off, v), b, iters)


def pbt_sweeps(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
               rhs: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, cp, dp), each (nb, n): the Thomas forward sweep m = d_i -
    l_i cp_{i-1}, cp_i = u_i / m, dp_i = (r_i - l_i dp_{i-1}) / m, then
    x_{n-1} = dp_{n-1}, x_i = dp_i - cp_i x_{i+1}; column by column over
    all systems at once, as the reference's loops (on (n, nb) copies,
    so that each column is contiguous)."""
    lo, di, up, rh = (t.t().contiguous() for t in (lower, diag, upper, rhs))
    cp, dp = [up[0] / di[0]], [rh[0] / di[0]]
    for i in range(1, rh.shape[0]):
        m = di[i] - lo[i] * cp[-1]
        cp.append(up[i] / m)
        dp.append((rh[i] - lo[i] * dp[-1]) / m)
    x = [dp[-1]]
    for i in range(rh.shape[0] - 2, -1, -1):
        x.append(dp[i] - cp[i] * x[-1])
    return (torch.stack(x[::-1], dim=1), torch.stack(cp, dim=1),
            torch.stack(dp, dim=1))


def pbt_ref(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
            rhs: torch.Tensor) -> torch.Tensor:
    """The solutions x (nb, n) of the batched Thomas solves."""
    return pbt_sweeps(lower, diag, upper, rhs)[0]
