"""miniQMC's two hot regions B18-B19 on the device runtime (paper Table
1; the port's counterpart of ``benchmarks/miniqmc.py``'s ``run`` and
``main``):

    python -m repro_torch.bench.miniqmc

Each region is one CUDA source, ``csrc/miniqmc/<name>.cu``, built twice
by ``standin.twins``: against ``csrc/rt/`` (portable, the paper's
"New") and against ``csrc/native/rt_native.cuh`` (native, its
"Original").

The public functions :func:`evaluate_vgh` and
:func:`evaluate_det_ratios` take the reference's operands.  A CPU
tensor takes the plain version (``miniqmc_ref.py``); a CUDA tensor the
kernel, the native build with ``native=True``, or the call raises: each
refuses what its kernel does not take.

:func:`run` holds, at the reference's shapes and at a card shape, the
native and the portable build bit for bit, and each of them and the
generic build within the stated tolerance of the plain version; then it
makes ``N_CALLS`` calls of each build, the generic one, the plain
version and the PyTorch library call in turns (CUDA events around each
call, L2 flushed before it, the order alternating).  :func:`report`
prints the paper's Table 1 rows (per region and build: total ms over
the calls, the calls, and avg/min/max µs a call), with the rest beside
them.  Exits 1, after printing everything, if any check fails.  Needs a
CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import json
import math
import statistics
import sys
import time
from typing import Callable, Dict, List, Tuple

import torch

from repro_torch.bench import miniqmc_ref as ref
from repro_torch.bench import standin
from repro_torch.bench.standin import (I, INT32_MAX, P, bound, check_builds,
                                       f32, failures_of, refuse, twins)
from repro_torch.bench.timing import times_in_turns, under
from repro_torch.core import build
from repro_torch.core.build import CudaKernel, check_cuda, ptr, stream_of
from repro_torch.core.runtime import DeviceRuntime

VGH = twins("miniqmc/evaluate_vgh.cu", "evaluate_vgh_fwd",
            [P, P, P, P, P, I, I, I, P])
DET_RATIOS = twins("miniqmc/evaluate_det_ratios.cu",
                   "evaluate_det_ratios_fwd", [P, P, P, I, I, P])
#: region -> (portable, native) builds
TWINS = {"evaluate_vgh": VGH, "evaluateDetRatios": DET_RATIOS}
#: region -> the TPU kernel it replaces
REPLACES = {"evaluate_vgh": "benchmarks/miniqmc.py:43",
            "evaluateDetRatios": "benchmarks/miniqmc.py:89"}
#: orbitals the det-ratio kernel takes: phi is staged in the 48 KB of
#: shared memory a launch has without opting in to more
MAX_ORBITALS = 48 * 1024 // 4


def evaluate_vgh(coefs4: torch.Tensor, t: torch.Tensor, *,
                 native: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(value, grad, hess), each (NW, NS) f32: the cubic B-spline basis
    of t (NW, 1) and its two derivatives on the taps coefs4 (NW, 4,
    NS); NW in blocks of min(8, NW) walkers, as the reference's grid."""
    refuse(coefs4.dim() != 3 or coefs4.shape[1] != 4 or coefs4.numel() == 0
           or t.shape != (coefs4.shape[0], 1),
           f"evaluate_vgh: coefs4 must be (NW, 4, NS) and t (NW, 1), "
           f"NW, NS >= 1, got {tuple(coefs4.shape)} and {tuple(t.shape)}")
    nw, _, ns = coefs4.shape
    block = min(ref.WALKER_BLOCK, nw)
    refuse(nw % block or nw // block > 65535 or ns > INT32_MAX // 4,
           f"evaluate_vgh: NW must be below {ref.WALKER_BLOCK} or a "
           f"multiple of it (the reference's blocks), within the grid, "
           f"got NW {nw}, NS {ns}")
    f32("evaluate_vgh", coefs4, t)
    if coefs4.device.type == "cpu":
        return ref.evaluate_vgh_ref(coefs4, t)
    check_cuda("evaluate_vgh", coefs4, t)
    outs = tuple(torch.empty(nw, ns, dtype=torch.float32,
                             device=coefs4.device) for _ in range(3))
    VGH[native].launch(ptr(coefs4), ptr(t), *map(ptr, outs), nw, block, ns,
                       stream_of(coefs4))
    return outs


def evaluate_det_ratios(a_inv: torch.Tensor, phi: torch.Tensor, *,
                        native: bool = False) -> torch.Tensor:
    """(NW, N) f32: each walker's Sherman-Morrison ratios phi A_inv, for
    a_inv (NW, N, N) and phi (NW, N); N at most :data:`MAX_ORBITALS`."""
    refuse(a_inv.dim() != 3 or a_inv.shape[1] != a_inv.shape[2]
           or a_inv.numel() == 0 or phi.shape != a_inv.shape[:2],
           f"evaluate_det_ratios: a_inv must be (NW, N, N) and phi "
           f"(NW, N), NW, N >= 1, got {tuple(a_inv.shape)} and "
           f"{tuple(phi.shape)}")
    nw, n, _ = a_inv.shape
    refuse(n > MAX_ORBITALS or nw > INT32_MAX,
           f"evaluate_det_ratios: N must be at most {MAX_ORBITALS} (phi "
           f"is staged in shared memory), got NW {nw}, N {n}")
    f32("evaluate_det_ratios", a_inv, phi)
    if a_inv.device.type == "cpu":
        return ref.evaluate_det_ratios_ref(a_inv, phi)
    check_cuda("evaluate_det_ratios", a_inv, phi)
    out = torch.empty(nw, n, dtype=torch.float32, device=a_inv.device)
    DET_RATIOS[native].launch(ptr(a_inv), ptr(phi), ptr(out), nw, n,
                              stream_of(a_inv))
    return out


#: region -> (public function, plain version)
FUNCS: Dict[str, Tuple[Callable, Callable]] = {
    "evaluate_vgh": (evaluate_vgh, ref.evaluate_vgh_ref),
    "evaluateDetRatios": (evaluate_det_ratios, ref.evaluate_det_ratios_ref)}


def tolerance(name: str, args, want) -> Tuple[float, float]:
    """(atol, rtol) of a region's outputs against its plain version (or
    the reference's), absolute only.

    evaluate_vgh: each output is sum_k w_k c_k with |w_k| <= 2 (the
    hessian's 3t - 2), so the terms' magnitudes add up to at most
    8 max|c|; the weights (up to five roundings each, or FMA
    contraction) and the three adds round about ten times in another
    way, 10 x 2^-24 x 8 max|c| ~ 4.8e-6 max|c|: 1e-5 max|c|.
    evaluateDetRatios: two f32 sums of N products in different orders
    (the kernel's in order with FMA, the plain version's blocked by
    cuBLAS or the CPU); each one's rounding errors add up like a random
    walk of N steps of at most 2^-24 of a partial sum, and the partial
    sums are bounded by S_j = sum_i |phi_i| |A_ij|: so twice sqrt(N)
    2^-24 max S, 2^-23 sqrt(N) max S.
    """
    if name == "evaluate_vgh":
        return 1e-5 * float(args[0].abs().max()), 0.0
    if name == "evaluateDetRatios":
        a_inv, phi = args
        s = (phi.abs()[:, :, None] * a_inv.abs()).sum(dim=1)
        return 2.0 ** -23 * math.sqrt(a_inv.shape[1]) * float(s.max()), 0.0
    raise KeyError(name)


def cost(name: str, args) -> Dict[str, object]:
    """Bytes and operations of one launch on ``args`` (each input read
    once, each output written once) and the least time the card could
    take (``standin.bound``)."""
    if name == "evaluate_vgh":
        # the taps and t read, three outputs written; three 4-tap sums
        # (4 multiplies, 3 adds) a spline, and the 40 flops of a
        # walker's 12 weights
        nw, _, ns = args[0].shape
        return bound(4 * (7 * nw * ns + nw), 21 * nw * ns + 40 * nw)
    if name == "evaluateDetRatios":
        # each A_inv and phi read, the ratios written; an FMA a product
        nw, n, _ = args[0].shape
        return bound(4 * (nw * n * n + 2 * nw * n), 2 * nw * n * n)
    raise KeyError(name)


def library(name: str, args) -> Callable:
    """One PyTorch call computing the same function, TF32 off: the
    det ratios are ``torch.bmm(phi[:, None], a_inv)``; evaluate_vgh is
    one ``torch.bmm`` of each walker's (3, 4) weights with its taps, the
    weights' computation counted in."""
    if name == "evaluate_vgh":
        coefs4, t = args

        def vgh():
            with ref.no_tf32():
                return torch.bmm(ref.basis(t), coefs4)
        return vgh
    if name == "evaluateDetRatios":
        a_inv, phi = args

        def det_ratios():
            with ref.no_tf32():
                return torch.bmm(phi[:, None], a_inv)
        return det_ratios
    raise KeyError(name)


def table1(ms: List[float]) -> Dict[str, float]:
    """The paper's Table 1 columns of one region and build: total ms,
    calls, and avg/min/max µs a call."""
    us = [1e3 * m for m in ms]
    return {"time_ms": sum(ms), "calls": len(ms),
            "avg_us": statistics.fmean(us), "min_us": min(us),
            "max_us": max(us)}


def compare(name: str, label: str, args, flush: torch.Tensor) -> dict:
    """One region at one shape on the card: ``standin.check_builds``,
    then ``N_CALLS`` calls each of the native, portable and generic
    builds, the plain version and the library call in turns: Table 1's
    columns for the two builds, the median ms of each (``launch_ms``: a
    call is one launch), and the cost of the launch."""
    fn, plain_fn = FUNCS[name]

    def portable():
        return fn(*args)

    res = check_builds(fn, plain_fn, args,
                       lambda want: tolerance(name, args, want))
    ms = times_in_turns([lambda: fn(*args, native=True), portable,
                         under("generic", portable),
                         lambda: plain_fn(*args), library(name, args)],
                        flush, ref.N_CALLS)
    return {"pair": TWINS[name][0].name, "bench": name, "case": label,
            "shape": list(ref.SHAPES[label][name]), "dtype": "float32",
            **res, "launch_ms": dict(zip(
                ("native", "portable", "generic", "plain", "library"),
                map(statistics.median, ms))),
            "table1": {"Original": table1(ms[0]), "New": table1(ms[1])},
            **cost(name, args)}


def generic_jobs() -> List[Tuple[CudaKernel, DeviceRuntime]]:
    """The portable builds for the generic target."""
    return standin.generic_jobs(TWINS.values())


def cases(device, flush: torch.Tensor) -> List[dict]:
    """:func:`compare` of both regions at the reference's shapes, then
    at the card's, on inputs drawn from seed 0."""
    out = []
    for label in ("reference", "card"):
        for name in ref.NAMES:
            args = tuple(torch.from_numpy(a).to(device)
                         for a in ref.inputs(name, label))
            out.append(compare(name, label, args, flush))
            del args
            torch.cuda.empty_cache()
    return out


def run(device="cuda") -> dict:
    """Build the four kernels and the two generic builds, then
    :func:`cases` at the reference's and the card's shapes; ``failures``
    lists what failed."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the miniQMC regions run on the CUDA card, got "
                         f"{dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the miniQMC regions run on the "
                           "card")
    t0 = time.perf_counter()
    build.build_all(extra=generic_jobs())
    build_s = time.perf_counter() - t0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    res = cases(dev, flush)
    return {"device": torch.cuda.get_device_name(dev), "build_s": build_s,
            "cases": res,
            "failures": [m for c in res for m in failures_of(c)]}


HEADER = ("region,version,time_ms,calls,avg_us,min_us,max_us,max_abs_diff,"
          "shape,generic_us,plain_us,library_us,bound_us,bound_by,"
          "err_vs_plain,atol")


def rows(c: dict) -> List[str]:
    """The reference's Table 1 rows of one case (Original = native, New
    = portable: the total over the calls, the calls, avg/min/max µs),
    then the rest of the case (medians in µs)."""
    out = []
    us = {k: 1e3 * v for k, v in c["launch_ms"].items()}
    for version, side in (("Original", "native"), ("New", "portable")):
        t = c["table1"][version]
        out.append(
            f"{c['bench']},{version},{t['time_ms']:.4f},{t['calls']},"
            f"{t['avg_us']:.1f},{t['min_us']:.1f},{t['max_us']:.1f},"
            f"{c['max_abs_diff']:.3e},{'x'.join(map(str, c['shape']))},"
            f"{us['generic']:.1f},{us['plain']:.1f},{us['library']:.1f},"
            f"{1e3 * c['bound_ms']:.1f},{c['bound_by']},"
            f"{c[f'err_{side}']:.3e},{c['tol']:.3g}")
    return out


def report(res: dict) -> None:
    """Print the table, two rows a region and shape, then one JSON
    line."""
    print(f"miniQMC regions on {res['device']}; builds "
          f"{res['build_s']:.1f} s; {ref.N_CALLS} calls of each build in "
          f"turns, L2 flushed before each")
    print(HEADER)
    for c in res["cases"]:
        print("\n".join(rows(c)))
    print(json.dumps({"miniqmc": res}))


def main() -> int:
    if not torch.cuda.is_available():
        print("miniqmc: no CUDA device; the regions run on the card",
              file=sys.stderr)
        return 1
    res = run()
    report(res)
    if res["failures"]:
        print("miniqmc: failed:\n  " + "\n  ".join(res["failures"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
