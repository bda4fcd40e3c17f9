"""The SPEC ACCEL stand-ins B12-B17 on the device runtime (paper Fig. 2;
the port's counterpart of ``benchmarks/spec_accel.py``'s ``run`` and
``main``):

    python -m repro_torch.bench.spec_accel

Each stand-in is one CUDA source, ``csrc/spec_accel/<name>.cu``, built
twice by ``standin.twins``: against ``csrc/rt/`` (portable) and against
``csrc/native/rt_native.cuh`` (native).

The public functions :func:`postencil`, :func:`polbm`, :func:`pomriq`,
:func:`pep`, :func:`pcg` and :func:`pbt` take the reference's operands.
A CPU tensor takes the plain version (``spec_accel_ref.py``); a CUDA
tensor the kernel, the native build with ``native=True``, or the call
raises: each refuses what its kernel does not take.

:func:`run` holds, at the reference's shapes and at a card shape of
the same block laws, the native and the portable build bit for bit,
and each of them and the generic build within the stated tolerance of
the plain version; it times each whole function in turns (CUDA events,
L2 flushed, median of ``TURNS``, the order alternating), beside the
plain version and, for postencil, the PyTorch library call that
computes a sweep, and one launch of each build where a call makes
several (postencil's sweep, pcg's SpMV).  :func:`report` prints the
reference's Fig. 2 row (original = native, new = portable) for each,
with the rest beside it.  Exits 1, after printing everything, if any
check fails.  Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.bench import spec_accel_ref as ref
from repro_torch.bench import standin
from repro_torch.bench.standin import (I, INT32_MAX,  # noqa: F401
                                       NATIVE_DEFINE, P, bound,
                                       check_builds, f32, failures_of,
                                       refuse, twins)
from repro_torch.bench.timing import time_in_turns, under
from repro_torch.core import build
from repro_torch.core.build import CudaKernel, check_cuda, ptr, stream_of
from repro_torch.core.runtime import DeviceRuntime

TURNS = 20

POSTENCIL = twins("spec_accel/postencil.cu", "postencil_sweep",
                  [P, P, I, I, P])
POLBM = twins("spec_accel/polbm.cu", "polbm_step", [P, P, I, I, P])
POMRIQ = twins("spec_accel/pomriq.cu", "pomriq_fwd", [P, P, P, P, I, I, P])
PEP = twins("spec_accel/pep.cu", "pep_fwd", [P, P, I, P])
PCG = twins("spec_accel/pcg.cu", "pcg_spmv_fwd", [P, P, P, P, I, P])
PBT = twins("spec_accel/pbt.cu", "pbt_fwd", [P] * 7 + [I, I, P])
#: stand-in -> (portable, native) builds
TWINS = {"503.postencil": POSTENCIL, "504.polbm": POLBM,
         "514.pomriq": POMRIQ, "552.pep": PEP, "554.pcg": PCG,
         "570.pbt": PBT}
#: stand-in -> the TPU kernel it replaces
REPLACES = {"503.postencil": "benchmarks/spec_accel.py:53",
            "504.polbm": "benchmarks/spec_accel.py:101",
            "514.pomriq": "benchmarks/spec_accel.py:137",
            "552.pep": "benchmarks/spec_accel.py:182",
            "554.pcg": "benchmarks/spec_accel.py:211",
            "570.pbt": "benchmarks/spec_accel.py:249"}


def postencil(x: torch.Tensor, iters: int = ref.ITERS, *,
              native: bool = False) -> torch.Tensor:
    """``iters`` Jacobi sweeps 0.2 (c + n + s + e + w) of x (h, w) f32
    over a zero border; h a multiple of 64.  One launch a sweep."""
    refuse(x.dim() != 2 or x.shape[0] % 64 or x.numel() == 0,
           f"postencil: x must be (h, w) with h a positive multiple of "
           f"64, got {tuple(x.shape)}")
    refuse(x.shape[0] > 65535 * 16 or x.numel() > INT32_MAX,
           f"postencil: {tuple(x.shape)} is past the kernel's grid")
    refuse(iters < 0, f"postencil: iters must be >= 0, got {iters}")
    f32("postencil", x)
    if x.device.type == "cpu":
        return ref.postencil_ref(x, iters)
    check_cuda("postencil", x)
    h, w = x.shape
    kernel = POSTENCIL[native]
    bufs = (torch.empty_like(x), torch.empty_like(x))
    for i in range(iters):
        kernel.launch(ptr(x), ptr(bufs[i % 2]), h, w, stream_of(x))
        x = bufs[i % 2]
    return x


def polbm(f: torch.Tensor, *, native: bool = False) -> torch.Tensor:
    """One D2Q9 collision (tau 0.6) and periodic streaming step of f
    (h, w, 9) f32; h a multiple of 64."""
    refuse(f.dim() != 3 or f.shape[2] != 9 or f.shape[0] % 64
           or f.numel() == 0,
           f"polbm: f must be (h, w, 9) with h a positive multiple of 64, "
           f"got {tuple(f.shape)}")
    refuse(f.numel() > INT32_MAX,
           f"polbm: {tuple(f.shape)} is past the kernel's indexing")
    f32("polbm", f)
    if f.device.type == "cpu":
        return ref.polbm_ref(f)
    check_cuda("polbm", f)
    out = torch.empty_like(f)
    POLBM[native].launch(ptr(f), ptr(out), f.shape[0], f.shape[1],
                         stream_of(f))
    return out


def pomriq(x: torch.Tensor, kgrid: torch.Tensor, phi: torch.Tensor, *,
           native: bool = False) -> torch.Tensor:
    """Q(x_i) = sum_k phi_k cos(2 pi k . x_i): x (nx, 3), kgrid (nk, 3),
    phi (nk,) f32 -> (nx, 1); nx and nk multiples of 128."""
    refuse(x.dim() != 2 or x.shape[1] != 3 or kgrid.dim() != 2
           or kgrid.shape[1] != 3 or phi.shape != kgrid.shape[:1],
           f"pomriq: x must be (nx, 3), kgrid (nk, 3) and phi (nk,), got "
           f"{tuple(x.shape)}, {tuple(kgrid.shape)}, {tuple(phi.shape)}")
    nx, nk = x.shape[0], kgrid.shape[0]
    refuse(nx == 0 or nk == 0 or nx % 128 or nk % 128,
           f"pomriq: nx and nk must be positive multiples of 128, got "
           f"{nx} and {nk}")
    refuse(3 * max(nx, nk) > INT32_MAX,
           f"pomriq: nx {nx}, nk {nk} are past the kernel's indexing")
    f32("pomriq", x, kgrid, phi)
    if x.device.type == "cpu":
        return ref.pomriq_ref(x, kgrid, phi)
    check_cuda("pomriq", x, kgrid, phi)
    out = torch.empty(nx, 1, dtype=torch.float32, device=x.device)
    POMRIQ[native].launch(ptr(x), ptr(kgrid), ptr(phi), ptr(out), nx, nk,
                          stream_of(x))
    return out


def pep(seeds: torch.Tensor, *, native: bool = False) -> torch.Tensor:
    """Per block of 256 int32 seeds: hash, Box-Muller, then [sum z,
    sum z^2, max z, sum |z|] -> (n / 256, 4) f32."""
    n = seeds.shape[0] if seeds.dim() == 1 else -1
    refuse(n <= 0 or n % ref.PEP_BLOCK,
           f"pep: seeds must be (n,) with n a positive multiple of "
           f"{ref.PEP_BLOCK}, got {tuple(seeds.shape)}")
    refuse(seeds.dtype != torch.int32,
           f"pep: seeds must be int32, got {seeds.dtype}")
    if seeds.device.type == "cpu":
        return ref.pep_ref(seeds)
    check_cuda("pep", seeds)
    out = torch.empty(n // ref.PEP_BLOCK, 4, dtype=torch.float32,
                      device=seeds.device)
    PEP[native].launch(ptr(seeds), ptr(out), n, stream_of(seeds))
    return out


def _pcg_operands(diag: torch.Tensor, off: torch.Tensor,
                  x: torch.Tensor) -> None:
    n = x.shape[0] if x.dim() == 1 else -1
    refuse(n <= 0 or diag.shape != x.shape or off.shape != x.shape,
           f"pcg: diag, off and the vector must be (n,) of one n >= 1, "
           f"got {tuple(diag.shape)}, {tuple(off.shape)}, {tuple(x.shape)}")
    f32("pcg", diag, off, x)


def _spmv(diag: torch.Tensor, off: torch.Tensor, x: torch.Tensor,
          native: bool) -> torch.Tensor:
    y = torch.empty_like(x)
    PCG[native].launch(ptr(diag), ptr(off), ptr(x), ptr(y), x.shape[0],
                       stream_of(x))
    return y


def pcg_spmv(diag: torch.Tensor, off: torch.Tensor, x: torch.Tensor, *,
             native: bool = False) -> torch.Tensor:
    """y = diag x + off (x_{i+1} + x_{i-1}), zero past both ends, f32
    (n,): pcg's kernel, one launch.  The operator is the reference's,
    which is not symmetric (A[i, i+1] = off_i, A[i+1, i] = off_{i+1})."""
    _pcg_operands(diag, off, x)
    if x.device.type == "cpu":
        return ref.pcg_spmv_ref(diag, off, x)
    check_cuda("pcg", diag, off, x)
    return _spmv(diag, off, x, native)


def pcg(diag: torch.Tensor, off: torch.Tensor, b: torch.Tensor,
        iters: int = ref.CG_ITERS, *, native: bool = False) -> torch.Tensor:
    """``iters`` CG iterations from x = 0 on A x = b, A the tridiagonal
    of :func:`pcg_spmv`: one launch before the loop and one an
    iteration; the dots and vector updates are torch operations on the
    card, as the reference's are jnp outside its kernel, and nothing
    waits on the host.  The matrix is the reference's, not symmetric;
    CG converges in 8 iterations on the reference's inputs because
    their rows are strongly diagonally dominant (diag >= 2, off <= 0.4).
    """
    refuse(iters < 0, f"pcg: iters must be >= 0, got {iters}")
    _pcg_operands(diag, off, b)
    if b.device.type == "cpu":
        return ref.pcg_ref(diag, off, b, iters)
    check_cuda("pcg", diag, off, b)
    return ref.cg(lambda v: _spmv(diag, off, v, native), b, iters)


def pbt_sweeps(lower: torch.Tensor, diag: torch.Tensor,
               upper: torch.Tensor, rhs: torch.Tensor, *,
               native: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, cp, dp): the batched Thomas solves of nb tridiagonal systems
    of n unknowns, each operand (nb, n) f32, with the forward sweep's
    cp and dp that the kernel writes as the reference's does."""
    ops = (lower, diag, upper, rhs)
    refuse(rhs.dim() != 2 or rhs.numel() == 0
           or any(t.shape != rhs.shape for t in ops),
           f"pbt: lower, diag, upper and rhs must be (nb, n) of one "
           f"shape, nb, n >= 1, got {[tuple(t.shape) for t in ops]}")
    f32("pbt", *ops)
    if rhs.device.type == "cpu":
        return ref.pbt_sweeps(*ops)
    check_cuda("pbt", *ops)
    outs = tuple(torch.empty_like(rhs) for _ in range(3))
    PBT[native].launch(*map(ptr, ops + outs), *rhs.shape, stream_of(rhs))
    return outs


def pbt(lower: torch.Tensor, diag: torch.Tensor, upper: torch.Tensor,
        rhs: torch.Tensor, *, native: bool = False) -> torch.Tensor:
    """The solutions x (nb, n) of :func:`pbt_sweeps`, one launch."""
    return pbt_sweeps(lower, diag, upper, rhs, native=native)[0]


#: stand-in -> (public function, plain version)
FUNCS: Dict[str, Tuple[Callable, Callable]] = {
    "503.postencil": (postencil, ref.postencil_ref),
    "504.polbm": (polbm, ref.polbm_ref),
    "514.pomriq": (pomriq, ref.pomriq_ref),
    "552.pep": (pep, ref.pep_ref),
    "554.pcg": (pcg, ref.pcg_ref),
    "570.pbt": (pbt, ref.pbt_ref)}
#: kernel launches per call of each public function
LAUNCHES = {"503.postencil": ref.ITERS, "504.polbm": 1, "514.pomriq": 1,
            "552.pep": 1, "554.pcg": ref.CG_ITERS + 1, "570.pbt": 1}
#: where a call makes several launches: (one launch, its plain version)
#: on the call's operands, timed on their own
ONE_LAUNCH: Dict[str, Tuple[Callable, Callable]] = {
    "503.postencil": (lambda x, native=False: postencil(x, 1, native=native),
                      lambda x: ref.postencil_ref(x, 1)),
    "554.pcg": (pcg_spmv, ref.pcg_spmv_ref)}


def tolerance(name: str, args, want: torch.Tensor) -> Tuple[float, float]:
    """(atol, rtol) of a stand-in's output against its plain version
    (or the reference's), given the plain output ``want``.

    postencil: the same adds in the same order and one multiply, f32, no
    contraction possible: near-exact, 1e-6 (a few ulps of |x| ~ 1).
    polbm: sums over 9 in another order and FMA contraction of cu and
    feq, amplified 1/0.6 by the relaxation, values up to ~7: 1e-5.
    pomriq: the kernel reduces the phase d = x . k (in turns) exactly,
    r = d - rint(d) (exact in f32 for |d| < 2^22), and takes the
    special-function unit's cosine of f32(2 pi) r in [-pi, pi]: its
    absolute error there is about 2^-21.4 (3.6e-7), and f32(2 pi) r
    rounds by at most 1.2e-7 rad.  The plain version rounds its phase
    f32(2 pi) d, up to ~60 rad, to f32 (ulp ~4e-6) and carries f32(2 pi)'s
    own error |d| 1.7e-7 rad; the dot sums in another order (FMA), about
    2 pi ulp(d).  So each cosine may move by a few 1e-6, with either
    sign: ~1e-6 nk max|phi| absolute, no relative part (measured on the
    card: 1.6e-4 of 8.4e-3 at nx 262,144 x nk 2,048).
    pep: logf/cosf/sqrtf differ by ulps (~2e-7 of |z|) and each block
    sums 256 terms in another order: 1e-5 relative, and 1e-5 of the
    largest block's sum |z| absolute, since sum z may be near 0.
    pcg: each SpMV row moves by an ulp or two (FMA contraction), the
    dots sum n terms in another order, and CG's 8 iterations on a
    matrix this diagonally dominant (Gershgorin: eigenvalues in [1.2,
    3.8]) do not amplify that much; f32 against f64 on the CPU is 2e-7
    at the reference's n and 5.9e-7 (max|x| 2.6) at n = 2^24: 1e-5 of
    max|x| absolute and 1e-5 relative.
    pbt: each unknown takes a few roundings a step in another
    contraction, and the elimination damps them (|cp| <= 0.21, each step
    carries the last error times |l cp| <= 0.09); f32 against f64 on the
    CPU is 2e-7 at the reference's shape and 3.9e-7 at (65536, 512):
    1e-5 of max|x| absolute and 1e-5 relative.
    """
    if name == "503.postencil":
        return 1e-6, 1e-6
    if name == "504.polbm":
        return 1e-5, 1e-5
    if name == "514.pomriq":
        phi = args[2]
        return 1e-6 * phi.shape[0] * float(phi.abs().max()), 0.0
    if name == "552.pep":
        return 1e-5 * float(want[:, 3].max()), 1e-5
    if name in ("554.pcg", "570.pbt"):
        return 1e-5 * float(want.abs().max()), 1e-5
    raise KeyError(name)


def cost(name: str, args) -> Dict[str, object]:
    """Bytes and operations of one launch on ``args`` (each input read
    once, each output written once) and the least time the card could
    take (``standin.bound``); pomriq and pep count their cos, log and
    sqrt, pbt its divisions, at the special-function rate, beside their
    flops at the f32 rate, and the larger of the two stands."""
    if name == "503.postencil":
        h, w = args[0].shape
        return bound(2 * 4 * h * w, 5 * h * w)
    if name == "504.polbm":
        h, w, q = args[0].shape
        # 45 for the three sums over k, 2 divisions and usq's 3, then
        # 15 a plane (cu 3, feq 9, the relaxation 3)
        return bound(2 * 4 * h * w * q, 185 * h * w)
    if name == "514.pomriq":
        nx, nk = args[0].shape[0], args[1].shape[0]
        # the dot 5, the 2 pi 1, the weighted add 2, and one cos a pair
        return bound(4 * (4 * nx + 4 * nk), 8 * nx * nk, nx * nk)
    if name == "552.pep":
        n = args[0].shape[0]
        # the uniforms 4, -2 log 1, r cos 2, the moments 5; log, sqrt, cos
        return bound(4 * n + 16 * (n // ref.PEP_BLOCK), 12 * n, 3 * n)
    if name == "554.pcg":
        # the SpMV: diag, off, x read, y written; 2 multiplies, 2 adds
        n = args[0].shape[0]
        return bound(16 * n, 4 * n)
    if name == "570.pbt":
        # four inputs read, x, cp and dp written; m 2, dp's numerator 2,
        # the back substitution 2 and the loop's 2, and two divisions
        nb, n = args[3].shape
        return bound(28 * nb * n, 8 * nb * n, 2 * nb * n)
    raise KeyError(name)


def library(name: str, args) -> Optional[Callable]:
    """One PyTorch call per launch computing the same function, where
    there is one: a sweep of postencil is a 3 x 3 cross convolution of
    weights 0.2 with zero padding (TF32 off).  None for the others: no
    single PyTorch call applies or solves a tridiagonal system (a dense
    ``linalg.solve`` or sparse product does other work)."""
    if name != "503.postencil":
        return None
    x = args[0][None, None]
    cross = torch.tensor([[0.0, 0.2, 0.0], [0.2, 0.2, 0.2], [0.0, 0.2, 0.0]],
                         device=x.device)[None, None]

    def sweeps():
        y = x
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for _ in range(LAUNCHES[name]):
                y = torch.nn.functional.conv2d(y, cross, padding=1)
        return y
    return sweeps


def compare(name: str, label: str, args, flush: torch.Tensor) -> dict:
    """One stand-in at one shape on the card: ``standin.check_builds``;
    each whole function's median ms in turns (native, portable, generic,
    plain and the library call, where there is one), and ms of one
    launch (``launch_ms``: the whole function's where a call is one
    launch, else :data:`ONE_LAUNCH` timed in its own turns); the cost
    of one launch.  Keys as ``bench/parity.py``'s cases."""
    fn, plain_fn = FUNCS[name]

    def portable():
        return fn(*args)

    def native():
        return fn(*args, native=True)

    res = check_builds(fn, plain_fn, args,
                       lambda want: tolerance(name, args, want))
    lib = library(name, args)
    ms = time_in_turns([native, portable, under("generic", portable),
                        lambda: plain_fn(*args)] + ([lib] if lib else []),
                       flush, TURNS)
    n = LAUNCHES[name]
    one = ms[:4]
    if name in ONE_LAUNCH:
        step, plain_step = ONE_LAUNCH[name]
        one = time_in_turns([lambda: step(*args, native=True),
                             lambda: step(*args),
                             under("generic", lambda: step(*args)),
                             lambda: plain_step(*args)], flush, TURNS)
    launch_ms = dict(zip(("native", "portable", "generic", "plain"), one))
    launch_ms["library"] = ms[4] / n if lib else None
    return {"pair": TWINS[name][0].name, "bench": name, "case": label,
            "shape": list(ref.SHAPES[label][name]), "dtype": "float32",
            **res, "ms_native": ms[0], "ms_portable": ms[1],
            "ms_generic": ms[2], "ms_plain": ms[3],
            "ms_library": ms[4] if lib else None, "launch_ms": launch_ms,
            "launches_per_call": n, **cost(name, args)}


def generic_jobs() -> List[Tuple[CudaKernel, DeviceRuntime]]:
    """The portable builds for the generic target."""
    return standin.generic_jobs(TWINS.values())


def cases(device, flush: torch.Tensor) -> List[dict]:
    """:func:`compare` of every stand-in at the reference's shapes, then
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
    """Build the twelve kernels and the six generic builds, then
    :func:`cases` at the reference's and the card's shapes; ``failures``
    lists what failed."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the SPEC ACCEL stand-ins run on the CUDA card, "
                         f"got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the SPEC ACCEL stand-ins run "
                           "on the card")
    t0 = time.perf_counter()
    build.build_all(extra=generic_jobs())
    build_s = time.perf_counter() - t0
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    res = cases(dev, flush)
    return {"device": torch.cuda.get_device_name(dev), "build_s": build_s,
            "cases": res,
            "failures": [m for c in res for m in failures_of(c)]}


HEADER = ("bench,original_ms,new_ms,delta_pct,max_abs_diff,shape,generic_ms,"
          "plain_ms,library_ms,launches,ms_per_launch,bound_ms_per_launch,"
          "bound_by,err_native,err_portable,err_generic,atol,rtol")


def row(c: dict) -> str:
    """The reference's Fig. 2 row (original = native, new = portable,
    whole functions), then the rest of the case (``ms_per_launch``: one
    launch of the portable build)."""
    delta = 100.0 * (c["ms_portable"] - c["ms_native"]) / c["ms_native"]
    lib = "" if c["ms_library"] is None else f"{c['ms_library']:.4f}"
    return (f"{c['bench']},{c['ms_native']:.4f},{c['ms_portable']:.4f},"
            f"{delta:+.1f}%,{c['max_abs_diff']:.3e},"
            f"{'x'.join(map(str, c['shape']))},{c['ms_generic']:.4f},"
            f"{c['ms_plain']:.4f},{lib},{c['launches_per_call']},"
            f"{c['launch_ms']['portable']:.4f},"
            f"{c['bound_ms']:.4f},{c['bound_by']},{c['err_native']:.3e},"
            f"{c['err_portable']:.3e},{c['err_generic']:.3e},"
            f"{c['tol']:.3g},{c['rtol']:g}")


def report(res: dict) -> None:
    """Print the table, one row a stand-in and shape, then one JSON
    line."""
    print(f"SPEC ACCEL stand-ins on {res['device']}; builds "
          f"{res['build_s']:.1f} s; median of {TURNS} turns, L2 flushed")
    print(HEADER)
    for c in res["cases"]:
        print(row(c))
    print(json.dumps({"spec_accel": res}))


def main() -> int:
    if not torch.cuda.is_available():
        print("spec_accel: no CUDA device; the stand-ins run on the card",
              file=sys.stderr)
        return 1
    res = run()
    report(res)
    if res["failures"]:
        print("spec_accel: failed:\n  " + "\n  ".join(res["failures"]),
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
