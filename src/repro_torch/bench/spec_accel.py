"""The SPEC ACCEL stand-ins B12-B15 on the device runtime (paper Fig. 2;
the port's counterpart of ``benchmarks/spec_accel.py``'s ``run`` and
``main`` for its first four stand-ins):

    python -m repro_torch.bench.spec_accel

Each stand-in is one CUDA source, ``csrc/spec_accel/<name>.cu``, written
once against the runtime facade and built twice, as the reference binds
one Pallas body to both runtimes: the portable member against
``csrc/rt/runtime.cuh`` (under ``target("generic")``, with its generic
target part), the native member with ``-DREPRO_RT_NATIVE`` against
``csrc/native/rt_native.cuh``, which binds the same ``rt::`` surface
straight to CUDA (the counterpart of ``benchmarks/native_rt.py``'s
``NativeRuntime``).

The public functions :func:`postencil`, :func:`polbm`, :func:`pomriq`
and :func:`pep` take the reference's operands.  A CPU tensor takes the
plain version (``spec_accel_ref.py``); a CUDA tensor the kernel, the
native build with ``native=True``, or the call raises: each refuses
what its kernel does not take.

:func:`run` holds, at the reference's shapes and at a card shape of
the same block laws, the native and the portable build bit for bit,
and each of them and the generic build within the stated tolerance of
the plain version; it times each whole function in turns (CUDA events,
L2 flushed, median of ``TURNS``, the order alternating), beside the
plain version and, for postencil, the PyTorch library call that
computes a sweep.  :func:`report` prints the reference's Fig. 2 row
(original = native, new = portable) for each, with the rest beside it.
Exits 1, after printing everything, if any check fails.  Needs a CUDA
card and the CUDA toolkit.
"""
from __future__ import annotations

import ctypes
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.bench import spec_accel_ref as ref
from repro_torch.bench.timing import time_in_turns, under
from repro_torch.core import build
from repro_torch.core.build import CudaKernel, check_cuda, ptr, stream_of
from repro_torch.core.context import context_for
from repro_torch.core.runtime import DeviceRuntime

TURNS = 20
NATIVE_DEFINE = "-DREPRO_RT_NATIVE"
#: H100 SXM (NVIDIA's data sheet): HBM3 bytes/s; f32 flops/s outside
#: the tensor cores; the special-function unit's 16 operations a clock
#: per SM x 132 SMs x the 1,980 MHz boost clock (CUDA C++ Programming
#: Guide, arithmetic instruction throughput), the rate the log, sqrt and
#: cos are counted at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9

_p, _i = ctypes.c_void_p, ctypes.c_int


def _twins(name: str, symbol: str, argtypes) -> Tuple[CudaKernel,
                                                      CudaKernel]:
    """(portable, native): the two builds of ``spec_accel/<name>.cu``."""
    source = f"spec_accel/{name}.cu"
    return (CudaKernel(name, source, symbol, argtypes),
            CudaKernel(f"{name}_native", source, symbol, argtypes,
                       flags=(NATIVE_DEFINE,)))


POSTENCIL = _twins("postencil", "postencil_sweep", [_p, _p, _i, _i, _p])
POLBM = _twins("polbm", "polbm_step", [_p, _p, _i, _i, _p])
POMRIQ = _twins("pomriq", "pomriq_fwd", [_p, _p, _p, _p, _i, _i, _p])
PEP = _twins("pep", "pep_fwd", [_p, _p, _i, _p])
#: stand-in -> (portable, native) builds
TWINS = {"503.postencil": POSTENCIL, "504.polbm": POLBM,
         "514.pomriq": POMRIQ, "552.pep": PEP}
#: stand-in -> the TPU kernel it replaces
REPLACES = {"503.postencil": "benchmarks/spec_accel.py:53",
            "504.polbm": "benchmarks/spec_accel.py:101",
            "514.pomriq": "benchmarks/spec_accel.py:137",
            "552.pep": "benchmarks/spec_accel.py:182"}
_INT32_MAX = (1 << 31) - 1


def _refuse(bad: bool, what: str) -> None:
    if bad:
        raise ValueError(what)


def _f32(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        _refuse(t.dtype != torch.float32,
                f"{name}: operands must be float32, got {t.dtype}")


def postencil(x: torch.Tensor, iters: int = ref.ITERS, *,
              native: bool = False) -> torch.Tensor:
    """``iters`` Jacobi sweeps 0.2 (c + n + s + e + w) of x (h, w) f32
    over a zero border; h a multiple of 64.  One launch a sweep."""
    _refuse(x.dim() != 2 or x.shape[0] % 64 or x.numel() == 0,
            f"postencil: x must be (h, w) with h a positive multiple of "
            f"64, got {tuple(x.shape)}")
    _refuse(x.shape[0] > 65535 * 16 or x.numel() > _INT32_MAX,
            f"postencil: {tuple(x.shape)} is past the kernel's grid")
    _refuse(iters < 0, f"postencil: iters must be >= 0, got {iters}")
    _f32("postencil", x)
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
    _refuse(f.dim() != 3 or f.shape[2] != 9 or f.shape[0] % 64
            or f.numel() == 0,
            f"polbm: f must be (h, w, 9) with h a positive multiple of 64, "
            f"got {tuple(f.shape)}")
    _refuse(f.numel() > _INT32_MAX,
            f"polbm: {tuple(f.shape)} is past the kernel's indexing")
    _f32("polbm", f)
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
    _refuse(x.dim() != 2 or x.shape[1] != 3 or kgrid.dim() != 2
            or kgrid.shape[1] != 3 or phi.shape != kgrid.shape[:1],
            f"pomriq: x must be (nx, 3), kgrid (nk, 3) and phi (nk,), got "
            f"{tuple(x.shape)}, {tuple(kgrid.shape)}, {tuple(phi.shape)}")
    nx, nk = x.shape[0], kgrid.shape[0]
    _refuse(nx == 0 or nk == 0 or nx % 128 or nk % 128,
            f"pomriq: nx and nk must be positive multiples of 128, got "
            f"{nx} and {nk}")
    _refuse(3 * max(nx, nk) > _INT32_MAX,
            f"pomriq: nx {nx}, nk {nk} are past the kernel's indexing")
    _f32("pomriq", x, kgrid, phi)
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
    _refuse(n <= 0 or n % ref.PEP_BLOCK,
            f"pep: seeds must be (n,) with n a positive multiple of "
            f"{ref.PEP_BLOCK}, got {tuple(seeds.shape)}")
    _refuse(seeds.dtype != torch.int32,
            f"pep: seeds must be int32, got {seeds.dtype}")
    if seeds.device.type == "cpu":
        return ref.pep_ref(seeds)
    check_cuda("pep", seeds)
    out = torch.empty(n // ref.PEP_BLOCK, 4, dtype=torch.float32,
                      device=seeds.device)
    PEP[native].launch(ptr(seeds), ptr(out), n, stream_of(seeds))
    return out


#: stand-in -> (public function, plain version)
FUNCS: Dict[str, Tuple[Callable, Callable]] = {
    "503.postencil": (postencil, ref.postencil_ref),
    "504.polbm": (polbm, ref.polbm_ref),
    "514.pomriq": (pomriq, ref.pomriq_ref),
    "552.pep": (pep, ref.pep_ref)}
#: kernel launches per call of each public function
LAUNCHES = {"503.postencil": ref.ITERS, "504.polbm": 1, "514.pomriq": 1,
            "552.pep": 1}


def tolerance(name: str, args, want: torch.Tensor) -> Tuple[float, float]:
    """(atol, rtol) of a stand-in's output against its plain version
    (or the reference's), given the plain output ``want``.

    postencil: the same adds in the same order and one multiply, f32, no
    contraction possible: near-exact, 1e-6 (a few ulps of |x| ~ 1).
    polbm: sums over 9 in another order and FMA contraction of cu and
    feq, amplified 1/0.6 by the relaxation, values up to ~7: 1e-5.
    pomriq: the phase, up to ~60 rad, rounds to f32 (ulp ~4e-6) and is
    summed in another way (FMA, dot order), so each cosine may move by
    a few 1e-6: ~1e-6 nk max|phi| absolute, no relative part.
    pep: logf/cosf/sqrtf differ by ulps (~2e-7 of |z|) and each block
    sums 256 terms in another order: 1e-5 relative, and 1e-5 of the
    largest block's sum |z| absolute, since sum z may be near 0.
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
    raise KeyError(name)


def cost(name: str, args) -> Dict[str, object]:
    """Bytes and operations of one launch on ``args`` (each input read
    once, each output written once) and the least time the card could
    take: the larger of bytes over the HBM rate and the operations over
    their rate (``ops_per_s``, in ``unit``); pomriq and pep count their
    cos, log and sqrt at the special-function rate, beside their flops
    at the f32 rate, and the larger of the two stands."""
    if name == "503.postencil":
        h, w = args[0].shape
        nbytes, flops, trans = 2 * 4 * h * w, 5 * h * w, 0
    elif name == "504.polbm":
        h, w, q = args[0].shape
        # 45 for the three sums over k, 2 divisions and usq's 3, then
        # 15 a plane (cu 3, feq 9, the relaxation 3)
        nbytes, flops, trans = 2 * 4 * h * w * q, 185 * h * w, 0
    elif name == "514.pomriq":
        nx, nk = args[0].shape[0], args[1].shape[0]
        # the dot 5, the 2 pi 1, the weighted add 2, and one cos a pair
        nbytes, flops, trans = 4 * (4 * nx + 4 * nk), 8 * nx * nk, nx * nk
    elif name == "552.pep":
        n = args[0].shape[0]
        # the uniforms 4, -2 log 1, r cos 2, the moments 5; log, sqrt, cos
        nbytes, flops, trans = 4 * n + 16 * (n // ref.PEP_BLOCK), 12 * n, \
            3 * n
    else:
        raise KeyError(name)
    t_flops, t_trans = flops / F32_FLOPS_PER_S, trans / SFU_OPS_PER_S
    ops, rate, unit = ((trans, SFU_OPS_PER_S, "G special-function ops")
                       if t_trans > t_flops else
                       (flops, F32_FLOPS_PER_S, "GFLOP f32"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bytes": nbytes, "ops": ops, "ops_per_s": rate, "unit": unit,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def library(name: str, args) -> Optional[Callable]:
    """One PyTorch call per launch computing the same function, where
    there is one: a sweep of postencil is a 3 x 3 cross convolution of
    weights 0.2 with zero padding (TF32 off).  None for the others."""
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


def _err(got: torch.Tensor, want: torch.Tensor, atol: float,
         rtol: float) -> Tuple[float, bool]:
    ok = (got.shape == want.shape and bool(torch.isfinite(got).all())
          and bool(torch.allclose(got, want, atol=atol, rtol=rtol)))
    return float((got - want).abs().max()), ok


def compare(name: str, label: str, args, flush: torch.Tensor) -> dict:
    """One stand-in at one shape on the card: the native and portable
    builds bit for bit; each of them and the generic build against the
    plain version; each whole function's median ms in turns (native,
    portable, generic, plain and the library call, where there is one);
    the cost of one launch.  Keys as ``bench/parity.py``'s cases."""
    fn, plain_fn = FUNCS[name]
    pair = TWINS[name][0].name

    def portable():
        return fn(*args)

    def native():
        return fn(*args, native=True)

    generic, plain = under("generic", portable), lambda: plain_fn(*args)
    out_n, out_p, out_g, want = native(), portable(), generic(), plain()
    torch.cuda.synchronize()
    atol, rtol = tolerance(name, args, want)
    err_n, ok_n = _err(out_n, want, atol, rtol)
    err_p, ok_p = _err(out_p, want, atol, rtol)
    err_g, ok_g = _err(out_g, want, atol, rtol)
    same = torch.equal(out_n, out_p)
    diff = float((out_n - out_p).abs().max())
    del out_n, out_p, out_g, want
    lib = library(name, args)
    ms = time_in_turns([native, portable, generic, plain]
                       + ([lib] if lib else []), flush, TURNS)
    return {"pair": pair, "bench": name, "case": label,
            "shape": list(ref.SHAPES[label][name]), "dtype": "float32",
            "bit_identical": same, "max_abs_diff": diff, "tol": atol,
            "rtol": rtol, "err_native": err_n, "err_portable": err_p,
            "err_generic": err_g, "ok_native": ok_n, "ok_portable": ok_p,
            "ok_generic": ok_g, "ms_native": ms[0], "ms_portable": ms[1],
            "ms_generic": ms[2], "ms_plain": ms[3],
            "ms_library": ms[4] if lib else None,
            "launches_per_call": LAUNCHES[name], **cost(name, args)}


def failures_of(c: dict) -> List[str]:
    """What failed in one case of :func:`compare`."""
    what = f"{c['bench']} {c['case']} {tuple(c['shape'])}"
    tol = f"(atol {c['tol']:.3g}, rtol {c['rtol']:g})"
    out = [] if c["bit_identical"] else [
        f"{what}: native and portable outputs differ (max |diff| "
        f"{c['max_abs_diff']:.3e})"]
    return out + [f"{what}: {side} off its plain version by "
                  f"{c[f'err_{side}']:.3e} {tol}"
                  for side in ("native", "portable", "generic")
                  if not c[f"ok_{side}"]]


def generic_jobs() -> List[Tuple[CudaKernel, DeviceRuntime]]:
    """The portable builds for the generic target."""
    rt = DeviceRuntime(context_for("generic"))
    return [(pair[0], rt) for pair in TWINS.values()]


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
    """Build the eight kernels and the four generic builds, then
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
          "plain_ms,library_ms,launches,bound_ms_per_launch,bound_by,"
          "err_native,err_portable,err_generic,atol,rtol")


def row(c: dict) -> str:
    """The reference's Fig. 2 row (original = native, new = portable,
    whole functions), then the rest of the case."""
    delta = 100.0 * (c["ms_portable"] - c["ms_native"]) / c["ms_native"]
    lib = "" if c["ms_library"] is None else f"{c['ms_library']:.4f}"
    return (f"{c['bench']},{c['ms_native']:.4f},{c['ms_portable']:.4f},"
            f"{delta:+.1f}%,{c['max_abs_diff']:.3e},"
            f"{'x'.join(map(str, c['shape']))},{c['ms_generic']:.4f},"
            f"{c['ms_plain']:.4f},{lib},{c['launches_per_call']},"
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
