"""What the stand-ins on the device runtime share (``bench/spec_accel.py``
for the SPEC ACCEL ones, ``bench/miniqmc.py`` for miniQMC's regions):
the two builds of one source, the launchers' refusals, the least time
the card could take for a launch, and the check of the native, portable
and generic builds against the plain version.

Each stand-in is one CUDA source written once against the runtime
facade and built twice, as the reference binds one Pallas body to both
runtimes: the portable member against ``csrc/rt/runtime.cuh`` (under
``target("generic")``, with its generic target part), the native member
with ``-DREPRO_RT_NATIVE`` against ``csrc/native/rt_native.cuh``, which
binds the same ``rt::`` surface straight to CUDA (the counterpart of
``benchmarks/native_rt.py``'s ``NativeRuntime``).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from repro_torch.bench.timing import under
from repro_torch.core.build import CudaKernel
from repro_torch.core.context import context_for
from repro_torch.core.runtime import DeviceRuntime

NATIVE_DEFINE = "-DREPRO_RT_NATIVE"
#: H100 SXM (NVIDIA's data sheet): HBM3 bytes/s; f32 flops/s outside
#: the tensor cores; the special-function unit's 16 operations a clock
#: per SM x 132 SMs x the 1,980 MHz boost clock (CUDA C++ Programming
#: Guide, arithmetic instruction throughput), the rate the log, sqrt,
#: cos and a division's reciprocal are counted at
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9
INT32_MAX = (1 << 31) - 1
P, I = ctypes.c_void_p, ctypes.c_int


def twins(source: str, symbol: str, argtypes: Sequence
          ) -> Tuple[CudaKernel, CudaKernel]:
    """(portable, native): the two builds of ``csrc/<source>``, named
    after the file (``spec_accel/pep.cu`` gives ``pep`` and
    ``pep_native``)."""
    name = source.rsplit("/", 1)[-1].removesuffix(".cu")
    return (CudaKernel(name, source, symbol, argtypes),
            CudaKernel(f"{name}_native", source, symbol, argtypes,
                       flags=(NATIVE_DEFINE,)))


def refuse(bad: bool, what: str) -> None:
    if bad:
        raise ValueError(what)


def f32(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        refuse(t.dtype != torch.float32,
               f"{name}: operands must be float32, got {t.dtype}")


def bound(nbytes: int, flops: int, trans: int = 0) -> Dict[str, object]:
    """The least time the card could take for a launch that moves
    ``nbytes`` and does ``flops`` f32 operations and ``trans``
    special-function ones: the larger of the bytes over the HBM rate and
    the operations over their rate, the larger of the two kinds of
    operation standing (``ops_per_s``, in ``unit``)."""
    t_flops, t_trans = flops / F32_FLOPS_PER_S, trans / SFU_OPS_PER_S
    ops, rate, unit = ((trans, SFU_OPS_PER_S, "G special-function ops")
                       if t_trans > t_flops else
                       (flops, F32_FLOPS_PER_S, "GFLOP f32"))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return {"bytes": nbytes, "ops": ops, "ops_per_s": rate, "unit": unit,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def outputs(out) -> Tuple[torch.Tensor, ...]:
    return out if isinstance(out, tuple) else (out,)


def err(got, want, atol: float, rtol: float) -> Tuple[float, bool]:
    """(max |got - want| over the outputs, whether every output is
    finite, of its plain shape and within ``atol`` and ``rtol``)."""
    pairs = list(zip(outputs(got), outputs(want)))
    ok = len(pairs) == len(outputs(want)) and all(
        g.shape == w.shape and bool(torch.isfinite(g).all())
        and bool(torch.allclose(g, w, atol=atol, rtol=rtol))
        for g, w in pairs)
    return max(float((g - w).abs().max()) for g, w in pairs), ok


def check_builds(fn: Callable, plain_fn: Callable, args,
                 tolerance: Callable) -> Dict[str, object]:
    """A stand-in's native, portable and generic builds and its plain
    version, once each on ``args``: the native and portable outputs bit
    for bit, and each build within ``tolerance(want)`` (atol, rtol) of
    the plain output ``want``."""
    out_n, out_p = fn(*args, native=True), fn(*args)
    out_g = under("generic", lambda: fn(*args))()
    want = plain_fn(*args)
    torch.cuda.synchronize()
    atol, rtol = tolerance(want)
    res = {"bit_identical": all(
               torch.equal(a, b)
               for a, b in zip(outputs(out_n), outputs(out_p))),
           "max_abs_diff": max(
               float((a - b).abs().max())
               for a, b in zip(outputs(out_n), outputs(out_p))),
           "tol": atol, "rtol": rtol}
    for side, out in (("native", out_n), ("portable", out_p),
                      ("generic", out_g)):
        res[f"err_{side}"], res[f"ok_{side}"] = err(out, want, atol, rtol)
    return res


def failures_of(c: dict) -> List[str]:
    """What failed in one case of a stand-in's ``compare``."""
    what = f"{c['bench']} {c['case']} {tuple(c['shape'])}"
    tol = f"(atol {c['tol']:.3g}, rtol {c['rtol']:g})"
    out = [] if c["bit_identical"] else [
        f"{what}: native and portable outputs differ (max |diff| "
        f"{c['max_abs_diff']:.3e})"]
    return out + [f"{what}: {side} off its plain version by "
                  f"{c[f'err_{side}']:.3e} {tol}"
                  for side in ("native", "portable", "generic")
                  if not c[f"ok_{side}"]]


def generic_jobs(pairs) -> List[Tuple[CudaKernel, DeviceRuntime]]:
    """The portable member of each (portable, native) pair, for the
    generic target."""
    rt = DeviceRuntime(context_for("generic"))
    return [(pair[0], rt) for pair in pairs]
