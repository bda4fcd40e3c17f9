"""The device runtime's test kernel (``csrc/rt_selftest.cu``) and its
plain version.

The kernel is the counterpart of the Pallas kernel in
``tests/test_runtime.py``: teams, ``static_partition``, carve-outs of
the shared arena, block reductions and every atomic, here under real
contention (teams run in parallel, in no order).  :func:`plain` replays
the same items one at a time through ``core/atomics.py``;
:func:`mismatches` holds the kernel to it by the outcomes that do not
depend on the order: the sum of the adds, the max and the min, exactly
one winning cas, the exchanged values' total, the wraparound
increment's final value and the count of each captured old value, and
each team's partition, sum and max, which every thread of the team
must have received (``reduce_errs``, counted by the kernel, is 0); and
``approx_reciprocal`` (the
hardware's on the card's target, a division on the generic one) within
``RECIP_REL_ERR`` of 1/x.

Two builds of the one source: :data:`KERNEL` exercises the target
part too (``atomic_inc``, ``make_async_copy``) and so fails to compile
for the generic target; :data:`PORTABLE` exercises the portable part
only and builds for both.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from repro_torch.core import atomics, intrinsics
from repro_torch.core.build import CudaKernel, ptr, stream_of
from repro_torch.core.runtime import DeviceRuntime

NT = 128                       # threads per team (csrc/rt_selftest.cu)
#: counters[] of the kernel, in its order
COUNTERS = ("add", "max", "min", "cas", "wins", "exch", "exch_olds",
            "arena_errs", "reduce_errs")
#: their values before the kernel
INITIAL = (0, -1, 1 << 30, -1, 0, -1, 0, 0, 0)
#: approx_reciprocal's relative error bound: rcp.approx.ftz.f32 is within
#: 1 ulp (2^-23) of 1/x (PTX ISA), and a division is correctly rounded
RECIP_REL_ERR = 2.0 ** -22

_p, _i = ctypes.c_void_p, ctypes.c_int
_ARGS = [_i, _i, ctypes.c_uint] + [_p] * 10
KERNEL = CudaKernel("rt_selftest", "rt_selftest.cu", "rt_selftest", _ARGS,
                    flags=("-DRT_SELFTEST_TARGET=1",))
PORTABLE = CudaKernel("rt_selftest_portable", "rt_selftest.cu",
                      "rt_selftest", _ARGS)


def key_of(i: int) -> int:
    """Item i's value, as the kernel computes it (32-bit unsigned)."""
    return (i * 2654435761) % (1 << 32) % 1000


def _recip_rel_err(recips: torch.Tensor) -> float:
    """Largest |r - 1/x| x over the kernel's reciprocals of x = 1, 2, ..."""
    x = torch.arange(1, recips.numel() + 1, dtype=torch.float64)
    return float(((recips.double().cpu().flatten() - 1.0 / x) * x)
                 .abs().max())


def _src(teams: int, device) -> torch.Tensor:
    """16 bytes per thread for the staged copy: thread t of team j holds
    the four ints 4 (j NT + t) + 0..3."""
    return torch.arange(teams * NT * 4, dtype=torch.int32,
                        device=device).view(teams, NT, 4)


def plain(teams: int, total: int, bound: int) -> Dict[str, object]:
    """The kernel's outcomes with the items taken in order, one atomic
    at a time through ``core/atomics.py``."""
    c = torch.tensor(INITIAL, dtype=torch.int64)
    inc = torch.zeros((), dtype=torch.int64)
    olds, parts, sums, maxes = [], [], [], []
    at = {name: n for n, name in enumerate(COUNTERS)}
    for team in range(teams):
        lo, hi = DeviceRuntime.static_partition(total, teams, team)
        parts.append((lo, hi))
        keys = [key_of(i) for i in range(lo, hi)]
        sums.append(float(sum(keys)))
        maxes.append(float(max(keys)) if keys else float("-inf"))
        for i, key in zip(range(lo, hi), keys):
            atomics.atomic_add(c, key, at["add"])
            atomics.atomic_max(c, key, at["max"])
            atomics.atomic_min(c, key, at["min"])
            if int(atomics.atomic_cas(c, -1, i, at["cas"])) == -1:
                atomics.atomic_add(c, 1, at["wins"])
            old = atomics.atomic_exchange(c, key, at["exch"])
            atomics.atomic_add(c, old, at["exch_olds"])
            olds.append(int(atomics.atomic_inc(inc, bound)))
    src = _src(teams, "cpu")
    recips = intrinsics.approx_reciprocal.variant_for("cpu")(
        torch.arange(1, teams * NT + 1, dtype=torch.float32))
    return {"counters": dict(zip(COUNTERS, c.tolist())),
            "recip_rel_err": _recip_rel_err(recips),
            "inc": int(inc), "inc_olds": olds, "parts": parts,
            "team_sums": sums, "team_maxes": maxes,
            "copied": torch.roll(src, -1, dims=1)}


def buffers(teams: int, total: int, device) -> Dict[str, torch.Tensor]:
    """The kernel's operands on ``device``."""
    i32 = dict(dtype=torch.int32, device=device)
    src = _src(teams, device)
    return {"init": torch.tensor(INITIAL, **i32),
            "parts": torch.empty(teams, 2, **i32),
            "counters": torch.empty(len(INITIAL), **i32),
            "inc": torch.empty(1, **i32),
            "inc_olds": torch.empty(max(total, 1), **i32),
            "sums": torch.empty(teams, dtype=torch.float32, device=device),
            "maxes": torch.empty(teams, dtype=torch.float32, device=device),
            "recips": torch.empty(teams, NT, dtype=torch.float32,
                                  device=device),
            "src": src, "copied": torch.empty_like(src)}


def start(bufs: Dict[str, torch.Tensor], teams: int, total: int, bound: int,
          *, portable: bool = False) -> None:
    """Reset the counters and launch the kernel (``PORTABLE``'s build
    with ``portable``) on the buffers' device, without waiting."""
    b = bufs
    b["counters"].copy_(b["init"])
    b["inc"].zero_()
    b["inc_olds"].fill_(-1)
    b["copied"].zero_()
    kernel = PORTABLE if portable else KERNEL
    kernel.launch(teams, total, bound, ptr(b["parts"]), ptr(b["counters"]),
                  ptr(b["inc"]), ptr(b["inc_olds"]), ptr(b["sums"]),
                  ptr(b["maxes"]), ptr(b["recips"]), ptr(b["src"]),
                  ptr(b["copied"]), stream_of(b["src"]))


def launch(teams: int, total: int, bound: int, *, portable: bool = False,
           device="cuda") -> Dict[str, object]:
    """Run the kernel on ``device``: its outcomes, as :func:`plain`
    gives them (the portable build leaves ``inc``, ``inc_olds`` and
    ``copied`` out).  A CPU device takes :func:`plain`."""
    device = torch.device(device)
    if device.type == "cpu":
        return plain(teams, total, bound)
    b = buffers(teams, total, device)
    start(b, teams, total, bound, portable=portable)
    out = {"counters": dict(zip(COUNTERS, b["counters"].tolist())),
           "parts": [tuple(p) for p in b["parts"].tolist()],
           "team_sums": b["sums"].tolist(),
           "team_maxes": b["maxes"].tolist(),
           "recip_rel_err": _recip_rel_err(b["recips"])}
    if not portable:
        out.update(inc=int(b["inc"].item()),
                   inc_olds=b["inc_olds"][:total].tolist(),
                   copied=b["copied"].cpu())
    return out


def mismatches(got: Dict[str, object], want: Dict[str, object],
               total: int, bound: int) -> List[str]:
    """The order-free outcomes on which ``got`` (the kernel) and
    ``want`` (:func:`plain`) differ; empty when they agree."""
    bad = []
    g, w = got["counters"], want["counters"]
    for name in ("add", "max", "min", "arena_errs", "reduce_errs"):
        if g[name] != w[name]:
            bad.append(f"{name}: {g[name]} (plain {w[name]})")
    if g["wins"] != 1 or w["wins"] != 1 or not 0 <= g["cas"] < total:
        bad.append(f"cas: {g['wins']} winners, final {g['cas']}")
    # every value exchanged out plus the last one in = the start + all keys
    if g["exch_olds"] + g["exch"] != w["exch_olds"] + w["exch"]:
        bad.append(f"exchange: olds {g['exch_olds']} + final {g['exch']} "
                   f"!= {w['exch_olds'] + w['exch']}")
    for name in ("parts", "team_sums", "team_maxes"):
        if list(got[name]) != list(want[name]):
            bad.append(f"{name} differ")
    if not got["recip_rel_err"] <= RECIP_REL_ERR:
        bad.append(f"approx_reciprocal off 1/x by {got['recip_rel_err']:.3g}"
                   f" relative (bound {RECIP_REL_ERR:.3g})")
    if "inc" in got:
        if got["inc"] != total % (bound + 1) or want["inc"] != got["inc"]:
            bad.append(f"atomic_inc final {got['inc']}, want "
                       f"{total % (bound + 1)}")
        hist = torch.bincount(torch.tensor(got["inc_olds"], dtype=torch.int64)
                              .clamp(min=0), minlength=bound + 1)
        want_hist = torch.bincount(torch.tensor(want["inc_olds"],
                                                dtype=torch.int64),
                                   minlength=bound + 1)
        if (min(got["inc_olds"], default=0) < 0
                or not torch.equal(hist, want_hist)):
            bad.append("atomic_inc: the captured old values' counts differ")
        if not torch.equal(got["copied"], want["copied"]):
            bad.append("make_async_copy: staged bytes differ")
    return bad
