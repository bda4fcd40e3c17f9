#!/usr/bin/env python3
"""Time the SPEC ACCEL stand-ins polbm (B13, (2048, 2048, 9) f32) and
pep (B15, 2^26 seeds) at their card shapes, portable and native builds,
for the ``repro_torch`` package found under ``--src``, and hold each
build (generic too) to its plain version.

Register allocation moves with small source changes, so compare two
versions only inside one call on one card, in turns, then compare their
outputs bit for bit:

    for s in build/parent/src src src build/parent/src; do
        python3 scripts/torch_standin_ab.py --src $s --tag ${s%%/*} \\
            --save build/standin_${s%%/*}.pt; done
    python3 scripts/torch_standin_ab.py --compare build/standin_build.pt \\
        build/standin_src.pt

Each run builds its kernels into its own checkout's ``build/``, spins
the card for about a second and prints one JSON line: the card's name
and power limit (``nvidia-smi``), medians (ms, CUDA events, 20 launches,
the L2 flushed and the card left to settle before each,
``bench/timing.py``), and at the reference's and the card's shapes the
largest error of each build against its plain version, with the
tolerance of ``bench/spec_accel.py``, and whether the twins agree bit
for bit.  ``--save`` writes the portable build's outputs on the inputs
of seed 0 (about 160 MB: keep it under ``build/``); ``--compare A B``
prints, for each output, whether the two files hold the same bits and
the largest difference.  ``--sass`` prints instead each build's
registers, local (spill) bytes, static shared bytes, the shared bytes
of its launch at the reference's shape (static and the arena, read from
a ``torch.profiler`` trace of one call), MUFU, I2F and all SASS
instructions (``cuobjdump``), and whether the twins' SASS is the same.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

NAMES = ("504.polbm", "552.pep")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def compare(a: str, b: str) -> int:
    import torch
    sa, sb = torch.load(a), torch.load(b)
    out = {k: {"bit_identical": bool(torch.equal(sa[k], sb[k])),
               "max_abs_diff": float((sa[k] - sb[k]).abs().max()),
               "differing": int((sa[k] != sb[k]).sum())}
           for k in sorted(set(sa) & set(sb))}
    print(json.dumps({"compare": [a, b], "outputs": out}))
    return 0


def launch_shared(calls) -> list:
    """The shared bytes (static and dynamic) of each kernel launch that
    ``calls`` make, in launch order, from one ``torch.profiler`` trace
    of them all (profiled one call at a time, the third and later
    showed no kernel on the H100); each call is made once before, to
    build and load its kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for call in calls:
        call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for call in calls:
            call()
        torch.cuda.synchronize()
    with tempfile.NamedTemporaryFile(suffix=".json") as tmp:
        prof.export_chrome_trace(tmp.name)
        events = json.load(open(tmp.name))["traceEvents"]
    return [e["args"].get("shared memory")
            for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "kernel"]


def sass(tag: str) -> int:
    import torch
    from repro_torch.bench import parity
    from repro_torch.bench import spec_accel as sa
    from repro_torch.bench import spec_accel_ref as sa_ref
    from repro_torch.bench.timing import under

    dev = torch.device("cuda")
    builds = ("portable", "native", "generic")
    calls = []
    for name in NAMES:
        fn = sa.FUNCS[name][0]
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in sa_ref.inputs(name, "reference"))
        calls += [lambda fn=fn, a=args: fn(*a),
                  lambda fn=fn, a=args: fn(*a, native=True),
                  under("generic", lambda fn=fn, a=args: fn(*a))]
    shared = launch_shared(calls)
    if len(shared) != len(calls):  # one launch a call, or none read
        shared = [None] * len(calls)
    for n, name in enumerate(NAMES):
        portable, native = sa.TWINS[name]
        twins = parity.compare_sass(portable.name, portable, native)
        for build, lib in (("portable", portable.build()),
                           ("native", native.build()),
                           ("generic", portable.build(parity.GENERIC))):
            for k in parity.kernels_of(lib).values():
                h = k["hist"]
                print(json.dumps({
                    "tag": tag, "bench": name, "build": build,
                    "kernel": k["kernel"], "regs": k["regs"],
                    "local": k["local"], "static_shared": k["shared"],
                    "launch_shared": shared[3 * n + builds.index(build)],
                    "mufu": {op: c for op, c in h.items()
                             if op.startswith("MUFU")},
                    "i2f": {op: c for op, c in h.items()
                            if op.startswith("I2F")},
                    "instructions": sum(h.values())}))
        print(json.dumps({"tag": tag, "bench": name,
                          "twins_same_sass": all(not r["diff"]
                                                 for r in twins),
                          "twins": twins}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", default=None,
                    help="write the portable build's outputs here")
    ap.add_argument("--compare", nargs=2, default=None, metavar=("A", "B"))
    ap.add_argument("--sass", action="store_true",
                    help="print each build's registers, spills, shared "
                    "and launch bytes, MUFU, I2F and total SASS "
                    "instructions, and exit")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, str(Path(args.src).resolve()))
    if args.sass:
        return sass(args.tag)
    import torch
    from repro_torch.bench import spec_accel as sa
    from repro_torch.bench import spec_accel_ref as sa_ref
    from repro_torch.bench.standin import check_builds
    from repro_torch.bench.timing import time_in_turns

    dev = torch.device("cuda")
    checks, saved, ops = {}, {}, {}
    for label in ("reference", "card"):
        for name in NAMES:
            a = tuple(torch.from_numpy(x).to(dev)
                      for x in sa_ref.inputs(name, label))
            fn, plain = sa.FUNCS[name]
            res = check_builds(fn, plain, a,
                               lambda want: sa.tolerance(name, a, want))
            checks[f"{name} {label}"] = {
                k: res[k] for k in ("bit_identical", "err_portable",
                                    "err_native", "err_generic", "ok_portable",
                                    "ok_native", "ok_generic", "tol", "rtol")}
            if args.save:
                saved[f"{name} {label}"] = fn(*a).cpu()
            if label == "card":
                ops[name] = a
            else:
                del a
    torch.cuda.empty_cache()
    if args.save:
        torch.save(saved, args.save)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    torch.cuda._sleep(2_000_000_000)  # spin the card up
    f, seeds = ops["504.polbm"], ops["552.pep"]
    ms = time_in_turns([lambda: sa.polbm(*f),
                        lambda: sa.polbm(*f, native=True),
                        lambda: sa.pep(*seeds),
                        lambda: sa.pep(*seeds, native=True)], flush)
    print(json.dumps({
        "tag": args.tag, "device": torch.cuda.get_device_name(dev),
        "card": card(), "polbm_ms": ms[0], "polbm_native_ms": ms[1],
        "pep_ms": ms[2], "pep_native_ms": ms[3],
        "bound_ms": {n: sa.cost(n, ops[n])["bound_ms"] for n in NAMES},
        "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
