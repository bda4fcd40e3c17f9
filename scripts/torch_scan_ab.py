#!/usr/bin/env python3
"""Time the mLSTM scan B10 at xlstm-1.3b's largest prefill group (B 2 x
S 511, 4 heads of Dk = Dv = 1024, with its state; bf16, and f32 beside
it) and the SPEC ACCEL stand-in pomriq B14 at its card shape (nx
262,144 x nk 2,048; portable and native builds) for the ``repro_torch``
package found under ``--src``, and hold each to its plain versions.

Register allocation moves with small source changes, so compare two
versions only inside one call on one card, in turns:

    for s in build/parent/src src src build/parent/src; do
        python3 scripts/torch_scan_ab.py --src $s --tag ${s%%/*}; done

Each run builds its kernels into its own checkout's ``build/``, spins
the card for about a second and prints one JSON line: medians (ms, CUDA
events, 20 launches, the L2 flushed and the card left to settle before
each, ``bench/timing.py``), and the largest errors of B10 (h and the
state (C, n, m), f32 outputs only, and bf16 h) against its recurrent
plain version and, where the package has it, against the chunkwise one
(``mlstm_scan_ref(chunk=...)``, bf16) at xlstm's shapes (S 1, 17, 64, 200 and
511, bf16; S 64 and 200 in f32; the registry example, Dk 32, in f32 and
bf16), and of pomriq's builds against its plain version (with the
tolerance of ``bench/spec_accel.py``, and whether the twins agree bit
for bit).  ``--sass`` prints each build's registers, spills and HMMA,
MUFU and total SASS instructions (``cuobjdump``) instead.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    ap.add_argument("--sass", action="store_true",
                    help="print each B10 and B14 build's registers, local "
                    "bytes and HMMA, MUFU and total SASS instructions, and "
                    "exit")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.bench import spec_accel as sa
    from repro_torch.bench import spec_accel_ref as sa_ref
    from repro_torch.bench.timing import time_in_turns
    from repro_torch.core import tuning
    from repro_torch.kernels.mlstm_scan import mlstm_scan as kern
    from repro_torch.kernels.mlstm_scan import ops, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)

    def operands(b, n, h, d, dt):
        def rnd(*shape):
            return torch.randn(*shape, device=dev, generator=g)
        q, k, v = (rnd(b, h, n, d).to(dt) for _ in range(3))
        return q, k, v, rnd(b, h, n), rnd(b, h, n) + 2.0

    if args.sass:
        # every kernel of each library by its mangled name: B10's two
        # bodies share their template arguments, so parity.kernels_of,
        # which pairs twins by those, would keep one of them
        from repro_torch.bench import parity
        for k in (kern.KERNEL, *sa.POMRIQ):
            lib = str(k.build())
            hists = parity.opcode_histograms(
                parity._run([parity._tool("cuobjdump"), "-sass", lib]))
            usage = parity.resource_usage(
                parity._run([parity._tool("cuobjdump"), "-res-usage", lib]))
            dem = parity._run([parity._tool("cu++filt"),
                               *hists]).splitlines()
            for mangled, d in zip(hists, dem):
                name, targs = parity.instantiation(d)
                h = hists[mangled]
                print(json.dumps({
                    "tag": args.tag, "build": k.name,
                    "kernel": (f"{name}<{', '.join(targs)}>" if targs
                               else name),
                    "regs": usage[mangled]["regs"],
                    "local": usage[mangled]["local"],
                    "hmma": sum(c for op, c in h.items()
                                if op.startswith("HMMA")),
                    "mufu": {op: c for op, c in h.items()
                             if op.startswith("MUFU")},
                    "instructions": sum(h.values())}))
        return 0
    chunked = "chunk" in inspect.signature(ref.mlstm_scan_ref).parameters

    def plain_chunk(dt):
        return kern.plain_chunk(dt) if hasattr(kern, "plain_chunk") else None

    def errs(got, want):
        """max |got - want| of each f32 output, and of h."""
        return [float((a.float() - b.float()).abs().max())
                for a, b in zip(got, want)]

    err = {}
    for b, n, h, d, dt in [(1, 64, 2, 32, torch.float32),
                           (1, 64, 2, 32, torch.bfloat16),
                           *((b, n, 4, 1024, torch.bfloat16)
                             for b in (1, 2) for n in (1, 17, 64, 200, 511)),
                           (1, 64, 4, 1024, torch.float32),
                           (1, 200, 4, 1024, torch.float32)]:
        a = operands(b, n, h, d, dt)
        hh, st = ops.mlstm_scan(*a, return_state=True)
        got = (hh, *st)
        wh, wst = ref.mlstm_scan_ref(*a, return_state=True)
        key = f"{b}x{n}x{h}x{d} {str(dt)[6:]}"
        err[key] = {"recurrent": errs(got, (wh, *wst))}
        if chunked and plain_chunk(dt):
            ch, cst = ref.mlstm_scan_ref(*a, return_state=True,
                                         chunk=plain_chunk(dt))
            err[key]["chunkwise"] = errs(got, (ch, *cst))
        alone = ops.mlstm_scan(*a)
        err[key]["h_alone_equal"] = bool(torch.equal(alone, hh))
        del a, got, wh, wst
        torch.cuda.empty_cache()

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    torch.cuda._sleep(2_000_000_000)  # spin the card up
    xl = operands(2, 511, 4, 1024, torch.bfloat16)
    xl32 = tuple(t.float() for t in xl)
    px = tuple(torch.from_numpy(x).to(dev)
               for x in sa_ref.inputs("514.pomriq", "card"))
    want = sa_ref.pomriq_ref(*px)
    out_p, out_n = sa.pomriq(*px), sa.pomriq(*px, native=True)
    atol, _ = sa.tolerance("514.pomriq", px, want)
    ms = time_in_turns([lambda: ops.mlstm_scan(*xl, return_state=True),
                        lambda: ops.mlstm_scan(*xl32, return_state=True),
                        lambda: sa.pomriq(*px),
                        lambda: sa.pomriq(*px, native=True)], flush)
    print(json.dumps({
        "tag": args.tag, "device": torch.cuda.get_device_name(dev),
        "chunk": tuning.block_size("mlstm_scan", "chunk"),
        "mlstm_bf16_ms": ms[0], "mlstm_f32_ms": ms[1],
        "pomriq_ms": ms[2], "pomriq_native_ms": ms[3],
        "pomriq_err": float((out_p - want).abs().max()),
        "pomriq_native_err": float((out_n - want).abs().max()),
        "pomriq_tol": atol, "pomriq_twins_equal": bool(torch.equal(out_p,
                                                                   out_n)),
        "mlstm_err": err}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
