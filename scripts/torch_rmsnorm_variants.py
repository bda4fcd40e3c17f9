#!/usr/bin/env python3
"""B1's schedules against each other and ``F.rms_norm``, on one CUDA card.

B1 (``src/repro_torch/csrc/rmsnorm.cu``) picks its schedule by the row's
bytes: staged through the arena two rows a team below TWO_ROWS_BYTES,
one row a team up to MAX_STAGED_BYTES, and the streaming body (a team a
row, scalar loads: the design before staging) otherwise.  This script
builds the source again with those two constants rewritten, so that
every served shape takes each schedule in turn (under ``build/
variants/``, each bound as a kernel of its own), and at granite-8b's,
gemma2-2b's and jamba-1.5-large-398b's prefill rows in bf16:

1. holds every schedule's output to the shipped one's, bit for bit (the
   sums are the same in every schedule);
2. times them in turns beside ``F.rms_norm`` (the library call computing
   the same function, with ``w + 1`` made beforehand): CUDA events, the
   L2 flushed and the card left to settle before each launch, median of
   20, after a second of spinning that brings the clocks up.

  PYTHONPATH=src python3 scripts/torch_rmsnorm_variants.py

Exits 1 if a schedule's bits differ.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.bench.timing import time_in_turns  # noqa: E402
from repro_torch.core.build import CSRC, CudaKernel, build_all  # noqa: E402
from repro_torch.kernels.rmsnorm import ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm as rk  # noqa: E402

SHAPES = (("granite", 4096, 4096), ("gemma2", 18000, 2304),
          ("jamba", 1022, 8192))
TWO = "constexpr size_t TWO_ROWS_BYTES = 8 * 1024;"
MAX = "constexpr size_t MAX_STAGED_BYTES = 48 * 1024 - 256;"
#: name -> (TWO_ROWS_BYTES, MAX_STAGED_BYTES) in place of the shipped ones
SCHEDULES = {"streaming": ("0", "0"), "one row a team": ("0", None),
             "two rows a team": ("48 * 1024", None)}


def schedule_kernel(name: str, two, most) -> CudaKernel:
    """B1 with its schedule constants rewritten, bound as its own kernel."""
    src = (CSRC / "rmsnorm.cu").read_text()
    for line in (TWO, MAX):
        if src.count(line) != 1:
            raise ValueError(f"rmsnorm.cu does not hold {line!r} once")
    src = src.replace(TWO, TWO.replace("8 * 1024", two))
    if most is not None:
        src = src.replace(MAX, MAX.replace("48 * 1024 - 256", most))
    tag = name.replace(" ", "_")
    path = ROOT / "build" / "variants" / f"rmsnorm_{tag}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    return CudaKernel(f"rmsnorm_{tag}", os.path.relpath(path, CSRC),
                      rk.KERNEL.symbol, rk.KERNEL.argtypes)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_rmsnorm_variants: needs a CUDA card", file=sys.stderr)
        return 1
    kernels = {n: schedule_kernel(n, *c) for n, c in SCHEDULES.items()}
    build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    torch.cuda._sleep(2_000_000_000)  # about a second: the clocks up
    g = torch.Generator(device=dev).manual_seed(0)
    kw = dict(eps=1e-6, weight_offset=1.0)
    out, same = {}, True
    for label, rows, d in SHAPES:
        x = torch.randn(rows, d, device=dev, generator=g).bfloat16()
        w = (0.1 * torch.randn(d, device=dev, generator=g)).bfloat16()
        w1 = w + 1.0
        shipped = ops.rmsnorm(x, w, **kw)
        fns = {"shipped": lambda: ops.rmsnorm(x, w, **kw)}
        bits = {}
        for name, kern in kernels.items():
            fns[name] = (lambda kern=kern: rk.rmsnorm_fwd(x, w, kernel=kern,
                                                          **kw))
            bits[name] = bool(torch.equal(fns[name](), shipped))
            same &= bits[name]
        fns["F.rms_norm"] = lambda: torch.nn.functional.rms_norm(
            x, (d,), w1, 1e-6)
        ms = dict(zip(fns, time_in_turns(list(fns.values()), flush)))
        out[label] = {"ms": ms, "bit_identical": bits}
        print(f"B1 {label} ({rows}, {d}) bf16 ms: " + ", ".join(
            f"{n} {t:.4f}" for n, t in ms.items()) + "; bits equal to the "
            "shipped schedule's: " + ", ".join(
                f"{n} {b}" for n, b in bits.items()), flush=True)
    print(json.dumps({"rmsnorm_variants": {"device": smi, **out}}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
