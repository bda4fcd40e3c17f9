#!/usr/bin/env python3
"""How pbt's kernel (B17, ``csrc/spec_accel/pbt.cu``: one thread a
system, every access strided by n) scales with the number of systems,
on the card:

    PYTHONPATH=src python3 scripts/torch_pbt_scaling.py

For nb systems of n = 512 unknowns (nb from one warp to the card
shape's 65,536), the median ms of one launch over 20 (CUDA events, L2
flushed before each), beside the bytes' bound and the ns a sweep step
takes per system.  A time that stays flat while nb grows is the latency
of one system's chain of steps; a time that grows with nb is a limit of
the memory system's throughput.  Prints the card's name and power limit
first.  Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from repro_torch.bench import spec_accel as sa
from repro_torch.bench.timing import time_in_turns

N = 512
SYSTEMS = (8, 1024, 4096, 8192, 16384, 32768, 65536)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_pbt_scaling: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    print("nb,n,ms,bound_ms,ns_per_step")
    for nb in SYSTEMS:
        # the reference's distributions, as spec_accel_ref.inputs
        rng = np.random.default_rng(0)
        lo, up, di = (rng.random((nb, N), dtype=np.float32) for _ in "lud")
        args = [torch.from_numpy(a).cuda() for a in (
            0.4 * lo, 2.0 + di, 0.4 * up,
            rng.standard_normal((nb, N), dtype=np.float32))]
        ms = time_in_turns([lambda: sa.pbt(*args)], flush)[0]
        bound = sa.cost("570.pbt", args)["bound_ms"]
        print(f"{nb},{N},{ms:.4f},{bound:.4f},"
              f"{ms * 1e6 / (2 * N - 1):.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
