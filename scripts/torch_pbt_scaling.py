#!/usr/bin/env python3
"""How pbt's kernel (B17, ``csrc/spec_accel/pbt.cu``: one thread a
system, tiles of columns staged through the arena) scales with the
number of systems, on the card, for the ``repro_torch`` package found
under ``--src``:

    PYTHONPATH=src python3 scripts/torch_pbt_scaling.py

For nb systems of n = 512 unknowns (nb from one warp to the card
shape's 65,536), the median ms of one launch over 20 (CUDA events, L2
flushed before each), beside the bytes' bound and the ns a sweep step
takes per system.  A time that stays flat while nb grows is the latency
of one system's chain of steps; a time that grows with nb is a limit of
the memory system's throughput.  Prints the card's name and power limit
first.  ``--save`` keeps x, cp and dp at the reference's shape (8, 512),
the card's (65536, 512) and two shapes off the kernel's tiles ((33, 7),
(1000, 513)), so that two checkouts are compared bit for bit, timed in
turns in one call on one card (unpack the other under build/ with
``git archive`` first):

    for s in build/parent/src src src build/parent/src; do \\
        t=${s%%/*}; python3 scripts/torch_pbt_scaling.py --src $s \\
        --tag $t --save build/pbt_$t.pt; done
    python3 scripts/torch_pbt_scaling.py --compare build/pbt_build.pt \\
        build/pbt_src.pt

``--compare`` prints, for every output the two files share, whether it
is equal bit for bit and, where not, the largest difference, and exits
1 if any differs.  Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

N = 512
SYSTEMS = (8, 1024, 4096, 8192, 16384, 32768, 65536)
#: shapes whose outputs --save keeps: the reference's and the card's,
#: and two that are not whole tiles or teams (rows not 16-byte aligned)
KEPT = ((8, 512), (65536, 512), (33, 7), (1000, 513))


def inputs(nb: int, n: int):
    """The reference's distributions (spec_accel_ref.inputs), seed 0."""
    rng = np.random.default_rng(0)
    lo, up, di = (rng.random((nb, n), dtype=np.float32) for _ in "lud")
    return (0.4 * lo, 2.0 + di, 0.4 * up,
            rng.standard_normal((nb, n), dtype=np.float32))


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    res = {}
    for k in sorted(set(x) & set(y)):
        same = torch.equal(x[k], y[k])
        res[k] = True if same else float((x[k] - y[k]).abs().max())
    print(json.dumps({"bit_identical": res}))
    return 0 if all(v is True for v in res.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", help="keep x, cp and dp in this file")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --save files and exit")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.bench import spec_accel as sa
    from repro_torch.bench.timing import time_in_turns

    if not torch.cuda.is_available():
        print("torch_pbt_scaling: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    torch.cuda._sleep(2_000_000_000)  # about a second: the clocks up
    print("tag,nb,n,ms,bound_ms,ns_per_step")
    rows = []
    for nb in SYSTEMS:
        dev_args = [torch.from_numpy(a).cuda() for a in inputs(nb, N)]
        ms = time_in_turns([lambda: sa.pbt(*dev_args)], flush)[0]
        bound = sa.cost("570.pbt", dev_args)["bound_ms"]
        rows.append({"nb": nb, "n": N, "ms": ms, "bound_ms": bound})
        print(f"{args.tag},{nb},{N},{ms:.4f},{bound:.4f},"
              f"{ms * 1e6 / (2 * N - 1):.1f}", flush=True)
        del dev_args
    if args.save:
        kept = {}
        for nb, n in KEPT:
            dev_args = [torch.from_numpy(a).cuda() for a in inputs(nb, n)]
            for name, t in zip(("x", "cp", "dp"), sa.pbt_sweeps(*dev_args)):
                kept[f"{name} ({nb}, {n})"] = t.cpu()
            del dev_args
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(kept, args.save)
    print(json.dumps({"pbt_scaling": {"tag": args.tag, "rows": rows}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
