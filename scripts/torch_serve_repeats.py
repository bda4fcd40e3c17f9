#!/usr/bin/env python3
"""Whether a served run repeats, on the card, and each run's replay gap:

    python3 scripts/torch_serve_repeats.py --arch deepseek-v2-lite-16b \\
        --mode spec --repeats 3 [--replays 1] [--splits N] \\
        [--null-page-order last|first] [--root CHECKOUT]

Serves ``chip_smoke.py``'s 12 requests (its cache length, prompt
lengths, slots and pages) at full width and depth ``--repeats`` times in
one process, through the checkout at ``--root`` (default: this one; an
older checkout's ``chip_smoke.py`` and ``src/`` are used as they are).
``--mode`` is ``paged``, ``dense`` or ``spec`` (paged, n-gram drafts
of ``chip_smoke.SPEC_K``).  For every run it prints one JSON line: the
decode and speculative steps, the MoE assignments dropped by capacity,
a digest of the emitted tokens and whether they equal the first run's;
the first ``--replays`` runs also get ``chip_smoke.replay_gap``'s
largest teacher-forced gap against the plain replay of their own calls
(on the served expert choices).  ``--splits`` fixes the paged kernels'
split count (default: ``paged_splits``'s rule).  ``--null-page-order``
says which of the rows that dead slots write to one null-page row is
kept (``kernel_sharding.last_writes``: ``first`` keeps the first in
index order instead of the last), to show what that choice does to the
live slots' tokens.  Prints the card's name and power limit first.
Needs a CUDA card and the CUDA toolkit.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    ap.add_argument("--arch", default="deepseek-v2-lite-16b")
    ap.add_argument("--mode", choices=("paged", "dense", "spec"),
                    default="spec")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--replays", type=int, default=1)
    ap.add_argument("--splits", type=int, default=None)
    ap.add_argument("--null-page-order", choices=("last", "first"),
                    default=None)
    args = ap.parse_args()
    root = args.root.resolve()
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import build
    from repro_torch.kernels.decode_attention import ops as _d  # noqa: F401
    from repro_torch.kernels.decode_attention import paged
    from repro_torch.kernels.flash_attention import ops as _f  # noqa: F401
    from repro_torch.kernels.gmm import ops as _g  # noqa: F401
    from repro_torch.kernels.rmsnorm import ops as _r  # noqa: F401
    from repro_torch.models.registry import build_model
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"builds {build.build_all():.1f} s", flush=True)
    if args.splits is not None:
        paged.paged_splits = lambda reach, page_size: args.splits
    if args.null_page_order == "first":
        from repro_torch.sharding import kernel_sharding as ks

        def first_writes(keys):
            idx = torch.arange(keys.shape[0], device=keys.device)
            same = keys[:, None] == keys[None, :]
            return torch.where(same, idx[None, :], keys.shape[0]).amin(1)
        ks.last_writes = first_writes
    s = cs.Smoke(torch)
    model = build_model(get_config(args.arch))
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    mode = {"paged": dict(paged=True), "dense": dict(paged=False),
            "spec": dict(paged=True, spec_mode="ngram",
                         spec_k=cs.SPEC_K)}[args.mode]
    first = None
    for run in range(args.repeats):
        t0 = time.perf_counter()
        reqs, st = cs.serve(s, model, params, record=True, **mode)
        calls, routes = st.pop("calls")
        tokens = [r.out for r in reqs]
        first = tokens if first is None else first
        line = {"root": str(args.root), "arch": args.arch,
                "mode": args.mode, "splits": args.splits,
                "null_page_order": args.null_page_order, "run": run,
                "decode_steps": st["decode_steps"],
                "spec_steps": st.get("spec_steps"),
                "moe_dropped": st.get("moe_dropped"),
                "tokens_sha1": hashlib.sha1(
                    json.dumps(tokens).encode()).hexdigest()[:12],
                "same_tokens_as_run_0": tokens == first,
                "tokens_agreeing_with_run_0": sum(
                    a == b for p, q in zip(tokens, first)
                    for a, b in zip(p, q)),
                "serve_s": time.perf_counter() - t0}
        if run < args.replays:
            gap, _, _, n, flipped = cs.replay_gap(
                s, model, params, calls,
                routes if model.cfg.moe is not None else None, **mode)
            line.update(replay_gap=gap, replay_not_argmax=flipped,
                        emitted=n)
        print(json.dumps(line), flush=True)
    print(json.dumps({"failures": s.failures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
