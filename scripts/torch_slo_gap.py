#!/usr/bin/env python3
"""Where the SLO phase's teacher-forced gap comes from, on the card:

    PYTHONPATH=src python3 scripts/torch_slo_gap.py

Serves ``chip_smoke.py``'s SLO run (a1) (granite-8b at full width,
paged, the 40-request trace of ``chip_smoke.slo_trace``, priority over
1 + 48 pages, greedy) twice: cuBLAS's reduced-precision bf16 reductions
on (PyTorch's default) and off
(``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``).
For each stream it prints the largest gap (argmax logit minus the
emitted token's logit, over every emitted token) against the bf16 plain
forward under each setting, and against an f32 forward of the same
weights upcast (the exact function the bf16 paths approximate), with
the tokens that are not the reference's argmax, the p99 and p99.9 of the
f32 gaps, and the f32 gap at the bf16 forward's worst token.  Prints the
card's name and power limit first.  Needs a CUDA card and the CUDA
toolkit; about 2 minutes with the builds.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as _d  # noqa: E402,F401
from repro_torch.kernels.flash_attention import ops as _f  # noqa: E402,F401
from repro_torch.kernels.rmsnorm import ops as _r  # noqa: E402,F401
from repro_torch.models.registry import build_model  # noqa: E402


def gaps(s, model, params, reqs):
    """rid -> the gaps of its emitted tokens against ``model``'s plain
    forward."""
    out = {}
    with torch.no_grad():
        for r in reqs:
            seq = torch.tensor([r.tokens + r.out[:-1]], device=s.dev)
            rows = model.forward_logits(params, seq, plain=True,
                                        start=len(r.tokens) - 1)[0].float()
            got = rows[torch.arange(len(r.out), device=s.dev),
                       torch.tensor(r.out, device=s.dev)]
            out[r.rid] = (rows.max(-1).values - got).cpu()
    return out


def summary(g):
    """(largest gap, request, token), tokens not the argmax."""
    worst = max((float(v.max()), rid, int(v.argmax()))
                for rid, v in g.items())
    return worst, sum(int((v > 0).sum()) for v in g.values())


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    flag = torch.backends.cuda.matmul
    print(f"builds {build.build_all():.1f} s", flush=True)
    s = cs.Smoke(torch)
    for k in ("rmsnorm", "flash_attention", "paged_decode_attention"):
        s.kernels[k] = {"launches_by_path": {}}
    model = build_model(get_config("granite-8b"))
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    trace = cs.slo_trace()
    streams = {}
    for reduced in (True, False):
        flag.allow_bf16_reduced_precision_reduction = reduced
        streams[reduced] = cs.replay_slo(
            s, model, params, trace, f"a1, reduced={reduced}",
            preempt_policy="priority", total_pages=cs.SLO_PAGES)[0]
    same = sum(a == b for p, q in zip(streams[True], streams[False])
               for a, b in zip(p.out, q.out))
    print(f"the two streams agree on {same} of "
          f"{sum(len(r.out) for r in streams[True])} tokens")
    worst_bf16 = None
    for served, reqs in streams.items():
        for ref in (True, False):
            flag.allow_bf16_reduced_precision_reduction = ref
            worst, flips = summary(gaps(s, model, params, reqs))
            worst_bf16 = worst_bf16 or worst
            print(f"served reduced={served} against the bf16 plain forward "
                  f"reduced={ref}: largest gap {worst[0]:.4f} at request "
                  f"{worst[1]}, token {worst[2]}; {flips} not its argmax")
    flag.allow_bf16_reduced_precision_reduction = True
    model32, params32 = cs._f32_model(model, params)
    for served, reqs in streams.items():
        g = gaps(s, model32, params32, reqs)
        worst, flips = summary(g)
        q = sorted(float(x) for v in g.values() for x in v)
        _, rid, tok = worst_bf16
        print(f"served reduced={served} against the f32 forward: largest "
              f"gap {worst[0]:.4f} at request {worst[1]}, token {worst[2]}; "
              f"{flips} not its argmax; p99 {q[int(0.99 * len(q))]:.4f}, "
              f"p99.9 {q[int(0.999 * len(q))]:.4f}; at the bf16 forward's "
              f"worst token (request {rid}, token {tok}) "
              f"{float(g[rid][tok]):.4f}")
    if s.failures:
        print("failed:\n  " + "\n  ".join(s.failures))
    return 1 if s.failures else 0


if __name__ == "__main__":
    sys.exit(main())
