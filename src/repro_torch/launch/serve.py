"""Serving launcher of the port: continuous-batching engine over a paged
or a dense KV cache, with random weights and prompts from seed 0.

On the card (the default device), full width:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --paged --prompts 12 --prompt-len 200 --slots 8 --cache-len 1024

gemma2-2b (sliding-window local layers page through ring tables):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-2b \
      --paged --prompts 12 --prompt-len 6000 --slots 8 --cache-len 8192

gemma3-4b and gemma3-27b (five local layers of a 1,024-token window to
each global one, qk-norm, a RoPE base of their own on local layers),
paged or dense, from bf16, int8 or fp8 pools; gemma3-4b at full depth,
gemma3-27b's 62 layers cut to 8 (one period and two local layers, so
that it ends mid-cycle as the full stack does), as ``chip_smoke.py``
serves them:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --paged --prompts 12 --prompt-len 2100 --slots 8 --cache-len 4608
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \
      --layers 8 --paged --kv-dtype int8 --prompts 12 --prompt-len 2100 \
      --slots 8 --cache-len 4608
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-4b \
      --smoke --paged --page-size 4 --prompt-len 20 --device cpu

deepseek-v2-lite-16b (MLA attention, 64 routed experts top-6 on 26 of
its 27 layers), paged or dense, from bf16, int8 or fp8 pools, and
speculating over them:

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --paged --prompts 12 --prompt-len 511 \
      --slots 8 --cache-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-lite-16b --paged --kv-dtype int8 \
      --spec-mode ngram --spec-k 4 --prompts 12 --prompt-len 511

arctic-480b (GQA, 56 query heads over 8 KV heads, 128 experts top-2 and
a dense residual MLP on every layer), paged or dense; its 35 layers are
954 GB in bf16, so one card serves its first 2 (55.4 GB), as
``chip_smoke.py`` does:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
      --layers 2 --paged --prompts 12 --prompt-len 511 --slots 8 \
      --cache-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch arctic-480b \
      --smoke --paged --page-size 4 --device cpu

jamba-1.5-large-398b (global attention and mamba layers, 16 experts
top-2 on every other layer; the selective-scan kernel on every mamba
prefill), paged or dense, from bf16, int8 or fp8 pools (the attention
layers' pools quantize, the mamba state stays dense); the full 72
layers do not fit one card (``chip_smoke.py`` serves a 4-layer cut of
it):

  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --layers 4 --paged --kv-dtype int8 \
      --prompts 12 --prompt-len 511 --slots 8 --cache-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch jamba-1.5-large-398b --smoke --paged --page-size 4 \
      --device cpu

xlstm-1.3b (48 recurrent layers, seven mLSTM then one sLSTM per
period, no attention layer: the mLSTM scan kernel on every mLSTM
prefill, the one-token recurrences in plain PyTorch), paged or dense,
at full width and depth on the card or at smoke size on the CPU:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --paged --prompts 12 --prompt-len 511 --slots 8 --cache-len 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b \
      --smoke --paged --page-size 4 --device cpu

From an int8 pool, speculating 4 tokens per step:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --paged --kv-dtype int8 --spec-mode ngram --spec-k 4

On the CPU, through the plain PyTorch versions of the kernels:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --prompts 6 --max-new 12 --paged --device cpu

Under injected faults (``serve/faults.py``: corrupted KV pages, NaN
logits, failed allocations, stalled steps, drawn at this per-step rate
from a seed), recovered by the engine's ladder:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --paged --page-size 4 --device cpu --fault-rate 0.1 \
      --watchdog-s 1.0

Replaying a frozen workload trace (``python -m
repro_torch.serve.workload --out PATH`` freezes one) on the engine's
step clock, each request submitted at its ``arrival_step`` with its own
priority class and decode budget (capped by ``--max-new``), under the
priority policy, with the lifecycle trace written for Perfetto
(ui.perfetto.dev -> "Open trace file") and the metric registries as
JSON:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-8b \
      --smoke --paged --page-size 8 --total-pages 16 --device cpu \
      --preempt-policy priority --max-new 16 \
      --trace-file benchmarks/traces/bursty_smoke.jsonl \
      --trace-out build/trace.json --metrics-out build/metrics.json

Prints one JSON summary: completion and request statuses, token counts,
wall time, the recovery counters and quarantined pages, the speculative
counters, the pages freed behind sliding windows, the MoE assignments
that capacity dropped, the launch count of every kernel in the run,
and from the always-on telemetry the run's latency percentiles (TTFT,
queue wait, inter-token, preemption stall, recovery, end to end), per
class where requests carry classes (``latency_by_class``), and per
request.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time


def main(argv=None):
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.core.build import KERNELS
    from repro_torch.core.device import resolve_device
    from repro_torch.models import moe
    from repro_torch.models.registry import build_model
    from repro_torch.quant import KV_DTYPES
    from repro_torch.serve.engine import (PREEMPT_POLICIES, SPEC_MODES,
                                         Engine, Request, ServeConfig)
    from repro_torch.serve.faults import FaultPlan
    from repro_torch.serve.telemetry import LATENCY_METRICS, ServeTelemetry
    from repro_torch.serve.workload import load_trace, replay

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (tiny widths)")
    ap.add_argument("--layers", type=int, default=None,
                    help="serve only the config's first N layers (full "
                         "width, cut depth: a model that does not fit "
                         "one card)")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=64)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0: greedy; above it, sampled (Gumbel-max from "
                         "a generator seeded 0)")
    ap.add_argument("--paged", action="store_true",
                    help="paged KV cache + paged decode kernel")
    ap.add_argument("--page-size", type=int, default=None,
                    help="KV page size (default: the tuning table's)")
    ap.add_argument("--total-pages", type=int, default=None,
                    help="force the KV page pool size (default: 1 + slots "
                         "* pages_per_slot, which never oversubscribes)")
    ap.add_argument("--preempt-policy", default="lru",
                    choices=list(PREEMPT_POLICIES),
                    help="what a dry page pool does: preempt the least-"
                         "recently-admitted slot, the one with the fewest "
                         "generated tokens, or fail")
    ap.add_argument("--kv-dtype", default=None, choices=list(KV_DTYPES),
                    help="paged KV pool dtype (default: the model's); "
                         "fp8 falls back to int8 on a card without it")
    ap.add_argument("--spec-mode", default="off", choices=list(SPEC_MODES),
                    help="self-speculative decoding (paged, greedy): "
                         "ngram drafts from each request's own history")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="drafted tokens per speculative step")
    ap.add_argument("--fault-rate", type=float, default=0.0,
                    help="inject faults (KV-page corruption, NaN logits, "
                         "allocation failure, stalled step) at this "
                         "per-step probability (requires --paged); the "
                         "engine detects and recovers them")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the deterministic fault plan")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="per-request fault-retry budget; past it the "
                         "request finishes with status 'failed'")
    ap.add_argument("--watchdog-s", type=float, default=None,
                    help="per-step wall-clock deadline; a step past it is "
                         "discarded and its slots requeued (armed after "
                         "the first step)")
    ap.add_argument("--trace-file", default=None, metavar="PATH",
                    help="replay a frozen workload trace (JSONL from "
                         "repro_torch.serve.workload) instead of synthetic "
                         "prompts: each request is submitted when the "
                         "engine's step counter reaches its arrival_step, "
                         "with its own priority class and decode budget "
                         "(capped by --max-new)")
    ap.add_argument("--priority-class", type=int, default=0,
                    help="priority class of every synthetic request "
                         "(higher = more latency-sensitive; pairs with "
                         "--preempt-policy priority; a trace carries its "
                         "own classes)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the lifecycle trace as Chrome trace-event "
                         "JSON (open in Perfetto: ui.perfetto.dev)")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the engine's and the telemetry's metric "
                         "registries (counters, gauges, histograms) as "
                         "JSON")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no card and no --device "
                         "cpu is an error")
    args = ap.parse_args(argv)
    for flag, used in (("--total-pages", args.total_pages is not None),
                       ("--kv-dtype", args.kv_dtype is not None),
                       ("--spec-mode", args.spec_mode != "off"),
                       ("--fault-rate", bool(args.fault_rate))):
        if used and not args.paged:
            ap.error(f"{flag} requires --paged")
    if args.trace_file and args.priority_class:
        ap.error("--priority-class only applies to synthetic prompts; "
                 "a trace carries per-request classes")

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.layers is not None:
        if not 1 <= args.layers <= cfg.num_layers:
            ap.error(f"--layers must be in [1, {cfg.num_layers}]")
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen, device=dev)
    sc = ServeConfig(slots=args.slots, cache_len=args.cache_len,
                     max_new_tokens=args.max_new,
                     temperature=args.temperature, paged=args.paged,
                     page_size=args.page_size, total_pages=args.total_pages,
                     preempt_policy=args.preempt_policy,
                     kv_dtype=args.kv_dtype, spec_mode=args.spec_mode,
                     spec_k=args.spec_k, max_retries=args.max_retries,
                     watchdog_s=args.watchdog_s)
    plan = (FaultPlan(rate=args.fault_rate, seed=args.fault_seed)
            if args.fault_rate > 0 else None)
    # always on: the latency fields of the summary come from it
    telemetry = ServeTelemetry()
    engine = Engine(model, params, sc, device=dev, fault_plan=plan,
                    telemetry=telemetry)
    trace = load_trace(args.trace_file) if args.trace_file else None
    if trace is None:
        rng = np.random.default_rng(0)
        reqs = [Request(rid=i, tokens=rng.integers(
            0, cfg.vocab_size, size=args.prompt_len).tolist(),
            priority_class=args.priority_class)
            for i in range(args.prompts)]

    for k in KERNELS:
        k.launches = 0
    drops = moe.count_drops(dev) if cfg.moe is not None else None
    try:
        t0 = time.perf_counter()
        if trace is None:
            engine.run_to_completion(reqs)
        else:
            # each request arrives at its step of the engine's own clock
            reqs = replay(engine, trace)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    finally:
        moe.stop_counting_drops()
    new_tokens = sum(len(r.out) for r in reqs)
    st = engine.stats()

    def percentiles(block):
        return {m: ({"p50": v["p50"], "p99": v["p99"], "count": v["count"]}
                    if v else None)
                for m, v in block.items() if m in LATENCY_METRICS}

    latency_by_class = {
        label: {**{k: blk[k] for k in ("priority_class", "requests",
                                       "completed", "completion_rate",
                                       "preempts")},
                **percentiles(blk)}
        for label, blk in telemetry.summary_by_class().items()}
    classes_present = (len(latency_by_class) > 1
                       or any(label != "0" for label in latency_by_class))
    if args.trace_out:
        telemetry.trace.export(args.trace_out)
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"engine": engine.metrics.snapshot(),
                       "telemetry": telemetry.registry.snapshot()},
                      f, indent=1, sort_keys=True)
            f.write("\n")
    print(json.dumps({
        "arch": args.arch, "smoke": args.smoke, "device": str(dev),
        "paged": args.paged, "requests": len(reqs),
        "all_done": all(r.done for r in reqs),
        "statuses": {s: sum(r.status == s for r in reqs)
                     for s in ("done", "failed", "pending")},
        "new_tokens": new_tokens, "wall_s": dt,
        "tok_per_s": new_tokens / dt, "steps": st["steps"],
        "preemptions": st["preemptions"],
        "recoveries": st["recoveries"],
        "failed_requests": st["failed_requests"],
        "watchdog_trips": st["watchdog_trips"],
        "last_watchdog_trip": st["last_watchdog_trip"],
        "last_recovery": st["last_recovery"],
        **({"quarantined_pages": st["quarantined"],
            "pool_groups": st["pool_groups"]} if args.paged else {}),
        **({"faults_injected": st["faults_injected"]}
           if plan is not None else {}),
        "kv_dtype": st.get("kv_dtype"), "spec_mode": args.spec_mode,
        "spec_rejections": st.get("spec_rejections"),
        "accepted_tokens_per_step": (st["spec_emitted"] / st["spec_steps"]
                                     if st.get("spec_steps") else None),
        "window_prefix_frees": st.get("window_prefix_frees"),
        "moe_dropped": None if drops is None else int(drops),
        "kernel_launches": {k.name: k.launches for k in KERNELS},
        "latency": percentiles(telemetry.summary()),
        **({"latency_by_class": latency_by_class}
           if classes_present else {}),
        "per_request": [
            {k: row[k] for k in ("rid", "status", "priority_class",
                                 "traffic_class", "tokens", "ttft_s",
                                 "itl_p50_s", "queue_wait_s",
                                 "preempt_stall_s", "recovery_s")}
            for row in telemetry.request_metrics()],
        "sample_output": reqs[0].out,
    }, indent=1))
    return reqs


if __name__ == "__main__":
    main()
