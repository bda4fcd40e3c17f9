#!/usr/bin/env python3
"""The served paths' teacher-forced gaps, and B2's times, with B2's bf16
tensor-core body built with one, two (the shipped kernel) and three
bf16 terms of P, on one CUDA card.

B2 (``csrc/flash_attention.cu``) carries P into P V as
``constexpr int P_TERMS`` bf16 terms.  This script builds the source
again with that line rewritten (``chip_smoke.flash_p_terms_kernel``,
under ``build/variants/``) and, with each build in place of the shipped
kernel:

1. times it in turns (L2 flushed before each launch, median of 20) at
   the serving paths' prefill shapes, with
   ``scaled_dot_product_attention`` beside it where that computes the
   same function;
2. serves ``chip_smoke.py``'s 12 requests (granite-8b paged and dense,
   gemma2-2b paged and dense, deepseek-v2-lite-16b and
   jamba-1.5-large-398b cut to 4 layers paged, random weights from seed
   0) and prints the teacher-forced gap that ``chip_smoke.py`` holds to
   its TEACHER_GAP, and how many emitted tokens were not the plain
   argmax.

  PYTHONPATH=src python3 scripts/torch_flash_variants.py [--no-gaps]
"""
from __future__ import annotations

import argparse
import collections
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.bench.timing import time_in_turns  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.build import build_all  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention as fa  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ref as fa_ref  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402


def variant_kernels() -> dict:
    """name -> CudaKernel: P1, P2 (the shipped kernel) and P3."""
    return {f"P{t}": fa.KERNEL if t == fa_ref.P_TERMS
            else cs.flash_p_terms_kernel(t) for t in (1, 2, 3)}


def _with(kernel, fn):
    """``fn`` run with ``fa.KERNEL`` swapped for ``kernel``."""
    def call():
        shipped, fa.KERNEL = fa.KERNEL, kernel
        try:
            return fn()
        finally:
            fa.KERNEL = shipped
    return call


def time_variants(flash, dev) -> dict:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    shapes = {  # label: (B, Hq, Hkv, S, Dk, Dv, masks, SDPA computes it)
        "granite": (4, 32, 8, 512, 128, 128, {}, True),
        "jamba": (2, 64, 8, 511, 128, 128, {}, True),
        "deepseek": (3, 16, 16, 511, 192, 128, dict(scale=192 ** -0.5), True),
        "gemma2": (3, 8, 4, 6000, 256, 256,
                   dict(window=4096, softcap=50.0), False),
        "gemma2 without softcap": (3, 8, 4, 6000, 256, 256,
                                   dict(window=4096), False),
        "granite heads, S 4096": (1, 32, 8, 4096, 128, 128, {}, True)}
    for label, (b, hq, hkv, s, dk, dv, kw, lib) in shapes.items():
        q = torch.randn(b, hq, s, dk, device=dev, generator=g).bfloat16()
        k = torch.randn(b, hkv, s, dk, device=dev, generator=g).bfloat16()
        v = torch.randn(b, hkv, s, dv, device=dev, generator=g).bfloat16()
        fns = {n: _with(kern, lambda: fa_ops.flash_attention(q, k, v, **kw))
               for n, kern in flash.items()}
        if lib:
            fns["sdpa"] = lambda: sdpa(q, k, v, is_causal=True,
                                       enable_gqa=True, scale=kw.get("scale"))
        ms = time_in_turns(list(fns.values()), flush)
        out[label] = dict(zip(fns, ms))
        print(f"B2 {label} ({b}, {hq}/{hkv}, {s}, {dk}/{dv}) ms: " + ", ".join(
            f"{n} {t:.4f}" for n, t in out[label].items()), flush=True)
        del q, k, v
    return out


def gaps(flash, dev) -> list:
    """Each model once, each build's served run and its gap."""
    s = cs.Smoke(torch)
    # check_serving's bookkeeping, without checks or records
    s.check = lambda ok, what: None
    s.kernels = collections.defaultdict(
        lambda: collections.defaultdict(dict, launches_by_path={}))
    rows = []
    both = [("paged", dict(paged=True)), ("dense", dict(paged=False))]
    for label, cfg, modes, kw in (
            ("granite-8b", get_config("granite-8b"), both, {}),
            ("gemma2-2b", get_config("gemma2-2b"), both,
             dict(cache_len=cs.G2_CACHE_LEN, prompt_lens=cs.G2_PROMPT_LENS)),
            ("deepseek-v2-lite-16b", get_config("deepseek-v2-lite-16b"),
             both[:1], dict(prefill=("rmsnorm",), replay=True)),
            ("jamba-1.5-large-398b", cs._jamba_config(), both[:1],
             dict(prefill=("rmsnorm",), replay=True))):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        for fname, kern in flash.items():
            shipped, fa.KERNEL = fa.KERNEL, kern
            try:
                for mode, mkw in modes:
                    _, st = cs.check_serving(s, model, params,
                                             f"{label} {mode}", mkw, {}, (),
                                             **kw)
                    row = dict(model=label, mode=mode, flash=fname,
                               gap=st["teacher_gap"],
                               tokens=st["teacher_tokens"],
                               flipped=st["teacher_flipped"])
                    rows.append(row)
                    flag = "ok" if row["gap"] <= cs.TEACHER_GAP else "past"
                    print(f"gap {label} {mode}, B2 {fname}: "
                          f"{row['gap']:.4f} ({flag} {cs.TEACHER_GAP}); "
                          f"{row['flipped']} of {row['tokens']} tokens not "
                          f"the plain argmax", flush=True)
            finally:
                fa.KERNEL = shipped
        del params, model
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-gaps", action="store_true",
                    help="time the builds only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_flash_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    t0 = time.perf_counter()
    flash = variant_kernels()
    build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"device": torch.cuda.get_device_name(0), "power": smi,
           "times_ms": time_variants(flash, dev)}
    if not args.no_gaps:
        res["gaps"] = gaps(flash, dev)
    print(json.dumps({"flash_variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
