#!/usr/bin/env python3
"""B3's split count against its times and the served paths' teacher-
forced gaps, on one CUDA card.

B3 (``csrc/decode_attention.cu``) walks each slot's cache in
``splits`` chunks and merges their partials in chunk order; the served
count comes from ``decode_attention.decode_splits`` (chunks of
SPLIT_ROWS cache rows).  This script passes the kernel other counts
instead: one split (the unsplit kernel's arithmetic), chunks of a fixed
number of cache rows, and a count that fills the card (B x Hkv x
splits >= 4 CTAs a SM, were every cache full: the rule first proposed,
whose gemma2-2b gap failed), and with each in place:

1. holds B3 to its split plain version (``decode_attention_ref(
   chunk=...)``) and times it in turns (L2 flushed before each launch,
   median of 20, after a second of spinning that brings the clocks up)
   at the four dense serving shapes (granite-8b, jamba-1.5-large-398b,
   deepseek-v2-lite-16b: 8 slots, lengths 1..1024; gemma2-2b: 8 slots,
   lengths 1..8192, softcap 50), with masked
   ``scaled_dot_product_attention`` beside it where that computes the
   same function;
2. serves ``chip_smoke.py``'s 12 requests densely (granite-8b, gemma2-
   2b, deepseek-v2-lite-16b and jamba-1.5-large-398b cut to 4 layers,
   random weights from seed 0; the MoE models held to a plain replay of
   their own calls) and prints the teacher-forced gap that
   ``chip_smoke.py`` holds to its TEACHER_GAP, and how many emitted
   tokens were not the plain argmax.

  PYTHONPATH=src python3 scripts/torch_decode_variants.py [--no-gaps]
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
from repro_torch.kernels.decode_attention import decode_attention as dk  # noqa: E402
from repro_torch.kernels.decode_attention import ops  # noqa: E402
from repro_torch.kernels.decode_attention import ref  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

SHIPPED = dk.decode_attention_fwd
#: the chunks (cache rows a split) served for their gaps, in the order a
#: fallback takes them should a rule fail a path; timed besides them:
GAP_CHUNKS = (256, 512, 1024)
TIMED_CHUNKS = (64, 128) + GAP_CHUNKS
CTAS_PER_SM = 4


def fixed_chunk(rows: int):
    """Chunks of ``rows`` cache rows (one split where the cache is no
    longer)."""
    def splits(b, hkv, s):
        return max(1, min(-(-s // rows), dk.MAX_SPLITS))
    return splits


def fill_the_card(b, hkv, s):
    """Enough splits that B x Hkv x splits CTAs give CTAS_PER_SM a SM
    were every cache full, at most one a 64-token block and MAX_SPLITS,
    evened out to whole blocks a split."""
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = -(-s // dk.MAX_BLOCK_KV)
    want = -(-CTAS_PER_SM * n_sm // (b * hkv))
    return -(-s // dk.split_chunk(s, max(1, min(want, blocks,
                                                 dk.MAX_SPLITS))))


def variants(chunks, shipped: bool) -> dict:
    """name -> split count of (B, Hkv, S): one split, each of
    ``chunks``, filling the card and, with ``shipped``, the served
    rule."""
    out = {"one split": lambda b, hkv, s: 1}
    out.update({f"chunk {c}": fixed_chunk(c) for c in chunks})
    out["fill the card"] = fill_the_card
    if shipped:
        out["shipped"] = lambda b, hkv, s: dk.decode_splits(s)
    return out


def _launcher(count):
    """B3's launcher with the split count of ``count``."""
    def fwd(q, k_cache, v_cache, lengths, *, splits=None, **kw):
        return SHIPPED(q, k_cache, v_cache, lengths, splits=count(
            q.shape[0], k_cache.shape[1], k_cache.shape[2]), **kw)
    return fwd


def _with(count, fn):
    """``fn`` run with B3's launcher taking its split count from
    ``count``."""
    def call():
        dk.decode_attention_fwd = _launcher(count)
        try:
            return fn()
        finally:
            dk.decode_attention_fwd = SHIPPED
    return call


def time_variants(dev) -> dict:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    torch.cuda._sleep(2_000_000_000)  # about a second: the clocks up
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    shapes = {  # label: (Hq, Hkv, Dk, Dv, S, lengths, kw)
        "granite": (32, 8, 128, 128, cs.CACHE_LEN, cs.DECODE_LENGTHS, {}),
        "jamba": (64, 8, 128, 128, cs.CACHE_LEN, cs.DECODE_LENGTHS, {}),
        "deepseek": (16, 16, 192, 128, cs.CACHE_LEN, cs.DECODE_LENGTHS,
                     dict(scale=192 ** -0.5)),
        "gemma2": (8, 4, 256, 256, cs.G2_CACHE_LEN, cs.G2_LENGTHS,
                   dict(softcap=cs.G2_SOFTCAP))}
    for label, (hq, hkv, dk_, dv, s, lengths, kw) in shapes.items():
        b = len(lengths)
        q = torch.randn(b, hq, dk_, device=dev, generator=g).bfloat16()
        kc = torch.randn(b, hkv, s, dk_, device=dev, generator=g).bfloat16()
        vc = torch.randn(b, hkv, s, dv, device=dev, generator=g).bfloat16()
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        fns, errs = {}, {}
        for name, count in variants(TIMED_CHUNKS, shipped=True).items():
            n = count(b, hkv, s)
            got = ops.decode_attention(q, kc, vc, ln, return_residuals=True,
                                       splits=n, **kw)
            want = ref.decode_attention_ref(
                q, kc, vc, ln, return_residuals=True,
                chunk=dk.split_chunk(s, n), **kw)
            errs[name] = (n, max(float((a - w).abs().max())
                                 for a, w in zip(got, want)))
            fns[f"{name} ({n})"] = (lambda n=n: ops.decode_attention(
                q, kc, vc, ln, return_residuals=True, splits=n, **kw))
        if "softcap" not in kw:
            mask = (torch.arange(s, device=dev)[None, :]
                    < ln[:, None])[:, None, None, :]
            fns["sdpa"] = lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask,
                                       enable_gqa=True, scale=kw.get("scale"))
        ms = time_in_turns(list(fns.values()), flush)
        out[label] = {"ms": dict(zip(fns, ms)), "splits_and_err": errs}
        print(f"B3 {label} ({b}, {hq}/{hkv}, {s}, {dk_}/{dv}) ms: "
              + ", ".join(f"{n} {t:.4f}"
                          for n, t in out[label]["ms"].items()), flush=True)
        print(f"B3 {label} max |kernel - split plain version|: " + ", ".join(
            f"{n} ({k} splits) {e:.2e}" for n, (k, e) in errs.items()),
            flush=True)
        del q, kc, vc
    return out


def gaps(dev) -> list:
    """Each model once, served densely with each split rule in turn."""
    s = cs.Smoke(torch)
    # check_serving's bookkeeping, without checks or records
    s.check = lambda ok, what: None
    s.kernels = collections.defaultdict(
        lambda: collections.defaultdict(dict, launches_by_path={}))
    rows = []
    for label, cfg, kw in (
            ("granite-8b", get_config("granite-8b"), {}),
            ("gemma2-2b", get_config("gemma2-2b"),
             dict(cache_len=cs.G2_CACHE_LEN, prompt_lens=cs.G2_PROMPT_LENS)),
            ("deepseek-v2-lite-16b", get_config("deepseek-v2-lite-16b"),
             dict(prefill=("rmsnorm",), replay=True)),
            ("jamba-1.5-large-398b", cs._jamba_config(),
             dict(prefill=("rmsnorm",), replay=True))):
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        for name, count in variants(GAP_CHUNKS, shipped=False).items():
            _, st = _with(count, lambda: cs.check_serving(
                s, model, params, f"{label} dense", dict(paged=False), {},
                (), **kw))()
            row = dict(model=label, split=name, gap=st["teacher_gap"],
                       tokens=st["teacher_tokens"],
                       flipped=st["teacher_flipped"])
            rows.append(row)
            flag = "ok" if row["gap"] <= cs.TEACHER_GAP else "past"
            print(f"gap {label} dense, B3 {name}: {row['gap']:.4f} ({flag} "
                  f"{cs.TEACHER_GAP}); {row['flipped']} of {row['tokens']} "
                  f"tokens not the plain argmax", flush=True)
        del params, model
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--no-gaps", action="store_true",
                    help="check and time the split counts only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_decode_variants: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; {n_sm} SMs",
          flush=True)
    t0 = time.perf_counter()
    build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    res = {"device": torch.cuda.get_device_name(0), "power": smi,
           "times_ms": time_variants(dev)}
    if not args.no_gaps:
        res["gaps"] = gaps(dev)
    print(json.dumps({"decode_variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
