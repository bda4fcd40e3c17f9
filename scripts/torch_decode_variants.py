#!/usr/bin/env python3
"""The split count of B3 (dense decode), B4 (paged decode), B5 (paged
decode over int8 or fp8 pools), B6 (speculative paged decode) or B7 and
B7q (sliding-window decode over ring walks, bf16 and int8/fp8 pools)
against its times and the served paths' teacher-forced gaps, on one CUDA
card.

B3 (``csrc/decode_attention.cu``) walks each slot's cache in
``splits`` chunks and merges their partials in chunk order; the served
count comes from ``decode_attention.decode_splits`` (chunks of
SPLIT_ROWS cache rows).  B4 (``csrc/paged_decode_attention.cu``, with
``--paged``) does the same over each slot's block-table row, in chunks
of whole pages (``decode_attention.paged_splits``, from the table's
reach), and so do B5 (``--paged --kv int8|fp8_e4m3``), B6
(``--paged --spec``, over bf16 and int8 pools) and the window kernels
(``--window``: B7 and B7q over each ring walk, chunks counted from its
start, from the walk's width; B4 and B5 keep their shipped chunks of
PAGED_SPLIT_ROWS).  This script passes the
kernel other counts instead: one split (the unsplit kernel's
arithmetic), chunks of a fixed number of rows, and a count that fills
the card (B x Hkv x splits >= 4 CTAs a SM, were every cache full: the
rule first proposed for B3, whose gemma2-2b gap failed), and with each
in place:

1. holds the kernel to its split plain version (``decode_attention_ref(
   chunk=...)``, or ``paged_decode_attention_ref(chunk=...)`` over pools
   of pages of 64 with scrambled tables) and times it in turns (L2
   flushed and the card left to settle before each launch, median of
   20, after a second of spinning that brings the clocks up) at the four
   serving shapes (granite-8b, jamba-1.5-large-398b,
   deepseek-v2-lite-16b: 8 slots, lengths 1..1024; gemma2-2b: 8 slots,
   lengths 1..8192, softcap 50), with masked
   ``scaled_dot_product_attention`` over the dense cache beside it where
   that computes the same function (B5 at granite-8b's and gemma2-2b's
   shapes only, B6 at granite-8b's with K1 = 5: the paths that run
   them; B7 and B7q at gemma2-2b's ring tables of 65 pages);
2. serves ``chip_smoke.py``'s 12 requests densely (or paged, with
   ``--paged``: gemma2-2b's local layers keep B7) on granite-8b,
   gemma2-2b, deepseek-v2-lite-16b and jamba-1.5-large-398b cut to 4
   layers (random weights from seed 0; the MoE models held to a plain
   replay of their own calls) and prints the teacher-forced gap that
   ``chip_smoke.py`` holds to its TEACHER_GAP, and how many emitted
   tokens were not the plain argmax.  ``--kv``: granite-8b and gemma2-2b
   from pools of that type (gaps reported by ``chip_smoke.py``, not
   held); ``--spec``: granite-8b with n-gram speculation (k = 4) over
   bf16 pools (held) and int8 pools (reported); ``--window``: gemma2-2b
   paged over bf16 pools (held), int8 and fp8 pools (reported).

  PYTHONPATH=src python3 scripts/torch_decode_variants.py [--paged \
      [--kv int8|fp8_e4m3 | --spec] | --window] [--no-gaps]
"""
from __future__ import annotations

import argparse
import collections
import gc
import inspect
import itertools
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
from repro_torch.kernels.decode_attention import paged  # noqa: E402
from repro_torch.kernels.decode_attention import quant  # noqa: E402
from repro_torch.kernels.decode_attention import ref  # noqa: E402
from repro_torch.kernels.decode_attention import spec  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.quant import resolve_kv_spec  # noqa: E402

#: kernel -> (module, launcher) whose split count a variant replaces
LAUNCHERS = {"B3": (dk, "decode_attention_fwd"),
             "B4": (paged, "paged_decode_attention_fwd"),
             "B5": (quant, "quant_paged_decode_attention_fwd"),
             "B6": (spec, "spec_paged_decode_attention_fwd"),
             "B7": (paged, "window_paged_decode_attention_fwd")}
SHIPPED = {k: getattr(mod, name) for k, (mod, name) in LAUNCHERS.items()}
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


def variants(chunks, shipped: bool, kern: str) -> dict:
    """name -> split count of (B, Hkv, S) (S: a paged table's reach):
    one split, each of ``chunks``, filling the card and, with
    ``shipped``, the served rule of ``kern``."""
    out = {"one split": lambda b, hkv, s: 1}
    out.update({f"chunk {c}": fixed_chunk(c) for c in chunks})
    out["fill the card"] = fill_the_card
    if shipped:
        out["shipped"] = ((lambda b, hkv, s: dk.decode_splits(s))
                          if kern == "B3" else
                          (lambda b, hkv, s: dk.paged_splits(s, cs.PAGE)))
    return out


def _launcher(kern: str, count):
    """``kern``'s launcher with the split count of ``count`` (S: a dense
    cache's rows, or a table's reach at the pool's page)."""
    shipped = SHIPPED[kern]
    sig = inspect.signature(shipped)

    def fwd(*args, splits=None, **kw):
        a = sig.bind_partial(*args, **kw).arguments
        if kern == "B3":
            b, hkv, s = (a["q"].shape[0],) + tuple(a["k_cache"].shape[1:3])
        else:
            kp = a["k_pages"]
            b, hkv = a["q"].shape[0], kp.shape[0]
            s = a["block_tables"].shape[1] * kp.shape[2]
        return shipped(*args, splits=count(b, hkv, s), **kw)
    return fwd


def _with(count, fn, kern: str):
    """``fn`` run with ``kern``'s launcher taking its split count from
    ``count``."""
    mod, name = LAUNCHERS[kern]

    def call():
        setattr(mod, name, _launcher(kern, count))
        try:
            return fn()
        finally:
            setattr(mod, name, SHIPPED[kern])
    return call


def _paged_run(kern, kv, q, kc, vc, ln, kw, smoke):
    """``run(n, chunk, plain)`` of B4, B5 (pools of ``kv``) or B6 (its
    bf16 or int8 mode, q (B, K1, Hq, D), ``ln`` the prefixes) over
    chip_smoke's scrambled pages of 64."""
    horizons = ln.tolist() if kern != "B6" else [
        n + q.shape[1] for n in ln.tolist()]
    kp, vp, bt = cs._pages(smoke, kc, vc, horizons, cs.PAGE)
    if kern == "B4" or (kern == "B6" and kv == "bf16"):
        args = (q, kp, vp, bt, ln)
        fn, plain_fn = ((ops.paged_decode_attention,
                         ref.paged_decode_attention_ref) if kern == "B4" else
                        (ops.spec_paged_decode_attention,
                         ref.spec_paged_decode_attention_ref))
    else:
        sp = resolve_kv_spec(kv, q.device, strict=True)
        (kq, ks), (vq, vs) = sp.quantize_pages(kp), sp.quantize_pages(vp)
        args = (q, kq, vq, ks, vs, bt, ln)
        fn, plain_fn = ((ops.quant_paged_decode_attention,
                         ref.quant_paged_decode_attention_ref)
                        if kern == "B5" else
                        (ops.quant_spec_paged_decode_attention,
                         ref.quant_spec_paged_decode_attention_ref))

    def run(n, chunk=None, plain=False):
        if plain:
            return plain_fn(*args, return_residuals=True, chunk=chunk, **kw)
        return fn(*args, return_residuals=True, splits=n, **kw)
    return run


def _dense_or_paged_run(kern, label, kv, q, kc, vc, ln, kw, smoke):
    """(run, block) of B3 over the dense caches, or of B4, B5 or B6 over
    chip_smoke's scrambled pages of them (``block``: the chunks' unit)."""
    if kern != "B3":
        return _paged_run(kern, label.split()[-1] if kern == "B6" else kv,
                          q, kc, vc, ln, kw, smoke), cs.PAGE

    def run(n, chunk=None, plain=False):
        if plain:
            return ref.decode_attention_ref(
                q, kc, vc, ln, return_residuals=True, chunk=chunk, **kw)
        return ops.decode_attention(q, kc, vc, ln, return_residuals=True,
                                    splits=n, **kw)
    return run, dk.MAX_BLOCK_KV


def _window_run(smoke, kv, kw):
    """(run, B, Hkv, reach) of B7 (``kv`` "bf16") or B7q (int8, fp8)
    over chip_smoke's gemma2-2b ring pools: 8 slots, lengths 1..8192,
    ring tables of 65 pages of 64."""
    q, kp, vp, bt, ln = cs._ring_pools(smoke, cs.G2_LENGTHS)
    if kv == "bf16":
        args = (q, kp, vp, bt, ln)
        fn, plain_fn = (ops.window_paged_decode_attention,
                        ref.window_paged_decode_attention_ref)
    else:
        args = (q, *cs._quantize(smoke, kp, vp, kv), bt, ln)
        fn, plain_fn = (ops.quant_window_paged_decode_attention,
                        ref.quant_window_paged_decode_attention_ref)

    def run(n, chunk=None, plain=False):
        if plain:
            return plain_fn(*args, return_residuals=True, chunk=chunk, **kw)
        return fn(*args, return_residuals=True, splits=n, **kw)
    return run, q.shape[0], kp.shape[0], bt.shape[1] * kp.shape[2]


def time_variants(dev, kern: str, kv: str) -> dict:
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    smoke = cs.Smoke(torch)             # chip_smoke's page scatter
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
    if kern == "B5":    # the paths that run it
        shapes = {k: shapes[k] for k in ("granite", "gemma2")}
    if kern == "B6":    # granite-8b's spec path: K1 = 5 a slot
        shapes = {f"granite spec {m}": shapes["granite"][:5]
                  + (cs.SPEC_BASES, {}) for m in ("bf16", "int8")}
    if kern == "B7":    # gemma2-2b's local layers, each pool type
        shapes = {f"gemma2 {m}": shapes["gemma2"][:6]
                  + (dict(window=cs.G2_WINDOW, softcap=cs.G2_SOFTCAP),)
                  for m in ("bf16", "int8", "fp8_e4m3")}
    for label, (hq, hkv, dk_, dv, s, lengths, kw) in shapes.items():
        b = len(lengths)
        k1 = (cs.SPEC_K + 1,) if kern == "B6" else ()
        if kern == "B7":
            run, b, hkv, s = _window_run(smoke, label.split()[-1], kw)
            q = kc = vc = None
            block = cs.PAGE
        else:
            q = torch.randn(b, *k1, hq, dk_, device=dev,
                            generator=g).bfloat16()
            kc = torch.randn(b, hkv, s, dk_, device=dev,
                             generator=g).bfloat16()
            vc = torch.randn(b, hkv, s, dv, device=dev,
                             generator=g).bfloat16()
            ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
            run, block = _dense_or_paged_run(kern, label, kv, q, kc, vc, ln,
                                             kw, smoke)
        fns, errs = {}, {}
        for name, count in variants(TIMED_CHUNKS, shipped=True,
                                    kern=kern).items():
            n = count(b, hkv, s)
            got = run(n)
            want = run(None, chunk=dk.split_chunk(s, n, block), plain=True)
            errs[name] = (n, max(float((a - w).abs().max())
                                 for a, w in zip(got, want)))
            fns[f"{name} ({n})"] = lambda n=n: run(n)
        if "softcap" not in kw and kern in ("B3", "B4"):
            mask = (torch.arange(s, device=dev)[None, :]
                    < ln[:, None])[:, None, None, :]
            fns["sdpa"] = lambda: sdpa(q[:, :, None], kc, vc, attn_mask=mask,
                                       enable_gqa=True, scale=kw.get("scale"))
        ms = time_in_turns(list(fns.values()), flush)
        out[label] = {"ms": dict(zip(fns, ms)), "splits_and_err": errs}
        print(f"{kern} {label} ({b}, {hq}/{hkv}, {s}, {dk_}/{dv}) ms: "
              + ", ".join(f"{n} {t:.4f}"
                          for n, t in out[label]["ms"].items()), flush=True)
        print(f"{kern} {label} max |kernel - split plain version|: "
              + ", ".join(f"{n} ({k} splits) {e:.2e}"
                          for n, (k, e) in errs.items()), flush=True)
        del q, kc, vc, run
    return out


def _modes(kern: str, kv: str):
    """(name, serving mode) of the paths that run ``kern``."""
    if kern == "B3":
        return (("dense", dict(paged=False)),)
    if kern == "B4":
        return (("paged", dict(paged=True)),)
    if kern == "B5":
        return ((kv, dict(paged=True, kv_dtype=kv)),)
    if kern == "B7":
        return (("paged", dict(paged=True)),
                ("int8", dict(paged=True, kv_dtype="int8")),
                ("fp8_e4m3", dict(paged=True, kv_dtype="fp8_e4m3")))
    sp = dict(paged=True, spec_mode="ngram", spec_k=cs.SPEC_K)
    return (("spec", sp), ("spec-int8", dict(sp, kv_dtype="int8")))


def gaps(dev, kern: str, kv: str) -> list:
    """Each model that runs ``kern`` once, served in each of its modes
    with each split rule in turn."""
    s = cs.Smoke(torch)
    # check_serving's bookkeeping, without checks or records
    s.check = lambda ok, what: None
    s.kernels = collections.defaultdict(
        lambda: collections.defaultdict(dict, launches_by_path={}))
    rows = []
    models = (
        ("granite-8b", get_config("granite-8b"), {}),
        ("gemma2-2b", get_config("gemma2-2b"),
         dict(cache_len=cs.G2_CACHE_LEN, prompt_lens=cs.G2_PROMPT_LENS)),
        ("deepseek-v2-lite-16b", get_config("deepseek-v2-lite-16b"),
         dict(prefill=("rmsnorm",), replay=True)),
        ("jamba-1.5-large-398b", cs._jamba_config(),
         dict(prefill=("rmsnorm",), replay=True)))
    models = models[slice(*{"B5": (2,), "B6": (1,), "B7": (1, 2)}.get(
        kern, (None,)))]
    for label, cfg, kw in models:
        gc.collect()
        torch.cuda.empty_cache()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0),
                            device=dev)
        for (mode, served), (name, count) in itertools.product(
                _modes(kern, kv), variants(GAP_CHUNKS, shipped=False,
                                           kern=kern).items()):
            _, st = _with(count, lambda: cs.check_serving(
                s, model, params, f"{label} {mode}", served, {}, (),
                **kw), kern)()
            row = dict(model=label, mode=mode, split=name,
                       gap=st["teacher_gap"],
                       tokens=st["teacher_tokens"],
                       flipped=st["teacher_flipped"])
            rows.append(row)
            flag = "ok" if row["gap"] <= cs.TEACHER_GAP else "past"
            print(f"gap {label} {mode}, {kern} {name}: {row['gap']:.4f} "
                  f"({flag} {cs.TEACHER_GAP}); {row['flipped']} of "
                  f"{row['tokens']} tokens not the plain argmax", flush=True)
        del params, model
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--paged", action="store_true",
                    help="B4 over page pools and paged serving, not B3")
    ap.add_argument("--kv", choices=("int8", "fp8_e4m3"),
                    help="with --paged: B5 over pools of this type")
    ap.add_argument("--spec", action="store_true",
                    help="with --paged: B6, speculation over bf16 and "
                         "int8 pools")
    ap.add_argument("--window", action="store_true",
                    help="B7 and B7q over gemma2-2b's ring walks and its "
                         "paged, int8 and fp8 serving (B4 and B5 at their "
                         "shipped chunks)")
    ap.add_argument("--no-gaps", action="store_true",
                    help="check and time the split counts only")
    args = ap.parse_args()
    if (args.kv or args.spec) and not args.paged or args.kv and args.spec:
        ap.error("--kv or --spec, each with --paged")
    if args.window and args.paged:
        ap.error("--window runs alone")
    kern = ("B7" if args.window else "B6" if args.spec else
            "B5" if args.kv else "B4" if args.paged else "B3")
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
           "kernel": kern, "kv": args.kv,
           "times_ms": time_variants(dev, kern, args.kv)}
    if not args.no_gaps:
        res["gaps"] = gaps(dev, kern, args.kv)
    print(json.dumps({"decode_variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
