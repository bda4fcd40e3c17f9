#!/usr/bin/env python3
"""How far xlstm-1.3b's served logits drift from a plain forward, in
bf16 and in f32, on one CUDA card.

For each case (the full 48 layers at full width, and stacks of 8
mLSTM-only and 8 sLSTM-only layers at full width), with random weights
from seed 0 and a random prompt, it greedily decodes 32 tokens the way
the engine does (prefill through the kernels, then one-token steps)
and compares the logits at those 32 positions with three other
computations over the same tokens:

  A  one forward through the plain versions of every kernel (the
     teacher-forced reference);
  B  one forward through the kernels (B1, and B10 without its state);
  D  the plain versions as prefill then one-token steps, fed the served
     tokens.

It prints the teacher-forced gap (A's max logit minus A's logit of the
served token, largest over the 32 tokens), max |A - served|, max |A - B|
and max |A - D| over the real vocabulary, with the card's name and
power limit:

  PYTHONPATH=src python3 scripts/torch_xlstm_drift.py [--prompt-lens 17 200 511]
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

STEPS = 32
CACHE_LEN = 1024


def _serve(model, params, prompt):
    """Prefill then STEPS - 1 one-token steps through the kernels, each
    fed the previous argmax, as the engine serves one request; returns
    (logits (STEPS, Vp), the STEPS tokens sampled)."""
    p = prompt.shape[1]
    logits, caches = model.prefill(params, prompt, CACHE_LEN)
    rows, toks = [logits[0]], [int(logits.argmax(-1))]
    for j in range(STEPS - 1):
        ln = torch.tensor([p + j], dtype=torch.int32, device=prompt.device)
        tok = torch.tensor([toks[-1]], device=prompt.device)
        rows.append(model.decode_step(params, caches, tok, ln)[0])
        toks.append(int(rows[-1].argmax()))
    return torch.stack(rows), toks


def _forced(model, params, seq, p: int):
    """Plain prefill of ``seq[:, :p]`` then one-token steps fed
    ``seq[:, p:]``: logits (STEPS, Vp)."""
    logits, caches = model.prefill(params, seq[:, :p], CACHE_LEN, plain=True)
    rows = [logits[0]]
    for j in range(STEPS - 1):
        ln = torch.tensor([p + j], dtype=torch.int32, device=seq.device)
        rows.append(model.decode_step(params, caches, seq[:, p + j], ln,
                                      plain=True)[0])
    return torch.stack(rows)


def case(name: str, cfg, prompt_len: int, dev) -> None:
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    rng = np.random.default_rng(prompt_len)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, size=prompt_len)
                          [None], device=dev)
    v = cfg.vocab_size
    with torch.no_grad():
        served, toks = _serve(model, params, prompt)
        seq = torch.cat([prompt, torch.tensor([toks[:-1]], device=dev)], 1)
        a = model.forward_logits(params, seq, plain=True,
                                 start=prompt_len - 1)[0]
        b = model.forward_logits(params, seq, start=prompt_len - 1)[0]
        d = _forced(model, params, seq, prompt_len)
    t = torch.tensor(toks, device=dev)
    gap = a.max(-1).values - a.gather(1, t[:, None])[:, 0]

    def most(x):
        return float((x - a)[:, :v].abs().max())

    print(f"{name} {cfg.dtype} prompt {prompt_len}: teacher-forced gap "
          f"{float(gap.max()):.4f}; max |A - served| {most(served):.4f}, "
          f"|A - B| {most(b):.4f}, |A - D| {most(d):.4f} logits "
          f"(A's logits: std {float(a[:, :v].std()):.3f})", flush=True)
    del params, model
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt-lens", type=int, nargs="+",
                    default=[17, 200, 511])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_xlstm_drift: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}")
    full = get_config("xlstm-1.3b")
    for dt in ("float32", "bfloat16"):
        for p in args.prompt_lens:
            case("48 layers", dataclasses.replace(full, dtype=dt), p, dev)
    for kind in ("mlstm", "slstm"):
        for dt in ("float32", "bfloat16"):
            cfg = dataclasses.replace(full, dtype=dt, num_layers=8,
                                      layer_pattern=(kind,))
            case(f"8 {kind} layers", cfg, args.prompt_lens[1 % len(
                args.prompt_lens)], dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
