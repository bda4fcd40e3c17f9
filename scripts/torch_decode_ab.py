#!/usr/bin/env python3
"""Time the port's one-token decode kernels (dense B3, paged B4, and the
sliding-window B7) at granite-8b's and gemma2-2b's serving shapes, for
the ``repro_torch`` package found under ``--src``.

Register allocation of these kernels moves with small source changes,
so compare two versions only inside one call on one card, in turns:

    python3 scripts/torch_decode_ab.py --src build/parent/src --tag parent
    python3 scripts/torch_decode_ab.py --src src --tag change
    python3 scripts/torch_decode_ab.py --src src --tag change
    python3 scripts/torch_decode_ab.py --src build/parent/src --tag parent

Each run builds its kernels into its own checkout's ``build/`` and
prints one JSON line of medians (ms, CUDA events, 50 launches, L2
flushed between them).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serve.paging import live_window_pages, window_table_width

    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    g = torch.Generator(device=dev).manual_seed(0)

    def time_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def rnd(*shape):
        return torch.randn(*shape, device=dev, generator=g).bfloat16()

    def paged(kc, vc, lengths, ps=64):
        b, h, s, d = kc.shape
        t = s // ps
        bt = (torch.randperm(b * t, generator=torch.Generator().manual_seed(1))
              .reshape(b, t) + 1).to(torch.int32)
        for i, n in enumerate(lengths):
            bt[i, -(-n // ps):] = 0
        pools = []
        for c in (kc, vc):
            pool = torch.zeros(h, 1 + b * t, ps, d, device=dev,
                               dtype=c.dtype)
            pool[:, bt.long()] = c.reshape(b, h, t, ps, d).transpose(0, 1)
            pools.append(pool)
        return pools[0], pools[1], bt.to(dev)

    out = {"tag": args.tag, "card": torch.cuda.get_device_name(0)}
    for name, hq, hkv, d, s_len, lengths in (
            ("granite", 32, 8, 128, 1024, (1, 64, 200, 333, 511, 700, 900,
                                           1024)),
            ("gemma2", 8, 4, 256, 8192, (1, 17, 1001, 4096, 4151, 6001, 6032,
                                         8192))):
        q = rnd(len(lengths), hq, d)
        kc, vc = rnd(len(lengths), hkv, s_len, d), rnd(len(lengths), hkv,
                                                      s_len, d)
        ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
        out[f"B3 {name}"] = time_ms(lambda: ops.decode_attention(
            q, kc, vc, ln, return_residuals=True))
        kp, vp, bt = paged(kc, vc, lengths)
        out[f"B4 {name}"] = time_ms(lambda: ops.paged_decode_attention(
            q, kp, vp, bt, ln, return_residuals=True))
        if name == "gemma2":
            window, ps = 4096, 64
            tw = window_table_width(window, ps)
            perm = (torch.randperm(len(lengths) * tw) + 1).tolist()
            rt = torch.zeros(len(lengths), tw, dtype=torch.int32)
            for i, n in enumerate(lengths):
                for gp in live_window_pages(n, window, ps):
                    rt[i, gp % tw] = perm.pop()
            wk, wv = rnd(hkv, 1 + len(lengths) * tw, ps, d), \
                rnd(hkv, 1 + len(lengths) * tw, ps, d)
            rt = rt.to(dev)
            out["B7 gemma2"] = time_ms(
                lambda: ops.window_paged_decode_attention(
                    q, wk, wv, rt, ln, window=window, softcap=50.0,
                    return_residuals=True))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
