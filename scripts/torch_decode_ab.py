#!/usr/bin/env python3
"""Time the port's one-token decode kernels (dense B3, paged B4, its
quantized mode B5, the speculative B6 and the sliding-window B7 and
B7q) at granite-8b's and gemma2-2b's serving shapes, and
the RMSNorm B1 at granite-8b's, gemma2-2b's and jamba-1.5-large-398b's
prefill rows (beside ``F.rms_norm``, the library call computing the
same function), for the ``repro_torch`` package found under ``--src``,
and keep their outputs (B1's in bf16 and f32) for a bit-for-bit
comparison.

Register allocation of these kernels moves with small source changes,
so compare two versions only inside one call on one card, in turns:

    python3 scripts/torch_decode_ab.py --src build/parent/src --tag parent \\
        --save build/ab_parent.pt
    python3 scripts/torch_decode_ab.py --src src --tag change \\
        --save build/ab_change.pt
    python3 scripts/torch_decode_ab.py --src src --tag change
    python3 scripts/torch_decode_ab.py --src build/parent/src --tag parent
    python3 scripts/torch_decode_ab.py --compare build/ab_parent.pt \\
        build/ab_change.pt

(B1's outputs make each --save file about 0.4 GB.)

Each run builds its kernels into its own checkout's ``build/``, spins
the card for about a second (a process's first timings otherwise ran
slow) and prints one JSON line of medians (ms, CUDA events, 50
launches, L2 flushed between them, then about 0.5 ms of waiting on the
card, so that the host has queued the call before the card reaches the
start event and the events time the card alone).  The split-KV
kernels (B3-B6, and B7 and B7q where the package's ops take
``splits``) run with the package's own split rule and with one split,
B3, B4, B7 and B7q also with 8 ("one split": a package whose op lacks
the argument has only the unsplit kernel, so its "one split" is its
plain call); only the one-split outputs are kept.  Kept untimed
besides: B3-B6 at granite-8b's shapes with f32 queries (B3, B4 and B6
over f32 caches and pools, B5 and B6 over int8 and fp8 pools), B5 and
B6 over fp8 pools, B5 at head dim 64, B6 at head dim 256, B3 and B4
(timed at one split) and B5 and B6 (where the package builds them) at
deepseek-v2-lite-16b's 16 heads of 192 / 128, and B7 and
B7q (int8, fp8) at head dims 64 and 128 and with f32 queries (B7 over
f32 pools).  ``--compare`` prints, for
every output the two files share, whether they are equal bit for bit,
and exits 1 if any is not.
"""
from __future__ import annotations

import argparse
import inspect
import json
import statistics
import sys
from pathlib import Path


def compare(a: str, b: str) -> int:
    import torch
    x, y = torch.load(a), torch.load(b)
    same = {k: all(torch.equal(p, q) for p, q in zip(x[k], y[k]))
            for k in sorted(set(x) & set(y))}
    print(json.dumps({"bit_identical": same}))
    return 0 if all(same.values()) else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="src")
    ap.add_argument("--tag", default="")
    ap.add_argument("--save", help="keep every output in this file")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="compare two --save files and exit")
    args = ap.parse_args()
    if args.compare:
        return compare(*args.compare)
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    from repro_torch.kernels.decode_attention import ops
    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.quant import resolve_kv_spec
    from repro_torch.serve.paging import live_window_pages, window_table_width

    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    # a process's first timings ran slow: spin about a second
    torch.cuda._sleep(2_000_000_000)
    g = torch.Generator(device=dev).manual_seed(0)
    one_split, paged_one, quant_one, spec_one, window_one = (
        {"splits": 1} if "splits" in inspect.signature(fn).parameters
        else {} for fn in (ops.decode_attention, ops.paged_decode_attention,
                           ops.quant_paged_decode_attention,
                           ops.spec_paged_decode_attention,
                           ops.window_paged_decode_attention))
    outputs = {}

    def time_ms(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush.zero_()
            torch.cuda._sleep(1_000_000)  # about 0.5 ms: the call is queued
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def keep(key, fn):
        outputs[key] = tuple(t.cpu() for t in fn())
        return fn

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
            d = c.shape[-1]                 # MLA's V is narrower than K
            pool = torch.zeros(h, 1 + b * t, ps, d, device=dev,
                               dtype=c.dtype)
            pool[:, bt.long()] = c.reshape(b, h, t, ps, d).transpose(0, 1)
            # the null tails all wrote page 0, racing: which write lands
            # differs between runs, and B6's later rows read it
            pool[:, 0] = 0
            pools.append(pool)
        return pools[0], pools[1], bt.to(dev)

    int8 = resolve_kv_spec("int8", dev, strict=True)
    fp8 = resolve_kv_spec("fp8_e4m3", dev, strict=True)

    def quantized(spec, kp, vp):
        (kq, ks), (vq, vs) = spec.quantize_pages(kp), spec.quantize_pages(vp)
        return kq, vq, ks, vs

    def untimed(name, q, kp, vp, bt, ln, s_len, k1=5):
        """Keep B5's (int8, fp8) and B6's (the pools, int8, fp8)
        one-split outputs for q, pools and table."""
        qs = q[:, None].expand(-1, k1, -1, -1).contiguous()
        base = ln.clamp(max=s_len - k1) - 1
        for kvn, spec in (("int8", int8), ("fp8", fp8)):
            quant = quantized(spec, kp, vp)
            keep(f"B5 {name} {kvn}", lambda: ops.quant_paged_decode_attention(
                q, *quant, bt, ln, return_residuals=True, **quant_one))
            keep(f"B6 {name} {kvn}",
                 lambda: ops.quant_spec_paged_decode_attention(
                     qs, *quant, bt, base, return_residuals=True,
                     **spec_one))
        keep(f"B6 {name}", lambda: ops.spec_paged_decode_attention(
            qs, kp, vp, bt, base, return_residuals=True, **spec_one))

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
        out[f"B3 {name} one split"] = time_ms(keep(
            f"B3 {name} one split", lambda: ops.decode_attention(
                q, kc, vc, ln, return_residuals=True, **one_split)))
        if one_split:
            out[f"B3 {name} 8 splits"] = time_ms(
                lambda: ops.decode_attention(q, kc, vc, ln,
                                             return_residuals=True, splits=8))
        kp, vp, bt = paged(kc, vc, lengths)
        out[f"B4 {name}"] = time_ms(lambda: ops.paged_decode_attention(
            q, kp, vp, bt, ln, return_residuals=True))
        out[f"B4 {name} one split"] = time_ms(keep(
            f"B4 {name} one split", lambda: ops.paged_decode_attention(
                q, kp, vp, bt, ln, return_residuals=True, **paged_one)))
        if paged_one:
            out[f"B4 {name} 8 splits"] = time_ms(
                lambda: ops.paged_decode_attention(
                    q, kp, vp, bt, ln, return_residuals=True, splits=8))
        kq, vq, ks, vs = quantized(int8, kp, vp)
        out[f"B5 {name} int8"] = time_ms(
            lambda: ops.quant_paged_decode_attention(
                q, kq, vq, ks, vs, bt, ln, return_residuals=True))
        out[f"B5 {name} int8 one split"] = time_ms(
            lambda: ops.quant_paged_decode_attention(
                q, kq, vq, ks, vs, bt, ln, return_residuals=True,
                **quant_one))
        if name == "granite":
            qs = rnd(len(lengths), 5, hq, d)
            base = ln.clamp(max=s_len - 5) - 1
            out["B6 granite k1 5"] = time_ms(
                lambda: ops.spec_paged_decode_attention(
                    qs, kp, vp, bt, base, return_residuals=True))
            out["B6 granite k1 5 one split"] = time_ms(
                lambda: ops.spec_paged_decode_attention(
                    qs, kp, vp, bt, base, return_residuals=True,
                    **spec_one))
            out["B6 granite k1 5 int8"] = time_ms(
                lambda: ops.quant_spec_paged_decode_attention(
                    qs, kq, vq, ks, vs, bt, base, return_residuals=True))
            out["B6 granite k1 5 int8 one split"] = time_ms(
                lambda: ops.quant_spec_paged_decode_attention(
                    qs, kq, vq, ks, vs, bt, base, return_residuals=True,
                    **spec_one))
            # f32: B3, B4 and B6 over f32 caches and pools, B5 and B6's
            # quantized mode on f32 queries
            qf, kf, vf = q.float(), kc.float(), vc.float()
            keep("B3 granite f32", lambda: ops.decode_attention(
                qf, kf, vf, ln, return_residuals=True, **one_split))
            kpf, vpf, btf = paged(kf, vf, lengths)
            keep("B4 granite f32", lambda: ops.paged_decode_attention(
                qf, kpf, vpf, btf, ln, return_residuals=True, **paged_one))
            untimed("granite f32", qf, kpf, vpf, btf, ln, s_len)
            untimed("granite", q, kp, vp, bt, ln, s_len)
            # head dim 64: granite's heads and lengths at half the width
            q64, k64, v64 = (t[..., :64].contiguous() for t in (q, kc, vc))
            kp64, vp64, bt64 = paged(k64, v64, lengths)
            untimed("granite d64", q64, kp64, vp64, bt64, ln, s_len)
            del qf, kf, vf, kpf, vpf, q64, k64, v64, kp64, vp64
        else:
            untimed(name, q, kp, vp, bt, ln, s_len)
        if name == "gemma2":
            window, ps = 4096, 64
            tw = window_table_width(window, ps)
            perm = (torch.randperm(len(lengths) * tw, generator=torch
                                   .Generator().manual_seed(2)) + 1).tolist()
            rt = torch.zeros(len(lengths), tw, dtype=torch.int32)
            for i, n in enumerate(lengths):
                for gp in live_window_pages(n, window, ps):
                    rt[i, gp % tw] = perm.pop()
            wk, wv = rnd(hkv, 1 + len(lengths) * tw, ps, d), \
                rnd(hkv, 1 + len(lengths) * tw, ps, d)
            rt = rt.to(dev)
            wkw = dict(window=window, softcap=50.0, return_residuals=True)

            def b7(qq, kk, vv, spec=None, **kw):
                """B7 over kk, vv, or B7q over them quantized by spec."""
                if spec is None:
                    return lambda: ops.window_paged_decode_attention(
                        qq, kk, vv, rt, ln, **wkw, **kw)
                quant = quantized(spec, kk, vv)
                return lambda: ops.quant_window_paged_decode_attention(
                    qq, *quant, rt, ln, **wkw, **kw)

            for key, spec in (("B7 gemma2", None), ("B7q gemma2 int8", int8),
                              ("B7q gemma2 fp8", fp8)):
                out[key] = time_ms(b7(q, wk, wv, spec))
                out[f"{key} one split"] = time_ms(keep(
                    f"{key} one split", b7(q, wk, wv, spec, **window_one)))
                if window_one:
                    out[f"{key} 8 splits"] = time_ms(
                        b7(q, wk, wv, spec, splits=8))
            # untimed: head dims 64 and 128, f32 queries (B7 over f32
            # pools)
            for dd in (64, 128):
                qd, kd, vd = (t[..., :dd].contiguous() for t in (q, wk, wv))
                keep(f"B7 gemma2 d{dd}", b7(qd, kd, vd, **window_one))
                for kvn, spec in (("int8", int8), ("fp8", fp8)):
                    keep(f"B7q gemma2 d{dd} {kvn}",
                         b7(qd, kd, vd, spec, **window_one))
                del qd, kd, vd
            keep("B7 gemma2 f32", b7(q.float(), wk.float(), wv.float(),
                                     **window_one))
            for kvn, spec in (("int8", int8), ("fp8", fp8)):
                keep(f"B7q gemma2 f32 {kvn}",
                     b7(q.float(), wk, wv, spec, **window_one))
    # deepseek-v2-lite-16b's MLA heads (16 of 192 / 128, one a kv head):
    # B3 and B4 at one split; B5 and B6 where the package has that build
    lengths = (1, 64, 200, 333, 511, 700, 900, 1024)
    q = rnd(len(lengths), 16, 192)
    kc, vc = rnd(len(lengths), 16, 1024, 192), rnd(len(lengths), 16, 1024,
                                                   128)
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    scale = dict(scale=192 ** -0.5, return_residuals=True)
    out["B3 deepseek one split"] = time_ms(keep(
        "B3 deepseek one split", lambda: ops.decode_attention(
            q, kc, vc, ln, **scale, **one_split)))
    kp, vp, bt = paged(kc, vc, lengths)
    out["B4 deepseek one split"] = time_ms(keep(
        "B4 deepseek one split", lambda: ops.paged_decode_attention(
            q, kp, vp, bt, ln, **scale, **paged_one)))
    try:
        untimed("deepseek", q, kp, vp, bt, ln, 1024)
    except NotImplementedError as e:        # a package without them
        out["B5/B6 deepseek"] = str(e)[:80]
    del q, kc, vc, kp, vp
    kw = dict(eps=1e-6, weight_offset=1.0)
    for name, rows, d in (("granite", 4096, 4096), ("gemma2", 18000, 2304),
                          ("jamba", 1022, 8192)):
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(rows, d, device=dev, generator=g).to(dt)
            w = (0.1 * torch.randn(d, device=dev, generator=g)).to(dt)
            fn = keep(f"B1 {name} {str(dt)[6:]}",
                      lambda: (rms.rmsnorm(x, w, **kw),))
            if dt == torch.bfloat16:
                out[f"B1 {name}"] = time_ms(fn)
                w1 = w + 1.0
                out[f"F.rms_norm {name}"] = time_ms(
                    lambda: torch.nn.functional.rms_norm(x, (d,), w1, 1e-6))
    if args.save:
        Path(args.save).parent.mkdir(parents=True, exist_ok=True)
        torch.save(outputs, args.save)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
