#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (exit 1, no result line) if it fails:

1. the card: ``torch.cuda`` and ``nvidia-smi`` (name, power limit);
2. build every kernel of the serving path from ``src/repro_torch/csrc``
   with ``nvcc``, one process per source, all at once;
3. hold each kernel against its plain PyTorch version on the card, at
   the shapes the serving paths give it and at edge cases, and time the
   kernel, the plain version and, where one exists, the PyTorch library
   call that computes the same function (a yardstick the port never
   calls), beside the least time the card could take; the flash
   kernel's bf16 (tensor-core) body is also held to its operand-rounding
   model (``flash_attention_bf16_operands``) at TOL_OPERANDS, tighter than
   TOL_BF16, and by the share of its bf16 outputs that differ from the
   model's (at most ``MODEL_MISMATCH``), which a control build of B2
   with one P term fewer must exceed, at every head-dim build; the
   split-KV decode kernels (B3 dense, B4 paged, B5 over int8 and fp8
   pools, B6 speculative over bf16 and int8 pools) at the split count
   each is served with and at SPLIT_CHECK splits are held to their split
   plain versions (``decode_attention_ref(chunk=...)``,
   ``paged_decode_attention_ref(chunk=...)``,
   ``quant_paged_decode_attention_ref(chunk=...)``,
   ``spec_paged_decode_attention_ref(chunk=...)`` and its quantized
   twin) and, as a control, at one split to the unsplit plain versions,
   with m of every launch bit for bit, each launch a single one, and
   timed at one split and at SPLIT_CHECK beside their served records; B1
   at granite's, gemma2's and jamba's
   rows in bf16 and f32 is held bit for bit to its native twin B11a and
   its generic build, and timed in turns with B11a and ``F.rms_norm``;
   all at each of their shapes: granite-8b's
   shapes (head dim 128), then gemma2-2b's (head dim 256): the
   sliding-window kernels over ring tables (bf16, int8, fp8) and the
   head-dim-256 builds of the prefill, dense, paged and quantized
   decode kernels, at lengths 1 to 8,192, rings wrapped and not; then
   deepseek-v2-lite-16b's: the grouped matmul of the MoE experts (the
   reference's example with masked rows, sizes 0 and C, the decode
   shape and the largest prefill's, timed beside ``torch.bmm``) and
   the Dk 192 / Dv 128 builds of the prefill, dense and paged decode
   kernels (MLA); then jamba-1.5-large-398b's: the selective scan of the
   mamba layers (the reference's example, then B 1 and 2 x S 17, 64,
   200 and 511 at d_inner 16384 and 16 states, bf16 with f32 A and D),
   and the norm, prefill, dense and paged decode kernels (64 query heads
   on 8 KV heads of 128) and the grouped matmul (16 experts of 8192 x
   24576) at its shapes; then xlstm-1.3b's: the mLSTM scan with its
   final state (the reference's example, then B 1 and 2 x S 1, 17, 64,
   200 and 511 at 4 heads of Dk = Dv = 1024, bf16 with f32 gates);
   then the portable runtime against the native twins
   (``repro_torch.bench.parity``, with every launch count set to 0
   before it and read after): B1 and B2, written against the device
   runtime ``csrc/rt/``, bit-identical to their hard-coded twins B11a
   and B11b at granite's, gemma2's, jamba's and the reference's parity
   shapes, all four within tolerance of the plain versions, their SASS
   opcode histograms, registers and times in turns printed; HMMA
   instructions in every bf16 build of B2, B11b and B8 and none in B2's
   generic build; B1 and B2
   built for the generic target within tolerance; the runtime test
   kernel's order-free outcomes held to the plain atomics for both
   targets (every thread holding its team's sum and max, every warp's
   tensor-core product of two bf16 tiles and its quad reductions
   exact), and a generic
   build of ``atomic_inc`` refused; the SPEC ACCEL stand-ins' twins
   (B12-B17, each one source built against ``csrc/rt/`` and against
   ``csrc/native/rt_native.cuh``) compared the same way at the
   reference's and the card's shapes, and miniQMC's (B18-B19) by their
   SASS;
   then the SPEC ACCEL stand-ins on the device runtime
   (``repro_torch.bench.spec_accel``, every launch count set to 0
   before it and read after): postencil, polbm, pomriq, pep, pcg and
   pbt and their native builds, each launched, native and portable bit
   for bit and each build (and the generic one) within tolerance of its
   plain version, at both shapes; the reference's Fig. 2 rows printed;
   then miniQMC's two hot regions on the device runtime
   (``repro_torch.bench.miniqmc``, the same way): evaluate_vgh and
   evaluate_det_ratios and their native builds, checked as the
   stand-ins, the paper's Table 1 rows printed;
4. serve 12 greedy requests through ``repro_torch.serve.Engine`` on
   ``granite-8b`` at full width (36 layers, random weights from a seed)
   with paged KV; every kernel of the path must have launched, the host
   must have synchronised once per decode step and once per admitted
   prompt-length group, and every emitted token must be within 0.05
   logits of the argmax of a plain-path forward over the same tokens
   (the share of emitted tokens that are not that argmax is printed for
   every served run);
5. the same requests through the dense KV cache, checked the same way;
6. the same requests from int8 and from fp8-e4m3 page pools (fp8
   resolved strictly, so it can never quietly become int8), with the
   quantized kernel launched 36 times per decode step and the bf16 one
   never; the teacher-forced gap, the agreement with bf16 and the pool
   bytes per slot are reported (int8 must take under 0.53 of bf16's);
7. the same requests with n-gram self-speculative decoding (k = 4) over
   bf16 pools, checked as phase 4 plus: the speculative kernel launched
   36 times per step, at least one rejected draft; and again over an
   int8 pool;
8. free granite-8b and serve 12 greedy requests of 17 to 6,000 tokens
   on ``gemma2-2b`` at full width and depth (26 layers alternating a
   4,096-token window and global attention, random weights from a
   seed), cache 8,192: paged (global layers through the paged kernel,
   local ones through the window kernel over ring tables, 13 launches
   each per step), dense (rings for local layers, 26 dense-kernel
   launches per step), and from int8 and fp8 pools (the quantized
   kernels, 13 each per step); checked as phase 4, plus: pages behind
   the window freed during the run and the allocator audit clean at the
   end (paged modes), the teacher-forced gap checked for bf16 and
   reported for int8/fp8, and the dense/paged token agreement
   reported, and for each request whose dense and paged tokens differ,
   at the first token where they do, the top-2 logit margins each run
   served there and a plain forward's over the common prefix;
9. free gemma2-2b and serve the same 12 requests as granite on
   ``deepseek-v2-lite-16b`` at full width and depth (27 MLA layers,
   the first dense, then 64 routed experts top-6 and 2 shared experts
   on each of the other 26; random weights from a seed), paged and
   dense: checked as phase 4, with 27 launches of the mode's decode
   kernel and 78 of the grouped matmul per decode step (and 78 per
   admitted group), the assignments that capacity dropped reported,
   and the teacher-forced gap taken against a plain replay of the run's
   own calls (same prefill groups, same decode batches, the served
   tokens and expert choices fed back, so each MoE call drops what it
   dropped when served; a replay routing by its own top-k is reported);
10. free deepseek-v2-lite-16b and serve the same 12 requests on
   ``jamba-1.5-large-398b`` at full width cut to 4 layers (an attention
   layer with a dense MLP, then three mamba layers, the first and third
   with 16 experts top-2 of d_ff 24,576; 23 B parameters, 46 GB; random
   weights from a seed), paged and dense: checked as phase 9, with 1
   launch of the mode's decode kernel and 6 of the grouped matmul per
   decode step (and 6 per admitted group), and 3 of the selective scan
   per admitted group and none in a decode step;
11. free jamba-1.5-large-398b and serve the same 12 requests on
   ``xlstm-1.3b`` at full width and depth (48 layers: seven mLSTM, then
   one sLSTM, six times; no attention layer; 3.6 B parameters, random
   from a seed), paged and dense: checked as phase 4, with 42 launches
   of the mLSTM scan per admitted group (every mLSTM layer's prefill,
   with its state output) and none in a decode step, and no attention
   kernel launched; then ``Model.loss`` of one batch of 2 x 512 tokens
   through the kernels (the mLSTM scan once per mLSTM layer) and
   through their plain versions, the two within XL_LOSS_TOL;
12. trace five paged decode steps of each model for the card's busy
   share (reported, not checked).

Each phase prints its wall time.

It then prints a ``{"kernels": [...]}`` line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``.  Without
a CUDA card, or without the repository beside it, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12     # H100 SXM: 80 GB HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12     # H100 SXM: dense bf16 tensor-core peak
INT8_OPS_PER_S = 1979e12      # H100 SXM: dense int8 / fp8 tensor-core peak
# exponentials: 16 ex2 per clock per SM on sm_90 (CUDA C++ Programming
# Guide, arithmetic instruction throughput) x 132 SMs x the 1,980 MHz
# boost clock of the H100 SXM
EXP_PER_S = 132 * 16 * 1.98e9
# f32 outside the tensor cores: 128 lanes per SM x 132 SMs x 1,980 MHz,
# an FMA counted as 2 operations (NVIDIA's data sheet: 67 TFLOP/s)
F32_FLOPS_PER_S = 67e12
# atol = rtol by the output's dtype, compared in f32.  Both sides read
# the same inputs and sum in f32, in another order; bf16 outputs are
# also rounded to 8 mantissa bits.  The decode kernels' residuals
# (acc, m, l) and their normalised output are f32.
TOL_F32, TOL_BF16 = 1e-4, 2e-2
# B2's bf16 body against its operand-rounding model (kernels/
# flash_attention/ref.py flash_attention_bf16_operands), atol = rtol: the
# two round the same operands (P into the same bf16 terms too), so they
# part by a bf16 output rounding that a few f32 ulps flip and, rarely, a
# p whose bf16 rounding flips; a misplaced fragment moves outputs by far
# more.  One P term fewer moves them by about an output's bf16 ulp, inside
# this tolerance: ref.MODEL_MISMATCH, a share of differing outputs, is
# the check that sees it (operands_model).
TOL_OPERANDS = 1e-2
TEACHER_GAP = 0.05            # logits: emitted token vs the plain argmax
# B3 is also held and timed at this many splits at every shape, so that
# its merge runs where the served count is 1 (caches of 1024 rows)
SPLIT_CHECK = 8
PROMPT_LENS = (17, 64, 200, 511)
# B1's served shapes (label, rows, d): prefills of granite-8b (8 x 512),
# gemma2-2b (3 x 6000) and jamba-1.5-large-398b (2 x 511 at d_model
# 8192, the widest row the served paths normalise)
RMS_SHAPES = (("granite", 8 * 512, 4096), ("gemma2", 18000, 2304),
              ("jamba", 1022, 8192))
N_REQUESTS, MAX_NEW, SLOTS, CACHE_LEN, PAGE = 12, 32, 8, 1024, 64
DECODE_LENGTHS = (1, 64, 200, 333, 511, 700, 900, 1024)
SPEC_K = 4                    # drafts per speculative step: K1 = 5
# pre-speculation prefixes of the speculative kernel check: the window
# of the last slot ends at the cache's last row
SPEC_BASES = (0, 64, 200, 333, 511, 700, 900, CACHE_LEN - SPEC_K - 1)
# gemma2-2b: 8 query / 4 KV heads of 256, a 4,096-token window on local
# layers.  Prompts of 4,150 tokens cross a page boundary behind the
# window while decoding; 6,000-token prompts start with wrapped rings.
G2_PROMPT_LENS = (17, 1000, 4150, 6000)
G2_CACHE_LEN, G2_WINDOW, G2_HQ, G2_HKV, G2_D = 8192, 4096, 8, 4, 256
# decode lengths of the gemma2 kernel checks: inside the window, at its
# edge, rings wrapped, and the last row of the cache
G2_LENGTHS = (1, 17, 1001, 4096, 4151, 6001, 6032, 8192)
G2_FLASH_S = 6000             # the longest prompt
G2_SOFTCAP = 50.0
# deepseek-v2-lite-16b: 16 MLA heads (query/key 192 = 128 + 64 rope,
# value 128) over d_model 2048; 64 routed experts, top 6, of d_ff 1408
DS_H, DS_DK, DS_DV = 16, 192, 128
DS_E, DS_TOPK, DS_D, DS_FF = 64, 6, 2048, 1408
# jamba-1.5-large-398b at full width, cut to 4 layers (attention, then
# three mamba layers; MoE on layers 1 and 3): 64 query / 8 KV heads of
# 128 over d_model 8192; mamba d_inner 16384 with 16 states; 16 experts
# top-2 of d_ff 24576
JB_LAYERS, JB_HQ, JB_HKV, JB_DM = 4, 64, 8, 8192
JB_DI, JB_N, JB_E, JB_TOPK, JB_FF = 16384, 16, 16, 2, 24576
# the scan's check lengths: below, at and off multiples of the chunk
JB_SCAN_LENS = (17, 64, 200, 511)
# xlstm-1.3b at full width and depth: 48 layers (seven mLSTM, then one
# sLSTM, six times), d_model 2048, mLSTM d_inner 4096 in 4 heads of
# 1024, so B10 runs at Dk = Dv = 1024
XL_H, XL_D = 4, 1024
# the mLSTM scan's check lengths: one step, off and at multiples of its
# chunk of 8, and the longest prompt
XL_SCAN_LENS = (1, 17, 64, 200, 511)
XL_LOSS_B, XL_LOSS_S = 2, 512      # Model.loss: one batch of 2 x 512
# xlstm-1.3b in bf16 with random weights is chaotic: its sLSTM gate
# weights are drawn with fan-in 4 (the reference's law for the (4, d, d)
# stack), so the gates' pre-activations spread with a standard deviation
# near 12 and the exponential input gate picks, almost as an argmax over
# time, which step a cell remembers; a one-ulp bf16 difference anywhere
# can flip that pick.  Measured on the card, the plain version alone
# gives logits about 4 apart between prefill + decode and one forward
# over the same tokens, in bf16, and 0.008 apart in f32.  So the
# teacher-forced gap and the loss are checked on the same weights in
# f32 (the kernels' f32 builds), and reported for the bf16 runs.
XL_DTYPES = ("bfloat16", "float32")
# |f32 loss through the kernels - through their plain versions|: the
# two sum in another order only; at full depth each position's logits
# stay within about 0.03 of each other (measured), and the loss is a
# mean over 1,024 positions of a log-sum-exp minus one logit.
XL_LOSS_TOL = 1e-3
# the registry example's tolerance (repro.kernels.mlstm_scan.ops), f32
XL_TOL = 2e-4
# B10 against the plain version of its body (bf16: the chunkwise form,
# all in f32; f32: the recurrence): f32 outputs at half the op's
# tolerance, which holds the bf16 kernel's rounding of C, D o S and w V
# to bf16 high and low halves on the tensor cores (about 2^-17 of each
# term)
XL_CHUNK_TOL = 1e-4
# decode steps traced for the card's busy share: all 8 slots decoding,
# none admitting (8 requests admitted at step 1 finish at step 32)
PROFILED_STEPS = (10, 15)


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failures = []
        self.kernels = {}          # name -> the JSON record
        # zeroed between timed launches: the serving path meets its
        # operands cold, not in the 50 MB L2 the previous launch warmed
        self.flush = torch.empty(256 << 20, dtype=torch.uint8,
                                 device=self.dev)

    # -- helpers ----------------------------------------------------------
    def check(self, ok: bool, what: str) -> None:
        print(("  ok    " if ok else "  FAIL  ") + what)
        if not ok:
            self.failures.append(what)

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            return fn(*args)
        except Exception:                       # report, go on, fail at end
            traceback.print_exc()
            self.failures.append(f"{name}: {traceback.format_exc(limit=1)}")
            return None
        finally:
            print(f"   ({name}: {time.perf_counter() - t0:.1f} s)",
                  flush=True)

    def time_ms(self, fn, iters: int = 20) -> float:
        """Median ms of ``fn`` over ``iters`` launches, each after an L2
        flush and a wait on the card (``bench.timing.flush_and_settle``:
        the host queues the call meanwhile, so the events time the card
        alone)."""
        torch = self.torch
        from repro_torch.bench.timing import flush_and_settle
        fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            flush_and_settle(self.flush)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs)

    def compare(self, what: str, got, want, tol_f32=TOL_F32,
                tol_bf16=TOL_BF16) -> float:
        """Max abs difference over the outputs, in f32; checks each
        output at the tolerance of its dtype (``tol_f32`` for f32
        outputs: an op's own where it states one; ``tol_bf16`` for the
        others)."""
        torch = self.torch
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err, worst, ok, tols = 0.0, 0.0, True, set()
        for g, w in zip(got, want):
            tol = tol_f32 if g.dtype == torch.float32 else tol_bf16
            tols.add(tol)
            g, w = g.float(), w.float()
            ok &= g.shape == w.shape and bool(torch.isfinite(g).all())
            ok &= bool(torch.allclose(g, w, atol=tol, rtol=tol))
            diff = (g - w).abs()
            # the share of allclose's allowed difference that was used
            worst = max(worst, float((diff / (tol + tol * w.abs())).max()))
            err = max(err, float(diff.max()))
        self.check(ok, f"{what}: max abs diff {err:.3e} (atol = rtol = "
                       f"{', '.join(f'{t:g}' for t in sorted(tols))}; "
                       f"worst diff / allowed {worst:.3f})")
        return err

    def timings(self, what, ms, plain_ms, nbytes, flops, library_ms,
                ops_per_s=BF16_FLOPS_PER_S, unit="GFLOP"):
        """Print a kernel's times beside the least time the card could
        take (``ops_per_s``: the peak for the operations' type, counted
        in ``unit``); returns (bound_ms, bound_by)."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / ops_per_s * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
        print(f"  {what}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"library {lib}, bound {max(t_bytes, t_ops):.4f} ms "
              f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} {unit})")
        return max(t_bytes, t_ops), by

    def record(self, name, source, replaces, err, ms, plain_ms, nbytes,
               flops, library_ms, ops_per_s=BF16_FLOPS_PER_S, unit="GFLOP"):
        bound, by = self.timings(name, ms, plain_ms, nbytes, flops,
                                 library_ms, ops_per_s, unit)
        self.kernels[name] = {
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{source}",
            "replaces": replaces, "launches": 0, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": by, "library_ms": library_ms,
            "launches_by_path": {}}

    def record_also(self, name, key, err, ms, plain_ms, nbytes, flops,
                    library_ms, ops_per_s=BF16_FLOPS_PER_S):
        """The same kernel at another path's shapes (``key``, e.g. the
        head-dim-256 build gemma2 runs): kept beside the main record."""
        bound, by = self.timings(f"{name} ({key})", ms, plain_ms, nbytes,
                                 flops, library_ms, ops_per_s)
        self.kernels[name][key] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "library_ms": library_ms}


# ------------------------------------------------------------ kernels -----

def check_rmsnorm(s: Smoke) -> None:
    """B1 against its plain version at granite's shape and at edges (rows
    staged one or two a team, and the streaming body of rows that are
    not whole 16-byte vectors or wider than the staging holds); then at
    every served shape in bf16 and f32, B1, its twin B11a and its
    generic build bit for bit, and in bf16 B1, B11a and ``F.rms_norm``
    timed in turns."""
    torch = s.torch
    from repro_torch.bench.timing import time_in_turns, under
    from repro_torch.kernels.rmsnorm import native, ops, ref
    g = torch.Generator(device=s.dev).manual_seed(1)
    rows, d = 8 * 512, 4096                      # a prefill of 8 x 512
    x = torch.randn(rows, d, device=s.dev, generator=g).bfloat16()
    w = (0.1 * torch.randn(d, device=s.dev, generator=g)).bfloat16()
    kw = dict(eps=1e-6, weight_offset=1.0)
    err = s.compare(f"rmsnorm ({rows}, {d}) bf16", ops.rmsnorm(x, w, **kw),
                    ref.rmsnorm_ref(x, w, **kw))
    # staged two a team: (3, 100) f32; one a team: (8, 4096) bf16;
    # streaming: (3, 100) bf16 (200 bytes a row), (2, 16384) f32 (64 KB)
    for shape, dt in (((8, d), torch.bfloat16), ((3, 100), torch.float32),
                      ((3, 100), torch.bfloat16),
                      ((2, 16384), torch.float32)):
        xe = torch.randn(*shape, device=s.dev, generator=g).to(dt)
        we = torch.randn(shape[1], device=s.dev, generator=g).to(dt)
        s.compare(f"rmsnorm {shape} {dt}", ops.rmsnorm(xe, we, **kw),
                  ref.rmsnorm_ref(xe, we, **kw))
    w1 = w + 1.0
    s.record("rmsnorm", "rmsnorm.cu", "src/repro/kernels/rmsnorm/"
             "rmsnorm.py:22", err, s.time_ms(lambda: ops.rmsnorm(x, w, **kw)),
             s.time_ms(lambda: ref.rmsnorm_ref(x, w, **kw)),
             2 * x.numel() * 2 + 2 * d, 4 * x.numel(),
             s.time_ms(lambda: torch.nn.functional.rms_norm(
                 x, (d,), w1, 1e-6)))
    turns = s.kernels["rmsnorm"]["in_turns"] = {}
    for label, rows, d in RMS_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            xs = torch.randn(rows, d, device=s.dev, generator=g).to(dt)
            ws = (0.1 * torch.randn(d, device=s.dev, generator=g)).to(dt)
            got = ops.rmsnorm(xs, ws, **kw)
            twin = native.rmsnorm_native(xs, ws, **kw)
            generic = under("generic", lambda: ops.rmsnorm(xs, ws, **kw))()
            s.check(bool(torch.equal(got, twin) and torch.equal(got, generic)),
                    f"rmsnorm {label} ({rows}, {d}) {str(dt)[6:]}: B1, B11a "
                    f"and B1's generic build bit for bit")
            if dt == torch.bfloat16:
                w1 = ws + 1.0
                ms = time_in_turns([
                    lambda: ops.rmsnorm(xs, ws, **kw),
                    lambda: native.rmsnorm_native(xs, ws, **kw),
                    lambda: torch.nn.functional.rms_norm(xs, (d,), w1, 1e-6)],
                    s.flush)
                turns[label] = dict(zip(("B1", "B11a", "F.rms_norm"), ms))
                print(f"  rmsnorm {label} ({rows}, {d}) bf16 in turns: B1 "
                      f"{ms[0]:.4f} ms, B11a {ms[1]:.4f}, F.rms_norm "
                      f"{ms[2]:.4f}")
            del xs, ws, got, twin, generic


def check_flash(s: Smoke) -> None:
    torch = s.torch
    from repro_torch.kernels.flash_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=s.dev).manual_seed(2)

    def qkv(b, sq, dt=torch.bfloat16, d=128):
        return tuple(torch.randn(b, h, sq, d, device=s.dev,
                                 generator=g).to(dt) for h in (32, 8, 8))

    main = qkv(4, 512)
    err = s.compare("flash (4, 32/8, 512, 128) causal bf16",
                    ops.flash_attention(*main), ref.flash_attention_ref(*main))
    operands_model(s, "flash (4, 32/8, 512, 128) causal bf16", main, {})
    for what, args, kw in (
            ("ragged S = 200", qkv(4, 200), {}),
            ("S = 130, window 32, softcap 30", qkv(2, 130), dict(
                window=32, softcap=30.0)),
            ("S = 77 f32, head dim 64", qkv(1, 77, torch.float32, 64), {}),
            ("S = 300 bf16, head dim 64", qkv(2, 300, d=64), {})):
        s.compare(f"flash {what}", ops.flash_attention(*args, **kw),
                  ref.flash_attention_ref(*args, **kw))
        if args[0].dtype == torch.bfloat16:
            operands_model(s, f"flash {what}", args, kw)
    def cost(b, sq):                   # causal: sq (sq + 1) / 2 pairs
        return (2 * b * 32 * sq * 128 * 2 + 2 * b * 8 * sq * 128 * 2,
                4 * b * 32 * 128 * sq * (sq + 1) // 2)

    def times(args):
        return (s.time_ms(lambda: ops.flash_attention(*args)),
                s.time_ms(lambda: ref.flash_attention_ref(*args)),
                *cost(args[0].shape[0], args[0].shape[2]),
                s.time_ms(lambda: sdpa(*args, is_causal=True,
                                       enable_gqa=True)))

    ragged = qkv(4, 200)
    s.timings("flash_attention at S = 200", *times(ragged))
    s.record("flash_attention", "flash_attention.cu",
             "src/repro/kernels/flash_attention/flash_attention.py:116", err,
             *times(main))


def flash_p_terms_kernel(terms: int):
    """B2 with ``terms`` bf16 terms of P in place of the kernel's
    ``ref.P_TERMS``: its source with the line that sets them rewritten,
    under ``build/variants/``, bound as a kernel of its own."""
    from repro_torch.core.build import CSRC, CudaKernel
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref
    line = f"constexpr int P_TERMS = {ref.P_TERMS};"
    src = (CSRC / "flash_attention.cu").read_text()
    if src.count(line) != 1:
        raise ValueError(f"flash_attention.cu does not hold {line!r} once")
    path = ROOT / "build" / "variants" / f"flash_attention_p{terms}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src.replace(line, f"constexpr int P_TERMS = {terms};"))
    return CudaKernel(f"flash_attention_p{terms}",
                      os.path.relpath(path, CSRC), fa.KERNEL.symbol,
                      fa.KERNEL.argtypes)


def operands_model(s: Smoke, what, args, kw) -> float:
    """B2's bf16 body against its operand-rounding model: within
    TOL_OPERANDS, and with at most ``ref.MODEL_MISMATCH`` of its bf16
    outputs differing from the model's, a share that the control (B2
    built with one P term fewer, ``s.flash_control``) must exceed, or the
    check could not tell the precision the kernel ships; returns the max
    abs difference."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ops, ref
    got = ops.flash_attention(*args, **kw)
    want = ref.flash_attention_bf16_operands(*args, **kw)
    err = s.compare(f"{what} against the operand-rounding model", got,
                    want, tol_bf16=TOL_OPERANDS)
    shipped, fa.KERNEL = fa.KERNEL, s.flash_control
    try:
        control = ops.flash_attention(*args, **kw)
    finally:
        fa.KERNEL = shipped
    share = ref.model_mismatch(got, want)
    ctl = ref.model_mismatch(control, want)
    s.check(share <= ref.MODEL_MISMATCH < ctl,
            f"{what}: {share:.5f} of the outputs differ from the model "
            f"(<= {ref.MODEL_MISMATCH}); {ctl:.5f} of the control's, with "
            f"{ref.P_TERMS - 1} P term (> {ref.MODEL_MISMATCH})")
    return err


def _decode_operands(s: Smoke, lengths, hq=32, hkv=8, d=128,
                     s_len=CACHE_LEN):
    torch = s.torch
    g = torch.Generator(device=s.dev).manual_seed(3)
    b = len(lengths)
    q = torch.randn(b, hq, d, device=s.dev, generator=g).bfloat16()
    kc, vc = (torch.randn(b, hkv, s_len, d, device=s.dev,
                          generator=g).bfloat16() for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device=s.dev)
    return q, kc, vc, ln


def _decode_cost(lengths, kv_bytes: int = 2, hq=32, hkv=8, d=128):
    """Bytes (q, live K/V rows of ``kv_bytes`` per element, lengths, f32
    residuals) and flops of one-token decode over ``lengths``."""
    live = sum(lengths)
    b = len(lengths)
    nbytes = (b * hq * d * 2 + live * hkv * d * 2 * kv_bytes + b * 4
              + b * hq * d * 4 + 2 * b * hq * 4)
    return nbytes, 4 * hq * d * live


def _normalized(res):
    acc, _, l = res
    return acc / l.clamp_min(1e-30)[..., None]


def _check_splits(s: Smoke, what, kernel, run, plain, served, chunk_of):
    """A split-KV kernel (``kernel``: B3's, B4's, B5's, B6's, B7's or
    B7q's) at the split count it is served with (``served``) and at
    SPLIT_CHECK splits,
    each against
    its split plain version (``plain(chunk_of(n))``, its rounding model),
    its one-split launch (the unsplit kernel's arithmetic) against the
    unsplit plain version (``plain(None)``), m of every launch bit for
    bit (each score is computed alike whatever the split), and each in
    one launch; prints the counts.  ``run(n)`` launches it at ``n``
    splits.  Returns the served launch's residuals."""
    def launch(n):
        before = kernel.launches
        res = run(n)
        s.check(kernel.launches == before + 1,
                f"{what}: {n} split(s) in one launch")
        return res

    one = launch(1)
    s.compare(f"{what}, one split (the control), against the plain "
              f"version", one, plain(None))
    got = one
    for n in sorted({served, SPLIT_CHECK} - {1}):
        res = launch(n)
        s.compare(f"{what}, {n} splits of {chunk_of(n)} rows"
                  f"{' (served)' if n == served else ''}, against the split "
                  f"plain version", res, plain(chunk_of(n)))
        s.check(bool(s.torch.equal(res[1], one[1])),
                f"{what}: m of {n} splits equals m of one split bit for bit")
        if n == served:
            got = res
    print(f"  {what}: served with {served} split(s) of {chunk_of(served)} "
          f"rows")
    return got


def check_split_decode(s: Smoke, what, q, kc, vc, ln, **kw):
    """B3 by :func:`_check_splits`, its count from ``decode_splits``."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ops, ref
    n_rows = kc.shape[2]
    return _check_splits(
        s, what, dk.KERNEL, lambda n: ops.decode_attention(
            q, kc, vc, ln, return_residuals=True, splits=n, **kw),
        lambda chunk: ref.decode_attention_ref(
            q, kc, vc, ln, return_residuals=True, chunk=chunk, **kw),
        dk.decode_splits(n_rows), lambda n: dk.split_chunk(n_rows, n))


def check_split_paged(s: Smoke, what, q, kp, vp, bt, ln, page_size=None,
                      **kw):
    """B4 by :func:`_check_splits`, its count from ``paged_splits`` (the
    table's reach at the logical ``page_size``, by default the pool's)."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ops, paged, ref
    page = page_size or kp.shape[2]
    reach = bt.shape[1] * kp.shape[2]
    return _check_splits(
        s, what, paged.KERNEL, lambda n: ops.paged_decode_attention(
            q, kp, vp, bt, ln, splits=n, page_size=page_size,
            return_residuals=True, **kw),
        lambda chunk: ref.paged_decode_attention_ref(
            q, kp, vp, bt, ln, return_residuals=True, chunk=chunk, **kw),
        dk.paged_splits(reach, page), lambda n: dk.split_chunk(reach, n, page))


def check_split_quant(s: Smoke, what, args, page_size=None, **kw):
    """B5 by :func:`_check_splits` (``args``: q, the int8/fp8 pools,
    their scales, the table and lengths), its count from B4's rule."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ops, quant, ref
    kq, bt = args[1], args[5]
    page = page_size or kq.shape[2]
    reach = bt.shape[1] * kq.shape[2]
    return _check_splits(
        s, what, quant.KERNEL, lambda n: ops.quant_paged_decode_attention(
            *args, splits=n, page_size=page_size, return_residuals=True,
            **kw),
        lambda chunk: ref.quant_paged_decode_attention_ref(
            *args, return_residuals=True, chunk=chunk, **kw),
        dk.paged_splits(reach, page), lambda n: dk.split_chunk(reach, n, page))


def check_split_spec(s: Smoke, what, args, fn, plain, **kw):
    """B6 by :func:`_check_splits` (``fn``/``plain``: the op over bf16
    pools or its quantized twin, and its plain version), its count from
    the table's reach by the speculative rule."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import spec
    pool, bt = args[1], args[-2]
    reach = bt.shape[1] * pool.shape[2]
    page = pool.shape[2]
    return _check_splits(
        s, what, spec.KERNEL, lambda n: fn(*args, splits=n,
                                           return_residuals=True, **kw),
        lambda chunk: plain(*args, return_residuals=True, chunk=chunk, **kw),
        dk.paged_splits(reach, page), lambda n: dk.split_chunk(reach, n, page))


def check_split_window(s: Smoke, what, args, fn, plain, kernel, **kw):
    """B7 or B7q by :func:`_check_splits` (``args``: q, the pools, their
    scales for B7q, the ring tables and lengths; ``fn``/``plain``: the op
    and its plain version), its count from the ring walk's width by B4's
    rule, its chunks counted from the walk's start."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    pool, bt = args[1], args[-2]
    page = pool.shape[2]
    reach = bt.shape[1] * page
    return _check_splits(
        s, what, kernel, lambda n: fn(*args, splits=n, return_residuals=True,
                                      **kw),
        lambda chunk: plain(*args, return_residuals=True, chunk=chunk, **kw),
        dk.paged_splits(reach, page), lambda n: dk.split_chunk(reach, n, page))


def _split_timings(s: Smoke, kernel, what, fn, plain, nbytes, flops,
                   library=None, ops_per_s=BF16_FLOPS_PER_S):
    """A split-KV kernel's time at one split (the control) and at
    SPLIT_CHECK splits beside its record (``fn(splits)`` launches it)."""
    for n in (1, SPLIT_CHECK):
        s.timings(f"{kernel} ({what}, {n} split{'s' * (n > 1)})",
                  s.time_ms(lambda: fn(n)), plain, nbytes, flops, library,
                  ops_per_s)


def check_decode(s: Smoke) -> None:
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    q, kc, vc, ln = _decode_operands(s, DECODE_LENGTHS)
    got = check_split_decode(s, "decode (B 8, 32/8 x 128, lengths "
                                "1..1024)", q, kc, vc, ln)
    want = ref.decode_attention_ref(q, kc, vc, ln, return_residuals=True)
    s.compare("decode residuals (acc, m, l), B = 8, lengths 1..1024",
              got, want)
    err = s.compare("decode output acc / l", _normalized(got),
                    _normalized(want))
    q0, kc0, vc0, ln0 = _decode_operands(s, (0, 5, 1024, 63))
    s.compare("decode with an empty slot, window 100, softcap 30",
              ops.decode_attention(q0, kc0, vc0, ln0, window=100,
                                   softcap=30.0, return_residuals=True),
              ref.decode_attention_ref(q0, kc0, vc0, ln0, window=100,
                                       softcap=30.0, return_residuals=True))
    check_split_decode(s, "decode with an empty slot, window 100, softcap "
                          "30", q0, kc0, vc0, ln0, window=100, softcap=30.0)
    mask = (torch.arange(CACHE_LEN, device=s.dev)[None, :]
            < ln[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    nbytes, flops = _decode_cost(DECODE_LENGTHS)
    plain_ms = s.time_ms(lambda: ref.decode_attention_ref(
        q, kc, vc, ln, return_residuals=True))
    library_ms = s.time_ms(lambda: sdpa(q[:, :, None], kc, vc,
                                        attn_mask=mask, enable_gqa=True))
    s.record("decode_attention", "decode_attention.cu",
             "src/repro/kernels/decode_attention/decode_attention.py:118",
             err, s.time_ms(lambda: ops.decode_attention(
                 q, kc, vc, ln, return_residuals=True)),
             plain_ms, nbytes, flops, library_ms)
    _split_timings(s, "decode_attention", "granite",
                   lambda n: ops.decode_attention(
                       q, kc, vc, ln, return_residuals=True, splits=n),
                   plain_ms, nbytes, flops, library_ms)


def _pages(s: Smoke, kc, vc, lengths, ps):
    """Scatter dense caches into scrambled pages: each slot gets the
    pages its length needs, the rest of its row is the null page 0."""
    torch = s.torch
    b, hkv, sl, _ = kc.shape
    t = sl // ps
    perm = torch.randperm(b * t, generator=torch.Generator().manual_seed(4))
    bt = (perm.reshape(b, t) + 1).to(torch.int32)
    for i, n in enumerate(lengths):
        bt[i, -(-n // ps):] = 0
    bt = bt.to(s.dev)
    pools = []
    for cache in (kc, vc):
        d = cache.shape[-1]
        pool = torch.zeros(hkv, 1 + b * t, ps, d, device=s.dev,
                           dtype=kc.dtype)
        pool[:, bt.long()] = cache.reshape(b, hkv, t, ps, d).transpose(0, 1)
        pools.append(pool)
    return pools[0], pools[1], bt


def check_paged(s: Smoke) -> None:
    from repro_torch.kernels.decode_attention import ops, ref
    q, kc, vc, ln = _decode_operands(s, DECODE_LENGTHS)
    kp, vp, bt = _pages(s, kc, vc, DECODE_LENGTHS, PAGE)
    got = check_split_paged(s, "paged (B 8, 32/8 x 128, page 64)", q, kp,
                            vp, bt, ln)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                          return_residuals=True)
    s.compare("paged residuals, B = 8, page 64, scrambled, null tails",
              got, want)
    err = s.compare("paged output acc / l", _normalized(got),
                    _normalized(want))
    s.compare("paged, logical page 16 of 64",
              ops.paged_decode_attention(q, kp, vp, bt, ln, page_size=16,
                                         return_residuals=True), want)
    check_split_paged(s, "paged, logical page 16 of 64", q, kp, vp, bt, ln,
                      page_size=16)
    q0, kc0, vc0, ln0 = _decode_operands(s, (0, 5, 1024, 63))
    kp0, vp0, bt0 = _pages(s, kc0, vc0, (0, 5, 1024, 63), PAGE)
    s.compare("paged with an empty slot (all-null row), window 100",
              ops.paged_decode_attention(q0, kp0, vp0, bt0, ln0, window=100,
                                         return_residuals=True),
              ref.paged_decode_attention_ref(q0, kp0, vp0, bt0, ln0,
                                             window=100,
                                             return_residuals=True))
    check_split_paged(s, "paged with an empty slot, window 100, softcap 30",
                      q0, kp0, vp0, bt0, ln0, window=100, softcap=30.0)
    nbytes, flops = _decode_cost(DECODE_LENGTHS)
    live_pages = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    plain_ms = s.time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, bt, ln, return_residuals=True))
    s.record("paged_decode_attention", "paged_decode_attention.cu",
             "src/repro/kernels/decode_attention/paged.py:108", err,
             s.time_ms(lambda: ops.paged_decode_attention(
                 q, kp, vp, bt, ln, return_residuals=True)),
             plain_ms, nbytes + 4 * live_pages, flops, None)
    _split_timings(s, "paged_decode_attention", "granite",
                   lambda n: ops.paged_decode_attention(
                       q, kp, vp, bt, ln, return_residuals=True, splits=n),
                   plain_ms, nbytes + 4 * live_pages, flops)


def _quantize(s: Smoke, kp, vp, kv_dtype):
    """(kq, vq, ks, vs): the pools at per-(head, page) absmax in a dtype
    the card must hold (strict: no fall back)."""
    from repro_torch.quant import resolve_kv_spec
    spec = resolve_kv_spec(kv_dtype, s.dev, strict=True)
    kq, ks = spec.quantize_pages(kp)
    vq, vs = spec.quantize_pages(vp)
    return kq, vq, ks, vs


def check_quant_paged(s: Smoke) -> None:
    """B5 on int8 and fp8 pools: by :func:`check_split_quant` at the
    pool's page and a logical page of 16, against its plain version on
    the same quantized bytes (f32 residuals, 1e-4), and against bf16 B4
    on the unquantized data within DECODE_TOL; timed at one split and at
    SPLIT_CHECK beside its served record."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.quant import DECODE_TOL
    q, kc, vc, ln = _decode_operands(s, DECODE_LENGTHS)
    kp, vp, bt = _pages(s, kc, vc, DECODE_LENGTHS, PAGE)
    bf16 = _normalized(ops.paged_decode_attention(q, kp, vp, bt, ln,
                                                  return_residuals=True))
    nbytes, flops = _decode_cost(DECODE_LENGTHS, kv_bytes=1)
    live_pages = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    # scales (K and V, 8 heads, f32) and a table entry per live page
    nbytes += live_pages * (2 * 8 * 4 + 4)
    for kv in ("int8", "fp8_e4m3"):
        kq, vq, ks, vs = _quantize(s, kp, vp, kv)
        args = (q, kq, vq, ks, vs, bt, ln)
        got = check_split_quant(s, f"quant paged {kv} (B 8, 32/8 x 128, "
                                   f"page 64)", args)
        check_split_quant(s, f"quant paged {kv}, logical page 16 of 64",
                          args, page_size=16)
        want = ref.quant_paged_decode_attention_ref(*args,
                                                    return_residuals=True)
        s.compare(f"quant paged {kv} residuals, B = 8, lengths 1..1024",
                  got, want)
        err = s.compare(f"quant paged {kv} output acc / l", _normalized(got),
                        _normalized(want))
        s.compare(f"quant paged {kv}, logical page 16 of 64",
                  ops.quant_paged_decode_attention(*args, page_size=16,
                                                   return_residuals=True),
                  want)
        gap = float((_normalized(got) - bf16).abs().max())
        s.check(gap <= DECODE_TOL[kv],
                f"quant paged {kv} against bf16 paged on the unquantized "
                f"data: max abs diff {gap:.4f} <= DECODE_TOL {DECODE_TOL[kv]}")
        plain_ms = s.time_ms(lambda: ref.quant_paged_decode_attention_ref(
            *args, return_residuals=True))
        times = (s.time_ms(lambda: ops.quant_paged_decode_attention(
                     *args, return_residuals=True)),
                 plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
        if kv == "int8":
            s.record("quant_paged_decode_attention",
                     "quant_paged_decode_attention.cu",
                     "src/repro/kernels/decode_attention/quant.py:27", err,
                     *times)
        else:
            s.timings(f"quant_paged_decode_attention ({kv})", *times)
        _split_timings(s, "quant_paged_decode_attention", f"granite {kv}",
                       lambda n: ops.quant_paged_decode_attention(
                           *args, return_residuals=True, splits=n),
                       plain_ms, nbytes, flops, ops_per_s=INT8_OPS_PER_S)


def check_spec(s: Smoke) -> None:
    """B6 with K1 = SPEC_K + 1 positions per slot, over bf16 pools and
    in its int8 mode: by :func:`check_split_spec`, against its plain
    version (f32 residuals, 1e-4); timed at one split and at SPLIT_CHECK
    beside its served record."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    k1 = SPEC_K + 1
    horizons = [n + k1 for n in SPEC_BASES]
    g = torch.Generator(device=s.dev).manual_seed(5)
    b = len(SPEC_BASES)
    q = torch.randn(b, k1, 32, 128, device=s.dev, generator=g).bfloat16()
    kc, vc = (torch.randn(b, 8, CACHE_LEN, 128, device=s.dev,
                          generator=g).bfloat16() for _ in range(2))
    kp, vp, bt = _pages(s, kc, vc, horizons, PAGE)
    base = torch.tensor(SPEC_BASES, dtype=torch.int32, device=s.dev)
    live = sum(horizons)
    live_pages = sum(-(-n // PAGE) for n in horizons)
    out_bytes = b * k1 * 32 * (128 + 2) * 4
    # every query row scores and weighs the tokens its horizon shows
    flops = 4 * 128 * 32 * sum(n + 1 + i for n in SPEC_BASES
                               for i in range(k1))
    for kv in (None, "int8"):
        if kv is None:
            args = (q, kp, vp, bt, base)
            fn, plain = (ops.spec_paged_decode_attention,
                         ref.spec_paged_decode_attention_ref)
            kv_bytes, scale_bytes, rate = 2, 0, BF16_FLOPS_PER_S
        else:
            kq, vq, ks, vs = _quantize(s, kp, vp, kv)
            args = (q, kq, vq, ks, vs, bt, base)
            fn, plain = (ops.quant_spec_paged_decode_attention,
                         ref.quant_spec_paged_decode_attention_ref)
            kv_bytes, scale_bytes, rate = 1, 2 * 8 * 4, INT8_OPS_PER_S
        what = f"spec K1 = {k1} {kv or 'bf16'}"
        got = check_split_spec(s, f"{what} (B 8, 32/8 x 128, page 64)",
                               args, fn, plain)
        want = plain(*args, return_residuals=True)
        s.compare(f"{what} residuals, B = 8, prefixes 0..{SPEC_BASES[-1]}",
                  got, want)
        err = s.compare(f"{what} output acc / l", _normalized(got),
                        _normalized(want))
        nbytes = (q.numel() * 2 + live * 8 * 128 * 2 * kv_bytes + out_bytes
                  + live_pages * (scale_bytes + 4) + b * k1 * 32 * 4)
        plain_ms = s.time_ms(lambda: plain(*args, return_residuals=True))
        times = (s.time_ms(lambda: fn(*args, return_residuals=True)),
                 plain_ms, nbytes, flops, None, rate)
        if kv is None:
            s.record("spec_paged_decode_attention",
                     "spec_paged_decode_attention.cu",
                     "src/repro/kernels/decode_attention/spec.py:80", err,
                     *times)
        else:
            s.timings(f"spec_paged_decode_attention ({kv})", *times)
        _split_timings(s, "spec_paged_decode_attention", f"granite {what}",
                       lambda n: fn(*args, return_residuals=True, splits=n),
                       plain_ms, nbytes, flops, ops_per_s=rate)


# ------------------------------------------------ gemma2-2b kernels -----

G2 = dict(hq=G2_HQ, hkv=G2_HKV, d=G2_D)


def _ring_pools(s: Smoke, lengths):
    """gemma2's window pools at its decode shapes: (4, 1 + 8 T_w, 64,
    256) bf16 pools and (8, T_w) ring tables, T_w = 65, mapping each
    slot's live window pages to scrambled pages (global page g at
    column g % T_w; null elsewhere)."""
    torch = s.torch
    from repro_torch.serve.paging import live_window_pages, window_table_width
    tw = window_table_width(G2_WINDOW, PAGE)
    b = len(lengths)
    perm = (torch.randperm(b * tw, generator=torch.Generator().manual_seed(6))
            + 1).tolist()
    bt = torch.zeros(b, tw, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for gp in live_window_pages(n, G2_WINDOW, PAGE):
            bt[i, gp % tw] = perm.pop()
    g = torch.Generator(device=s.dev).manual_seed(7)
    kp, vp = (torch.randn(G2_HKV, 1 + b * tw, PAGE, G2_D, device=s.dev,
                          generator=g).bfloat16() for _ in range(2))
    q = torch.randn(b, G2_HQ, G2_D, device=s.dev, generator=g).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=s.dev)
    return q, kp, vp, bt.to(s.dev), ln


def _window_cost(lengths, kv_bytes: int = 2, scale_bytes: int = 0):
    """What the window kernels must read and write: the window's live
    tokens, min(L, window) per slot, a table entry (and the scales) per
    live page, q and the f32 residuals; the flops of those tokens."""
    from repro_torch.serve.paging import live_window_pages
    live = [min(n, G2_WINDOW) for n in lengths]
    nbytes, flops = _decode_cost(live, kv_bytes, **G2)
    pages = sum(len(live_window_pages(n, G2_WINDOW, PAGE)) for n in lengths)
    return nbytes + pages * (4 + scale_bytes), flops


def check_window(s: Smoke) -> None:
    """B7 over bf16 pools and B7q over int8 and fp8 pools, at gemma2's
    shapes: by :func:`check_split_window`, against their plain versions
    (f32 residuals, 1e-4), at the physical page and a logical page of 16;
    B7q against bf16 B7 on the unquantized data within DECODE_TOL; timed
    at one split and at SPLIT_CHECK beside their served records."""
    from repro_torch.kernels.decode_attention import ops, paged, ref
    from repro_torch.quant import DECODE_TOL
    q, kp, vp, bt, ln = _ring_pools(s, G2_LENGTHS)
    kw = dict(window=G2_WINDOW, softcap=G2_SOFTCAP)
    got = check_split_window(
        s, "window (B 8, 8/4 x 256, window 4096, lengths 1..8192)",
        (q, kp, vp, bt, ln), ops.window_paged_decode_attention,
        ref.window_paged_decode_attention_ref, paged.WINDOW_KERNEL, **kw)
    want = ref.window_paged_decode_attention_ref(q, kp, vp, bt, ln,
                                                 return_residuals=True, **kw)
    s.compare("window residuals, B = 8, 8/4 heads of 256, window 4096, "
              "lengths 1..8192, rings wrapped", got, want)
    err = s.compare("window output acc / l", _normalized(got),
                    _normalized(want))
    s.compare("window, logical page 16 of 64",
              ops.window_paged_decode_attention(
                  q, kp, vp, bt, ln, page_size=16, return_residuals=True,
                  **kw), want)
    bf16 = _normalized(got)
    nbytes, flops = _window_cost(G2_LENGTHS)
    plain_ms = s.time_ms(lambda: ref.window_paged_decode_attention_ref(
        q, kp, vp, bt, ln, return_residuals=True, **kw))
    s.record("window_paged_decode_attention",
             "window_paged_decode_attention.cu",
             "src/repro/kernels/decode_attention/paged.py:258", err,
             s.time_ms(lambda: ops.window_paged_decode_attention(
                 q, kp, vp, bt, ln, return_residuals=True, **kw)),
             plain_ms, nbytes, flops, None)
    _split_timings(s, "window_paged_decode_attention", "gemma2",
                   lambda n: ops.window_paged_decode_attention(
                       q, kp, vp, bt, ln, return_residuals=True, splits=n,
                       **kw),
                   plain_ms, nbytes, flops)
    nbytes, flops = _window_cost(G2_LENGTHS, 1, 2 * G2_HKV * 4)
    for kv in ("int8", "fp8_e4m3"):
        kq, vq, ks, vs = _quantize(s, kp, vp, kv)
        args = (q, kq, vq, ks, vs, bt, ln)
        got = check_split_window(
            s, f"quant window {kv}", args,
            ops.quant_window_paged_decode_attention,
            ref.quant_window_paged_decode_attention_ref,
            paged.QUANT_WINDOW_KERNEL, **kw)
        want = ref.quant_window_paged_decode_attention_ref(
            *args, return_residuals=True, **kw)
        s.compare(f"quant window {kv} residuals", got, want)
        err = s.compare(f"quant window {kv} output acc / l",
                        _normalized(got), _normalized(want))
        s.compare(f"quant window {kv}, logical page 16 of 64",
                  ops.quant_window_paged_decode_attention(
                      *args, page_size=16, return_residuals=True, **kw),
                  want)
        gap = float((_normalized(got) - bf16).abs().max())
        s.check(gap <= DECODE_TOL[kv],
                f"quant window {kv} against bf16 window on the unquantized "
                f"data: max abs diff {gap:.4f} <= DECODE_TOL {DECODE_TOL[kv]}")
        plain_ms = s.time_ms(
            lambda: ref.quant_window_paged_decode_attention_ref(
                *args, return_residuals=True, **kw))
        times = (s.time_ms(lambda: ops.quant_window_paged_decode_attention(
                     *args, return_residuals=True, **kw)),
                 plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
        if kv == "int8":
            s.record("quant_window_paged_decode_attention",
                     "quant_window_paged_decode_attention.cu",
                     "src/repro/kernels/decode_attention/quant.py:47", err,
                     *times)
        else:
            s.timings(f"quant_window_paged_decode_attention ({kv})", *times)
        _split_timings(s, "quant_window_paged_decode_attention",
                       f"gemma2 {kv}",
                       lambda n: ops.quant_window_paged_decode_attention(
                           *args, return_residuals=True, splits=n, **kw),
                       plain_ms, nbytes, flops, ops_per_s=INT8_OPS_PER_S)


def check_head_dim_256(s: Smoke) -> None:
    """The head-dim-256 builds of B1's width, B2, B3, B4 and B5 at
    gemma2's shapes, against their plain versions; their times go into
    each kernel's record under "gemma2"."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    g = torch.Generator(device=s.dev).manual_seed(8)
    # B1 at d_model 2304 = 9 x 256: a prefill of 3 x 6000 rows
    rows, dm = 3 * G2_FLASH_S, 2304
    x = torch.randn(rows, dm, device=s.dev, generator=g).bfloat16()
    w = (0.1 * torch.randn(dm, device=s.dev, generator=g)).bfloat16()
    kw = dict(eps=1e-6, weight_offset=1.0)
    err = s.compare(f"rmsnorm ({rows}, {dm}) bf16", rops.rmsnorm(x, w, **kw),
                    rref.rmsnorm_ref(x, w, **kw))
    s.record_also("rmsnorm", "gemma2", err,
                  s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
                  s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
                  2 * x.numel() * 2 + 2 * dm, 4 * x.numel(),
                  s.time_ms(lambda: torch.nn.functional.rms_norm(
                      x, (dm,), w + 1.0, 1e-6)))

    # B2: B 3 x S 6000, 8/4 heads of 256, softcap 50; local layers also
    # take the window.  Checked at B 1 (the plain version holds S x S
    # scores), timed at B 3.
    def qkv(b):
        return tuple(torch.randn(b, h, G2_FLASH_S, G2_D, device=s.dev,
                                 generator=g).bfloat16()
                     for h in (G2_HQ, G2_HKV, G2_HKV))

    one, err = qkv(1), 0.0
    for what, window in (("global", None), ("local", G2_WINDOW)):
        kw = dict(window=window, softcap=G2_SOFTCAP)
        what = f"flash (1, 8/4, {G2_FLASH_S}, 256) causal, softcap 50, {what}"
        err = max(err, s.compare(what, fops.flash_attention(*one, **kw),
                                 fref.flash_attention_ref(*one, **kw)))
        operands_model(s, what, one, kw)
    three = qkv(3)
    kw = dict(window=G2_WINDOW, softcap=G2_SOFTCAP)
    n = G2_FLASH_S
    pairs = sum(min(i + 1, G2_WINDOW) for i in range(n))
    cost = (2 * 3 * G2_HQ * n * G2_D * 2 + 2 * 3 * G2_HKV * n * G2_D * 2,
            4 * 3 * G2_HQ * G2_D * pairs)
    s.record_also("flash_attention", "gemma2", err,
                  s.time_ms(lambda: fops.flash_attention(*three, **kw)),
                  s.time_ms(lambda: fref.flash_attention_ref(*three, **kw)),
                  *cost, None)
    # the softcap's share: the same launch without it (its 3 x 8 x pairs
    # accurate tanhf run on the FMA pipe)
    s.timings("flash_attention (gemma2 without the softcap)",
              s.time_ms(lambda: fops.flash_attention(
                  *three, window=G2_WINDOW)),
              s.time_ms(lambda: fref.flash_attention_ref(
                  *three, window=G2_WINDOW)), *cost, None)

    # B3 (dense, and the ring of a local layer) and B4 over cache 8192
    q, kc, vc, ln = _decode_operands(s, G2_LENGTHS, s_len=G2_CACHE_LEN,
                                     **G2)
    kw = dict(softcap=G2_SOFTCAP)
    want = ref.decode_attention_ref(q, kc, vc, ln, return_residuals=True,
                                    **kw)
    got = check_split_decode(s, "decode (B 8, 8/4 x 256, cache 8192, "
                                "softcap 50)", q, kc, vc, ln, **kw)
    s.compare("decode residuals, 8/4 heads of 256, cache 8192", got, want)
    err = s.compare("decode output acc / l", _normalized(got),
                    _normalized(want))
    ring_ln = ln.clamp(max=G2_WINDOW)
    ring = (kc[:, :, :G2_WINDOW].contiguous(),
            vc[:, :, :G2_WINDOW].contiguous())
    s.compare("decode over a ring of 4096 (no window mask)",
              ops.decode_attention(q, *ring, ring_ln, return_residuals=True,
                                   **kw),
              ref.decode_attention_ref(q, *ring, ring_ln,
                                       return_residuals=True, **kw))
    check_split_decode(s, "decode over a ring of 4096", q, *ring, ring_ln,
                       **kw)
    check_split_decode(s, "decode, cache 8192, window 4096 (early splits "
                          "empty)", q, kc, vc, ln, window=G2_WINDOW, **kw)
    nbytes, flops = _decode_cost(G2_LENGTHS, **G2)
    plain_ms = s.time_ms(lambda: ref.decode_attention_ref(
        q, kc, vc, ln, return_residuals=True, **kw))
    s.record_also("decode_attention", "gemma2", err,
                  s.time_ms(lambda: ops.decode_attention(
                      q, kc, vc, ln, return_residuals=True, **kw)),
                  plain_ms, nbytes, flops, None)
    _split_timings(s, "decode_attention", "gemma2",
                   lambda n: ops.decode_attention(
                       q, kc, vc, ln, return_residuals=True, splits=n, **kw),
                   plain_ms, nbytes, flops, None)
    kp, vp, bt = _pages(s, kc, vc, G2_LENGTHS, PAGE)
    got = check_split_paged(s, "paged (B 8, 8/4 x 256, table (8, 128), "
                               "softcap 50)", q, kp, vp, bt, ln, **kw)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln,
                                          return_residuals=True, **kw)
    s.compare("paged residuals, 8/4 heads of 256, table (8, 128)", got,
              want)
    err = s.compare("paged output acc / l", _normalized(got),
                    _normalized(want))
    live_pages = sum(-(-n // PAGE) for n in G2_LENGTHS)
    # every slot at 6,032 tokens, the longest in serving: 95 blocks a
    # slot, 24 of the 32 splits of 256 rows live
    ln95 = torch.full_like(ln, 6032)
    s.timings("paged_decode_attention (gemma2, every slot at 6032: 95 "
              "blocks a slot)",
              s.time_ms(lambda: ops.paged_decode_attention(
                  q, kp, vp, bt, ln95, return_residuals=True, **kw)),
              s.time_ms(lambda: ref.paged_decode_attention_ref(
                  q, kp, vp, bt, ln95, return_residuals=True, **kw)),
              *_decode_cost([6032] * len(G2_LENGTHS), **G2), None)
    plain_ms = s.time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, bt, ln, return_residuals=True, **kw))
    s.record_also("paged_decode_attention", "gemma2", err,
                  s.time_ms(lambda: ops.paged_decode_attention(
                      q, kp, vp, bt, ln, return_residuals=True, **kw)),
                  plain_ms, nbytes + 4 * live_pages, flops, None)
    _split_timings(s, "paged_decode_attention", "gemma2",
                   lambda n: ops.paged_decode_attention(
                       q, kp, vp, bt, ln, return_residuals=True, splits=n,
                       **kw),
                   plain_ms, nbytes + 4 * live_pages, flops)
    # B5 over the same pages, int8 and fp8
    nbytes, flops = _decode_cost(G2_LENGTHS, 1, **G2)
    nbytes += live_pages * (2 * G2_HKV * 4 + 4)
    for kv in ("int8", "fp8_e4m3"):
        kq, vq, ks, vs = _quantize(s, kp, vp, kv)
        args = (q, kq, vq, ks, vs, bt, ln)
        got = check_split_quant(s, f"quant paged {kv} (B 8, 8/4 x 256, "
                                   f"table (8, 128), softcap 50)", args, **kw)
        want = ref.quant_paged_decode_attention_ref(
            *args, return_residuals=True, **kw)
        s.compare(f"quant paged {kv} residuals, heads of 256", got, want)
        err = s.compare(f"quant paged {kv} output acc / l, heads of 256",
                        _normalized(got), _normalized(want))
        plain_ms = s.time_ms(lambda: ref.quant_paged_decode_attention_ref(
            *args, return_residuals=True, **kw))
        times = (s.time_ms(lambda: ops.quant_paged_decode_attention(
                     *args, return_residuals=True, **kw)),
                 plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
        if kv == "int8":
            s.record_also("quant_paged_decode_attention", "gemma2", err,
                          *times)
        else:
            s.timings(f"quant_paged_decode_attention ({kv}, gemma2)", *times)
        _split_timings(s, "quant_paged_decode_attention", f"gemma2 {kv}",
                       lambda n: ops.quant_paged_decode_attention(
                           *args, return_residuals=True, splits=n, **kw),
                       plain_ms, nbytes, flops, ops_per_s=INT8_OPS_PER_S)


# ------------------------------------------- deepseek-v2-lite kernels -----

def check_gmm(s: Smoke) -> None:
    """B8 against its plain version: the reference's registry example
    (E 4, C 64, K = N = 128, rows masked by sizes 0, 21, 42, 63) and
    sizes of 0 and C, in f32 and bf16; then bf16 at deepseek's decode
    shape (C 8 at 8 slots, masked sizes too) and its largest prefill
    shape (C 184 for 3 x 511 tokens), timed beside ``torch.bmm``."""
    torch = s.torch
    from repro_torch.kernels.gmm import ops, ref
    from repro_torch.models.moe import _capacity
    g = torch.Generator(device=s.dev).manual_seed(9)

    def operands(e, c, k, n, dt=torch.bfloat16):
        return (torch.randn(e, c, k, device=s.dev, generator=g).to(dt),
                torch.randn(e, k, n, device=s.dev, generator=g).to(dt))

    for dt in (torch.float32, torch.bfloat16):
        lhs, rhs = operands(4, 64, 128, 128, dt)
        for what, vals in (("sizes 0, 21, 42, 63", [0, 21, 42, 63]),
                           ("sizes 0 and C", [0, 64, 0, 64])):
            gs = torch.tensor(vals, dtype=torch.int32, device=s.dev)
            out = ops.gmm(lhs, rhs, gs)
            s.compare(f"gmm (4, 64, 128) @ (4, 128, 128) {dt}, {what}", out,
                      ref.gmm_ref(lhs, rhs, gs))
            s.check(all(not out[i, n:].any() for i, n in enumerate(vals)),
                    f"gmm {dt}, {what}: rows at or past each size are 0")
    c_dec = _capacity(SLOTS, DS_E, DS_TOPK, 1.25)
    c_pre = _capacity(3 * PROMPT_LENS[-1], DS_E, DS_TOPK, 1.25)
    print(f"  capacity: {c_dec} rows per expert at decode ({SLOTS} slots), "
          f"{c_pre} at the largest prefill (3 x {PROMPT_LENS[-1]} tokens)")

    def run(c, k, n, what):
        lhs, rhs = operands(DS_E, c, k, n)
        gs = torch.full((DS_E,), c, dtype=torch.int32, device=s.dev)
        err = s.compare(f"gmm {what} ({DS_E}, {c}, {k}) @ ({DS_E}, {k}, "
                        f"{n}) bf16", ops.gmm(lhs, rhs, gs),
                        ref.gmm_ref(lhs, rhs, gs))
        if c <= 8:
            masked = torch.randint(0, c + 1, (DS_E,), generator=g,
                                   device=s.dev, dtype=torch.int32)
            s.compare(f"gmm {what}, sizes 0..{c}",
                      ops.gmm(lhs, rhs, masked),
                      ref.gmm_ref(lhs, rhs, masked))
        nbytes = 2 * (lhs.numel() + rhs.numel() + DS_E * c * n) + 4 * DS_E
        return err, (s.time_ms(lambda: ops.gmm(lhs, rhs, gs)),
                     s.time_ms(lambda: ref.gmm_ref(lhs, rhs, gs)),
                     nbytes, 2 * DS_E * c * k * n,
                     s.time_ms(lambda: torch.bmm(lhs, rhs)))

    err, times = run(c_dec, DS_D, DS_FF, "decode gate/up")
    s.record("gmm", "gmm.cu", "src/repro/kernels/gmm/gmm.py:47", err, *times)
    _, times = run(c_dec, DS_FF, DS_D, "decode down")
    s.timings("gmm (decode down projection)", *times)
    err, times = run(c_pre, DS_D, DS_FF, "prefill gate/up")
    s.record_also("gmm", "prefill", err, *times)


def check_mla_builds(s: Smoke) -> None:
    """The Dk 192 / Dv 128 builds of B2, B3 and B4 at deepseek's
    serving shapes (16 query heads on 16 kv heads), against their plain
    versions; their times go into each kernel's record under
    "deepseek"."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=s.dev).manual_seed(10)
    scale = DS_DK ** -0.5

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g).bfloat16()

    # B2: the largest prefill group, 3 prompts of 511 tokens
    b, n = 3, PROMPT_LENS[-1]
    q, k, v = rnd(b, DS_H, n, DS_DK), rnd(b, DS_H, n, DS_DK), \
        rnd(b, DS_H, n, DS_DV)
    err = s.compare(f"flash ({b}, 16/16, {n}, 192/128) causal bf16",
                    fops.flash_attention(q, k, v, scale=scale),
                    fref.flash_attention_ref(q, k, v, scale=scale))
    operands_model(s, f"flash ({b}, 16/16, {n}, 192/128) causal bf16",
                   (q, k, v), dict(scale=scale))
    pairs = n * (n + 1) // 2
    s.record_also("flash_attention", "deepseek", err,
                  s.time_ms(lambda: fops.flash_attention(q, k, v,
                                                         scale=scale)),
                  s.time_ms(lambda: fref.flash_attention_ref(q, k, v,
                                                             scale=scale)),
                  2 * (q.numel() + k.numel() + 2 * v.numel()),
                  2 * b * DS_H * pairs * (DS_DK + DS_DV),
                  s.time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                         scale=scale)))
    del q, k, v
    # B3 and B4: 8 slots, lengths 1..1024 over a cache of 1024
    qd = rnd(SLOTS, DS_H, DS_DK)
    kc, vc = rnd(SLOTS, DS_H, CACHE_LEN, DS_DK), \
        rnd(SLOTS, DS_H, CACHE_LEN, DS_DV)
    ln = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=s.dev)
    kw = dict(scale=scale, return_residuals=True)
    got = check_split_decode(s, "decode (B 8, 16/16 x 192/128, lengths "
                                "1..1024)", qd, kc, vc, ln, scale=scale)
    want = ref.decode_attention_ref(qd, kc, vc, ln, **kw)
    s.compare("decode residuals, 16/16 heads of 192/128, lengths 1..1024",
              got, want)
    err = s.compare("decode 192/128 output acc / l", _normalized(got),
                    _normalized(want))
    live = sum(DECODE_LENGTHS)
    nbytes = (qd.numel() * 2 + live * DS_H * (DS_DK + DS_DV) * 2
              + 4 * SLOTS + SLOTS * DS_H * (DS_DV + 2) * 4)
    flops = 2 * DS_H * (DS_DK + DS_DV) * live
    mask = (torch.arange(CACHE_LEN, device=s.dev)[None, :]
            < ln[:, None])[:, None, None, :]
    plain_ms = s.time_ms(lambda: ref.decode_attention_ref(qd, kc, vc, ln,
                                                          **kw))
    library_ms = s.time_ms(lambda: sdpa(qd[:, :, None], kc, vc,
                                        attn_mask=mask, scale=scale))
    s.record_also("decode_attention", "deepseek", err,
                  s.time_ms(lambda: ops.decode_attention(qd, kc, vc, ln,
                                                         **kw)),
                  plain_ms, nbytes, flops, library_ms)
    _split_timings(s, "decode_attention", "deepseek",
                   lambda n: ops.decode_attention(
                       qd, kc, vc, ln, splits=n, **kw),
                   plain_ms, nbytes, flops, library_ms)
    kp, vp, bt = _pages(s, kc, vc, DECODE_LENGTHS, PAGE)
    got = check_split_paged(s, "paged (B 8, 16/16 x 192/128, page 64)", qd,
                            kp, vp, bt, ln, scale=scale)
    want = ref.paged_decode_attention_ref(qd, kp, vp, bt, ln, **kw)
    s.compare("paged residuals, 16/16 heads of 192/128, page 64", got, want)
    err = s.compare("paged 192/128 output acc / l", _normalized(got),
                    _normalized(want))
    s.compare("paged 192/128, logical page 16 of 64",
              ops.paged_decode_attention(qd, kp, vp, bt, ln, page_size=16,
                                         **kw), want)
    live_pages = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    plain_ms = s.time_ms(lambda: ref.paged_decode_attention_ref(
        qd, kp, vp, bt, ln, **kw))
    s.record_also("paged_decode_attention", "deepseek", err,
                  s.time_ms(lambda: ops.paged_decode_attention(
                      qd, kp, vp, bt, ln, **kw)),
                  plain_ms, nbytes + 4 * live_pages, flops, None)
    _split_timings(s, "paged_decode_attention", "deepseek",
                   lambda n: ops.paged_decode_attention(
                       qd, kp, vp, bt, ln, splits=n, **kw),
                   plain_ms, nbytes + 4 * live_pages, flops)


# ------------------------------------------- jamba-1.5-large kernels -----

def check_mamba_scan(s: Smoke) -> None:
    """B9 against its plain version, y and h_T: the reference's registry
    example (B 2, S 64, d 32, 8 states, f32) and jamba's shapes (B 1 and
    2 x S 17, 64, 200 and 511, d_inner 16384, 16 states; x, dt, B and C
    in bf16, A and D in f32, as the mamba layer hands them over); timed
    at the largest prefill group, B 2 x S 511.  No PyTorch call computes
    a selective scan: no library time."""
    torch = s.torch
    from repro_torch.kernels.mamba_scan import ops, ref
    softplus = torch.nn.functional.softplus
    g = torch.Generator(device=s.dev).manual_seed(11)

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g)

    b, n, d, n_st = 2, 64, 32, 8
    args = (rnd(b, n, d), softplus(rnd(b, n, d)),
            -torch.exp(0.5 * rnd(d, n_st)), rnd(b, n, n_st), rnd(b, n, n_st),
            rnd(d))
    s.compare(f"mamba_scan ({b}, {n}, {d}), {n_st} states, f32 (y, h_T)",
              ops.mamba_scan(*args), ref.mamba_scan_ref(*args))
    # jamba's A is S4D-real (-1 .. -16 per channel) and its dt small
    a = -torch.arange(1, JB_N + 1, dtype=torch.float32,
                      device=s.dev).expand(JB_DI, JB_N).contiguous()

    def operands(b, n):
        return (rnd(b, n, JB_DI).bfloat16(),
                softplus(rnd(b, n, JB_DI) - 2.0).bfloat16(), a,
                rnd(b, n, JB_N).bfloat16(), rnd(b, n, JB_N).bfloat16(),
                rnd(JB_DI))

    err = 0.0
    for b in (1, 2):
        for n in JB_SCAN_LENS:
            args = operands(b, n)
            err = max(err, s.compare(
                f"mamba_scan ({b}, {n}, {JB_DI}), {JB_N} states, bf16 x/dt/"
                f"B/C, f32 A/D (y, h_T)", ops.mamba_scan(*args),
                ref.mamba_scan_ref(*args)))
    b, n = 2, PROMPT_LENS[-1]
    args = operands(b, n)
    # x, dt and y in bf16, B and C rows, A, D and h_T in f32; one exp per
    # (token, channel, state)
    nbytes = (3 * b * n * JB_DI * 2 + 2 * b * n * JB_N * 2
              + (JB_DI * JB_N + JB_DI + b * JB_DI * JB_N) * 4)
    s.record("mamba_scan", "mamba_scan.cu",
             "src/repro/kernels/mamba_scan/mamba_scan.py:52", err,
             s.time_ms(lambda: ops.mamba_scan(*args)),
             s.time_ms(lambda: ref.mamba_scan_ref(*args)), nbytes,
             b * n * JB_DI * JB_N, None, EXP_PER_S, unit="G exp")


def check_jamba_shapes(s: Smoke) -> None:
    """B1, B2, B3 and B4 at jamba's shapes (d_model 8192; 64 query heads
    on 8 KV heads of 128, a GQA group of 8) and B8 at its expert shapes
    (16 experts of 8192 x 24576: 6.4 GB of weights per call), against
    their plain versions; their times go into each kernel's record
    under "jamba"."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.gmm import ops as gops
    from repro_torch.kernels.gmm import ref as gref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.models.moe import _capacity
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=s.dev).manual_seed(12)

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g,
                           dtype=torch.bfloat16)

    # B1: the largest prefill group, 2 x 511 rows of 8192
    b, n = 2, PROMPT_LENS[-1]
    x, w = rnd(b * n, JB_DM), 0.1 * rnd(JB_DM)
    kw = dict(eps=1e-6, weight_offset=1.0)
    err = s.compare(f"rmsnorm ({b * n}, {JB_DM}) bf16",
                    rops.rmsnorm(x, w, **kw), rref.rmsnorm_ref(x, w, **kw))
    s.record_also("rmsnorm", "jamba", err,
                  s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
                  s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
                  2 * x.numel() * 2 + 2 * JB_DM, 4 * x.numel(),
                  s.time_ms(lambda: torch.nn.functional.rms_norm(
                      x, (JB_DM,), w + 1.0, 1e-6)))
    # B2: B 2 x S 511, 64/8 heads of 128, causal
    q, k, v = rnd(b, JB_HQ, n, 128), rnd(b, JB_HKV, n, 128), \
        rnd(b, JB_HKV, n, 128)
    err = s.compare(f"flash ({b}, {JB_HQ}/{JB_HKV}, {n}, 128) causal bf16",
                    fops.flash_attention(q, k, v),
                    fref.flash_attention_ref(q, k, v))
    operands_model(s, f"flash ({b}, {JB_HQ}/{JB_HKV}, {n}, 128) causal bf16",
                   (q, k, v), {})
    s.record_also("flash_attention", "jamba", err,
                  s.time_ms(lambda: fops.flash_attention(q, k, v)),
                  s.time_ms(lambda: fref.flash_attention_ref(q, k, v)),
                  2 * (q.numel() + 2 * k.numel() + q.numel()),
                  4 * b * JB_HQ * 128 * n * (n + 1) // 2,
                  s.time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                         enable_gqa=True)))
    del q, k, v
    # B3 and B4: 8 slots, lengths 1..1024, a group of 8
    heads = dict(hq=JB_HQ, hkv=JB_HKV, d=128)
    qd, kc, vc, ln = _decode_operands(s, DECODE_LENGTHS, **heads)
    dkw = dict(return_residuals=True)
    got = check_split_decode(s, "decode (B 8, 64/8 x 128, lengths "
                                "1..1024)", qd, kc, vc, ln)
    want = ref.decode_attention_ref(qd, kc, vc, ln, **dkw)
    s.compare("decode residuals, 64/8 heads of 128, lengths 1..1024", got,
              want)
    err = s.compare("decode group 8 output acc / l", _normalized(got),
                    _normalized(want))
    nbytes, flops = _decode_cost(DECODE_LENGTHS, **heads)
    mask = (torch.arange(CACHE_LEN, device=s.dev)[None, :]
            < ln[:, None])[:, None, None, :]
    plain_ms = s.time_ms(lambda: ref.decode_attention_ref(qd, kc, vc, ln,
                                                          **dkw))
    library_ms = s.time_ms(lambda: sdpa(qd[:, :, None], kc, vc,
                                        attn_mask=mask, enable_gqa=True))
    s.record_also("decode_attention", "jamba", err,
                  s.time_ms(lambda: ops.decode_attention(qd, kc, vc, ln,
                                                         **dkw)),
                  plain_ms, nbytes, flops, library_ms)
    _split_timings(s, "decode_attention", "jamba",
                   lambda n: ops.decode_attention(
                       qd, kc, vc, ln, splits=n, **dkw),
                   plain_ms, nbytes, flops, library_ms)
    kp, vp, bt = _pages(s, kc, vc, DECODE_LENGTHS, PAGE)
    got = check_split_paged(s, "paged (B 8, 64/8 x 128, page 64)", qd, kp,
                            vp, bt, ln)
    want = ref.paged_decode_attention_ref(qd, kp, vp, bt, ln, **dkw)
    s.compare("paged residuals, 64/8 heads of 128, page 64", got, want)
    err = s.compare("paged group 8 output acc / l", _normalized(got),
                    _normalized(want))
    live_pages = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    plain_ms = s.time_ms(lambda: ref.paged_decode_attention_ref(
        qd, kp, vp, bt, ln, **dkw))
    s.record_also("paged_decode_attention", "jamba", err,
                  s.time_ms(lambda: ops.paged_decode_attention(
                      qd, kp, vp, bt, ln, **dkw)),
                  plain_ms, nbytes + 4 * live_pages, flops, None)
    _split_timings(s, "paged_decode_attention", "jamba",
                   lambda n: ops.paged_decode_attention(
                       qd, kp, vp, bt, ln, splits=n, **dkw),
                   plain_ms, nbytes + 4 * live_pages, flops)
    del qd, kc, vc, kp, vp
    # B8: decode (C 8 at 8 slots) gate/up and down, and the largest
    # prefill group's gate/up (C 160 for 2 x 511 tokens)
    c_dec = _capacity(SLOTS, JB_E, JB_TOPK, 1.25)
    c_pre = _capacity(b * n, JB_E, JB_TOPK, 1.25)
    print(f"  capacity: {c_dec} rows per expert at decode ({SLOTS} slots), "
          f"{c_pre} at the largest prefill ({b} x {n} tokens)")

    def run(c, kk, nn, what):
        lhs, rhs = rnd(JB_E, c, kk), rnd(JB_E, kk, nn)
        gs = torch.full((JB_E,), c, dtype=torch.int32, device=s.dev)
        err = s.compare(f"gmm {what} ({JB_E}, {c}, {kk}) @ ({JB_E}, {kk}, "
                        f"{nn}) bf16", gops.gmm(lhs, rhs, gs),
                        gref.gmm_ref(lhs, rhs, gs))
        nbytes = 2 * (lhs.numel() + rhs.numel() + JB_E * c * nn) + 4 * JB_E
        return err, (s.time_ms(lambda: gops.gmm(lhs, rhs, gs)),
                     s.time_ms(lambda: gref.gmm_ref(lhs, rhs, gs)),
                     nbytes, 2 * JB_E * c * kk * nn,
                     s.time_ms(lambda: torch.bmm(lhs, rhs)))

    err, times = run(c_dec, JB_DM, JB_FF, "jamba decode gate/up")
    s.record_also("gmm", "jamba", err, *times)
    _, times = run(c_dec, JB_FF, JB_DM, "jamba decode down")
    s.timings("gmm (jamba decode down projection)", *times)
    err, times = run(c_pre, JB_DM, JB_FF, "jamba prefill gate/up")
    s.record_also("gmm", "jamba prefill", err, *times)


# ------------------------------------------------- xlstm-1.3b kernels -----

def _with_state(res):
    """(h, (C, n, m)) -> (h, C, n, m)."""
    h, state = res
    return (h,) + tuple(state)


def check_mlstm_scan(s: Smoke) -> None:
    """B10 against its plain versions, h and the final state (C, n, m):
    the reference's registry example (B 1, 2 heads, S 64, Dk = Dv = 32,
    f32 and bf16) and xlstm-1.3b's shapes (B 1 and 2 x S 1, 17, 64, 200
    and 511, 4 heads of Dk = Dv = 1024; q, k and v in bf16 and the gates
    in f32, as the mLSTM layer hands them over; S 200 in f32 too), each
    against the recurrent plain version at the op's tolerance (2e-4; bf16
    h at 2e-2) and against the plain version of the body that ran (the
    chunkwise form at the bf16 body's chunk, the recurrence for f32) more
    tightly (``XL_CHUNK_TOL``; bf16 h at one bf16 rounding, 1e-2); timed
    with its state output at the largest prefill group, B 2 x S 511.
    No PyTorch call computes an mLSTM recurrence: no library time.  Also
    B1 at the mLSTM head norm's shape, 2 x 511 rows of 4096, into its
    record under "xlstm"."""
    torch = s.torch
    from repro_torch.kernels.mlstm_scan import mlstm_scan as kern
    from repro_torch.kernels.mlstm_scan import ops, ref
    g = torch.Generator(device=s.dev).manual_seed(13)

    def operands(b, n, h, d, dt):
        def rnd(*shape):
            return torch.randn(*shape, device=s.dev, generator=g)
        q, k, v = (rnd(b, h, n, d).to(dt) for _ in range(3))
        return q, k, v, rnd(b, h, n), rnd(b, h, n) + 2.0

    def both(what, args):
        got = _with_state(ops.mlstm_scan(*args, return_state=True))
        err = s.compare(what, got, _with_state(
            ref.mlstm_scan_ref(*args, return_state=True)), tol_f32=XL_TOL)
        s.compare(f"{what} against its body's plain version", got,
                  _with_state(ref.mlstm_scan_ref(
                      *args, return_state=True,
                      chunk=kern.plain_chunk(args[0].dtype))),
                  tol_f32=XL_CHUNK_TOL, tol_bf16=1e-2)
        return err

    for dt in (torch.float32, torch.bfloat16):
        both(f"mlstm_scan (1, 2, 64, 32), {str(dt)[6:]} (h, C, n, m)",
             operands(1, 64, 2, 32, dt))
    both(f"mlstm_scan (1, {XL_H}, 200, {XL_D}), f32 (h, C, n, m)",
         operands(1, 200, XL_H, XL_D, torch.float32))
    err = 0.0
    for b in (1, 2):
        for n in XL_SCAN_LENS:
            err = max(err, both(
                f"mlstm_scan ({b}, {XL_H}, {n}, {XL_D}), bf16 q/k/v, f32 "
                f"gates (h, C, n, m)", operands(b, n, XL_H, XL_D,
                                                torch.bfloat16)))
    b, n = 2, PROMPT_LENS[-1]
    # B1 at the mLSTM head norm of the largest prefill group: 2 x 511
    # rows of d_inner 4096
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    x = torch.randn(b * n, XL_H * XL_D, device=s.dev,
                    generator=g).bfloat16()
    w = (0.1 * torch.randn(XL_H * XL_D, device=s.dev, generator=g)).bfloat16()
    kw = dict(eps=1e-6, weight_offset=1.0)
    s.record_also("rmsnorm", "xlstm", s.compare(
        f"rmsnorm ({b * n}, {XL_H * XL_D}) bf16", rops.rmsnorm(x, w, **kw),
        rref.rmsnorm_ref(x, w, **kw)),
        s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
        s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
        2 * x.numel() * 2 + 2 * w.numel(), 4 * x.numel(),
        s.time_ms(lambda: torch.nn.functional.rms_norm(
            x, (x.shape[1],), w + 1.0, 1e-6)))
    args = operands(b, n, XL_H, XL_D, torch.bfloat16)
    bh = b * XL_H
    # q, k, v and h in bf16, the two f32 gates, the f32 state (C, n, m)
    # written once; the function's products on the tensor cores, Q C and
    # the state's update K^T (w V), 4 S Dk Dv flops a head (the scores
    # and (D o S) V add 2 S L (Dk + Dv), under 4% at L = 32)
    nbytes = (4 * bh * n * XL_D * 2 + 2 * bh * n * 4
              + bh * (XL_D * XL_D + XL_D + 1) * 4)
    s.record("mlstm_scan", "mlstm_scan.cu",
             "src/repro/kernels/mlstm_scan/mlstm_scan.py:58", err,
             s.time_ms(lambda: ops.mlstm_scan(*args, return_state=True)),
             s.time_ms(lambda: ref.mlstm_scan_ref(*args, return_state=True),
                       iters=5),
             nbytes, 4 * bh * n * XL_D * XL_D, None, BF16_FLOPS_PER_S)
    # the recurrent form's bound, 5 f32 operations per element of C and
    # per row of n in every step of every head, printed beside it
    print(f"  mlstm_scan: the recurrent form's f32-ops bound at "
          f"({b}, {XL_H}, {n}, {XL_D}): "
          f"{5 * bh * n * (XL_D * XL_D + XL_D) / F32_FLOPS_PER_S * 1e3:.4f}"
          f" ms")


# ----------------------------------- portable runtime vs native twins -----

#: twin pairs: portable kernel -> (native kernel, its source, the TPU
#: kernel it replaces)
TWINS = {
    "rmsnorm": ("rmsnorm_native", "native/rmsnorm_native.cu",
                "src/repro/kernels/rmsnorm/native.py:20"),
    "flash_attention": ("flash_attention_native",
                        "native/flash_attention_native.cu",
                        "src/repro/kernels/flash_attention/native.py:88")}
PARITY_KERNELS = ("rmsnorm", "flash_attention", "rmsnorm_native",
                  "flash_attention_native", "rt_selftest",
                  "rt_selftest_portable")


def _twin_cost(s: Smoke, c):
    """(bytes, operations, peak of their type, library ms) of a parity
    case, on its inputs: each input read once, the output written once;
    rmsnorm 4 flops an element, attention 4 D per live (q, k) pair."""
    torch = s.torch
    e = 4 if c["dtype"] == "float32" else 2
    peak = F32_FLOPS_PER_S if e == 4 else BF16_FLOPS_PER_S
    if c["pair"] == "rmsnorm":
        rows, d = c["shape"]
        x, w = c["args"]
        return (2 * rows * d * e + d * e, 4 * rows * d, peak,
                s.time_ms(lambda: torch.nn.functional.rms_norm(
                    x, (d,), w + 1.0, 1e-6)))
    b, hq, hkv, n, d = c["shape"]
    q, k, v, masks = c["args"]
    window = masks.get("window") or n
    pairs = sum(min(i + 1, window) for i in range(n))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib = None if masks else s.time_ms(       # SDPA takes no softcap
        lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))
    return (2 * b * hq * n * d * e + 2 * b * hkv * n * d * e,
            4 * b * hq * d * pairs, peak, lib)


def run_parity(s: Smoke) -> None:
    """The paper's native-vs-portable comparison on the card, through
    its entry point ``repro_torch.bench.parity.run``, with every launch
    count set to 0 just before it and read just after: each of its
    checks becomes one of this run's, and B11a, B11b and the runtime
    test kernel get their records (the twins' times measured in turns
    with their portable members, the library call's here)."""
    from repro_torch.bench import parity
    from repro_torch.core.build import KERNELS
    for k in KERNELS:
        k.launches = 0
    res = parity.run(s.dev)
    launches = {k.name: k.launches for k in KERNELS}
    parity.report(res)
    s.check(res["stub_refused"], "a generic build of atomic_inc is refused "
            f"with \"{parity.STUB}\"")
    for name in PARITY_KERNELS:
        s.check(launches[name] > 0, f"parity path: {name} launched "
                f"{launches[name]} times")
    for c in res["cases"]:
        what = f"{c['pair']} {c['case']} {tuple(c['shape'])} {c['dtype']}"
        s.check(c["bit_identical"], f"{what}: the native twin is "
                "bit-identical to the portable kernel")
        if c["pair"] == "rmsnorm":   # B1's generic build: the same sums
            s.check(c["generic_bit_identical"], f"{what}: the generic "
                    "build is bit-identical to the portable kernel")
        for side in ("portable", "native", "generic"):
            s.check(c[f"ok_{side}"], f"{what}: {side} within "
                    f"{c['tol']:g} of the plain version (max abs diff "
                    f"{c[f'err_{side}']:.3e})")
        if c["pair"] not in TWINS:
            continue        # the stand-ins: recorded on their own path
        name, source, replaces = TWINS[c["pair"]]
        nbytes, flops, peak, lib = _twin_cost(s, c)
        args = (c["err_native"], c["ms_native"], c["ms_plain"], nbytes,
                flops, lib)
        if c["case"] == "granite":
            s.record(name, source, replaces, *args, ops_per_s=peak)
            s.kernels[name]["launches_by_path"]["parity"] = launches[name]
            s.kernels[name]["portable_ms"] = c["ms_portable"]
        else:
            s.record_also(name, c["case"], *args, ops_per_s=peak)
            s.kernels[name][c["case"]]["portable_ms"] = c["ms_portable"]
    for r in res["hmma"]:
        want = "none" if r["target"] == "generic" else "HMMA in each"
        s.check(not parity.hmma_failures([r]),
                f"{r['build']} ({r['target']}): {want} of its bf16 "
                f"instantiations (" + ", ".join(
                    f"{k} {n}" for k, n in r["bf16"].items()) + ")")
    for r in res["selftest"]:
        s.check(r["ok"], f"runtime test kernel ({r['target']}, {r['build']}, "
                f"{r['teams']} teams, {r['total']} items): order-free "
                f"outcomes equal the plain atomics' {r['mismatches'] or ''}")
    r = next(r for r in res["selftest"] if r["teams"] > 7
             and r["build"] == "with target part")
    # parts, counters, old values of the increments, team sums and
    # maxes, a reciprocal per thread, and the staged copy in and out
    nbytes = 4 * (2 * r["teams"] + 8 + r["total"] + 2 * r["teams"]) + \
        4 * r["teams"] * 128 + 2 * 16 * r["teams"] * 128
    s.record("rt_selftest", "rt_selftest.cu", "tests/test_runtime.py:43",
             0.0 if r["ok"] else float("nan"), r["ms"], r["plain_ms"],
             nbytes, 0, None)
    s.kernels["rt_selftest"]["test"] = True
    s.kernels["rt_selftest"]["launches_by_path"]["parity"] = \
        launches["rt_selftest"]


# ----------------------------------- SPEC ACCEL stand-ins on the runtime ----

def _standin_path(s: Smoke, bench, path: str) -> None:
    """A stand-in path's entry point ``bench.run`` (``bench`` is
    ``repro_torch.bench.spec_accel`` or ``.miniqmc``), with every launch
    count set to 0 just before it and read just after, and its report
    printed.  Each of its checks becomes one of this run's, and each
    kernel of ``bench.TWINS`` gets its record (the card's shape as the
    main one, the reference's beside it), per launch."""
    from repro_torch.core.build import CSRC, KERNELS
    for k in KERNELS:
        k.launches = 0
    res = bench.run(s.dev)
    launches = {k.name: k.launches for k in KERNELS}
    bench.report(res)
    # portable build -> native build, one source each
    twins = {p.name: n for p, n in bench.TWINS.values()}
    for name, native in twins.items():
        for k in (name, native.name):
            s.check(launches[k] > 0, f"{path} path: {k} launched "
                    f"{launches[k]} times")
    # the card's shape first: it makes each kernel's main record
    for c in sorted(res["cases"], key=lambda c: c["case"] != "card"):
        what = f"{c['bench']} {c['case']} {tuple(c['shape'])}"
        s.check(c["bit_identical"], f"{what}: native and portable builds "
                "bit-identical")
        for side in ("native", "portable", "generic"):
            s.check(c[f"ok_{side}"], f"{what}: {side} within atol "
                    f"{c['tol']:.3g}, rtol {c['rtol']:g} of the plain "
                    f"version (max abs diff {c[f'err_{side}']:.3e})")
        one = c["launch_ms"]
        native = twins[c["pair"]]
        for name, side in ((c["pair"], "portable"), (native.name, "native")):
            args = (c[f"err_{side}"], one[side], one["plain"], c["bytes"],
                    c["ops"], one["library"], c["ops_per_s"])
            if c["case"] == "card":
                s.record(name, native.source.relative_to(CSRC).as_posix(),
                         bench.REPLACES[c["bench"]], *args, unit=c["unit"])
                s.kernels[name]["launches_by_path"][path] = launches[name]
                s.kernels[name]["generic_ms"] = one["generic"]
            else:
                s.record_also(name, c["case"], *args)


def run_spec_accel(s: Smoke) -> None:
    """The stand-ins B12-B17 through their entry point
    ``repro_torch.bench.spec_accel.run``: each of the twelve kernels'
    times are one launch's (postencil's sweep, pcg's SpMV, timed on
    their own; the library call's over a call's launches)."""
    from repro_torch.bench import spec_accel
    _standin_path(s, spec_accel, "spec_accel")


def run_miniqmc(s: Smoke) -> None:
    """miniQMC's regions B18-B19 through their entry point
    ``repro_torch.bench.miniqmc.run`` (the paper's Table 1): each call
    is one launch; the four kernels' times are medians of its calls."""
    from repro_torch.bench import miniqmc
    _standin_path(s, miniqmc, "miniqmc")


# ------------------------------------------------------------ serving -----

def _requests(vocab: int, prompt_lens=PROMPT_LENS):
    import numpy as np
    from repro_torch.serve.engine import Request
    rng = np.random.default_rng(0)
    return [Request(rid=i, tokens=rng.integers(
        0, vocab, size=prompt_lens[i % len(prompt_lens)]).tolist())
        for i in range(N_REQUESTS)]


class _Recorder:
    """The served model, keeping each call's sampled tokens (every
    slot's argmax, on the card) and, through ``route``, every MoE
    call's expert choices, for the plain replay."""

    def __init__(self, model):
        self.model, self.cfg, self.calls, self.routes = model, model.cfg, \
            [], []

    def route(self, real):
        """``moe._route`` that keeps each call's (T, k) expert ids."""
        def recording(router_w, x_flat, k):
            gates, idx = real(router_w, x_flat, k)
            self.routes.append(idx)
            return gates, idx
        return recording

    def init_decode_caches(self, *args, **kw):
        return self.model.init_decode_caches(*args, **kw)

    def prefill(self, params, tokens, cache_len):
        logits, caches = self.model.prefill(params, tokens, cache_len)
        self.calls.append(logits.argmax(-1))
        return logits, caches

    def decode_step(self, params, caches, tokens, lengths,
                    block_tables=None):
        logits = self.model.decode_step(params, caches, tokens, lengths,
                                        block_tables)
        self.calls.append(logits.argmax(-1))
        return logits


class _Top2(_Recorder):
    """The served model, keeping every call's two largest logits per
    row (on the card: no sync) and, through the engine, which request
    each decode row served; ``by_request`` maps them to (request,
    emitted token) after the run."""

    def __init__(self, model):
        super().__init__(model)
        self.engine, self.prefills, self.decodes = None, [], []

    def prefill(self, params, tokens, cache_len):
        logits, caches = self.model.prefill(params, tokens, cache_len)
        self.prefills.append((tokens, logits.topk(2, dim=-1)))
        return logits, caches

    def decode_step(self, params, caches, tokens, lengths,
                    block_tables=None):
        logits = self.model.decode_step(params, caches, tokens, lengths,
                                        block_tables)
        rows = [(slot, r.rid, len(r.out))
                for slot, r in enumerate(self.engine.active) if r is not None]
        self.decodes.append((rows, logits.topk(2, dim=-1)))
        return logits

    def by_request(self, reqs):
        """{(rid, emitted index): (top logit, second logit, top token,
        second token)}; a prefill row is matched by its tokens."""
        out = {}
        for tokens, (v, i) in self.prefills:
            for row, vals, ids in zip(tokens.tolist(), v.tolist(),
                                      i.tolist()):
                for r in reqs:
                    j = len(row) - len(r.tokens)
                    if j >= 0 and r.tokens + r.out[:j] == row:
                        out[(r.rid, j)] = (*vals, *ids)
        for rows, (v, i) in self.decodes:
            v, i = v.tolist(), i.tolist()
            for slot, rid, j in rows:
                out[(rid, j)] = (*v[slot], *i[slot])
        return out


class _Replayer(_Recorder):
    """The same calls through the plain versions on the card, each
    answered with the served tokens, so that the engine admits,
    schedules and pages exactly as it served; keeps the largest
    (argmax logit - served token's logit) over the slots each call
    emitted for, and counts the emitted tokens and those that were not
    the plain argmax.  Given the served expert choices (``routes``), every
    MoE call takes them too, with gates from its own router
    probabilities, and counts the choices its own top-k would have
    made otherwise."""

    def __init__(self, model, calls, routes=None):
        super().__init__(model)
        self.calls, self.routes = calls, routes
        self.i, self.r, self.engine, self.worst = 0, 0, None, None
        self.flips, self.emitted, self.flipped = 0, 0, 0

    def route(self, real):
        def forced(router_w, x_flat, k):
            _, own = real(router_w, x_flat, k)
            idx = self.routes[self.r]
            self.r += 1
            self.flips = self.flips + (own != idx).sum()
            probs = (x_flat.float() @ router_w.float()).softmax(-1)
            gates = probs.gather(1, idx)
            return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx
        return forced if self.routes is not None else real

    def _answer(self, logits, emitting):
        forced = self.calls[self.i]
        self.i += 1
        gap = logits.max(-1).values - logits.gather(
            1, forced[:, None].long())[:, 0]
        gap = gap.where(emitting, gap.new_zeros(()))
        self.emitted = self.emitted + emitting.sum()
        self.flipped = self.flipped + (gap > 0).sum()
        gap = gap.max()
        self.worst = gap if self.worst is None else self.worst.maximum(gap)
        return logits.new_zeros(logits.shape).scatter_(
            1, forced[:, None].long(), 1.0)

    def prefill(self, params, tokens, cache_len):
        logits, caches = self.model.prefill(params, tokens, cache_len,
                                            plain=True)
        return self._answer(logits, logits.new_ones(
            logits.shape[:1], dtype=bool)), caches

    def decode_step(self, params, caches, tokens, lengths,
                    block_tables=None):
        logits = self.model.decode_step(params, caches, tokens, lengths,
                                        block_tables, plain=True)
        return self._answer(logits, self.engine.active_mask)


def serve(s: Smoke, model, params, cache_len=CACHE_LEN,
          prompt_lens=PROMPT_LENS, record=False, margins=False, **mode):
    """Drive the engine over the 12 requests in a serving ``mode``
    (ServeConfig fields); returns (requests, stats).  ``record`` keeps
    every call's sampled tokens in ``stats["calls"]`` for the replay;
    ``margins`` every emitted token's two largest served logits in
    ``stats["top2"]`` (``_Top2.by_request``); an MoE model's dropped
    assignments are counted on the card and read after the run."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    from repro_torch.models import moe
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.paging import paged_bytes_per_slot
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=cache_len,
                                max_new_tokens=MAX_NEW, page_size=PAGE,
                                **mode)
    served = _Recorder(model) if record else \
        _Top2(model) if margins else model
    engine = engine_mod.Engine(served, params, sc, device=s.dev)
    if margins:
        served.engine = engine
    real_route = moe._route
    if record:
        moe._route = served.route(real_route)
    reqs = _requests(model.cfg.vocab_size, prompt_lens)
    syncs, groups = [0], [0]
    real_get, real_admit = engine_mod._device_get, engine._admit_group

    def counted_get(t):
        # the engine's own copy; sync debugging flags every other sync
        syncs[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_get(t)
        finally:
            torch.cuda.set_sync_debug_mode(1)

    def counted_admit(reqs_, plen):
        n = real_admit(reqs_, plen)
        groups[0] += n > 0
        return n

    engine_mod._device_get = counted_get
    engine._admit_group = counted_admit
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    drops = moe.count_drops(s.dev) if model.cfg.moe is not None else None
    step_s, decode_steps, hidden = [], 0, {"admitting": 0, "decoding": 0}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode(1)     # warn on every other sync
        try:
            t0 = time.perf_counter()
            for r in reqs:
                engine.submit(r)
            while True:
                g0, n0, ts = groups[0], len(caught), time.perf_counter()
                busy = engine.step()      # ends in its host copy: synced
                dt = time.perf_counter() - ts
                n = sum("synchroniz" in str(w.message)
                        for w in caught[n0:])
                hidden["decoding" if groups[0] == g0 else "admitting"] += n
                if busy:
                    decode_steps += 1
                    if groups[0] == g0:
                        step_s.append(dt)
                if not busy and not engine.queue and not engine.requeue:
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            torch.cuda.set_sync_debug_mode(0)
            moe.stop_counting_drops()
            moe._route = real_route
            engine_mod._device_get = real_get
            # the wrapper holds the engine's bound method: without this
            # the cycle keeps its weights and pools alive after the run
            del engine._admit_group
    launches = {k.name: k.launches for k in KERNELS}
    stats = {"wall_s": wall, "decode_steps": decode_steps,
             "groups": groups[0], "syncs": syncs[0],
             "step_ms_median": 1e3 * statistics.median(step_s),
             "tokens": sum(len(r.out) for r in reqs),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": launches, "preemptions": engine.preemptions,
             "hidden_syncs": hidden}
    stats["tok_per_s"] = stats["tokens"] / wall
    if drops is not None:
        stats["moe_dropped"] = int(drops)
    if record:
        stats["calls"] = (served.calls, served.routes)
    if margins:
        stats["top2"] = served.by_request(reqs)
        served.engine = None
    if engine.paged:
        stats["kv_dtype"] = (None if engine.kv_spec is None
                             else engine.kv_spec.dtype)
        stats["pool_bytes_per_slot"] = paged_bytes_per_slot(
            engine.caches, engine.allocator.total_pages,
            engine.pages_per_slot)
        stats["audit"] = engine.audit()
        if engine.windowed:
            est = engine.stats()
            stats["window_prefix_frees"] = est["window_prefix_frees"]
            stats["window_peak_in_use"] = \
                est["pool_groups"]["window"]["peak_in_use"]
    if engine.spec:
        stats.update(spec_steps=engine.spec_steps,
                     spec_emitted=engine.spec_emitted,
                     spec_rejections=engine.spec_rejections)
    del engine
    return reqs, stats


def traced_busy_share(s: Smoke, model, params, cache_len=CACHE_LEN,
                      prompt_lens=PROMPT_LENS):
    """The card's busy share over the decode steps PROFILED_STEPS of a
    fresh paged run with all slots decoding: summed kernel time from a
    trace, over the steps' wall time.  Tracing slows the host, so this
    is a lower bound; and once the card had been traced, every later
    step of a run took about twice as long, so this runs after
    everything that is timed."""
    torch = s.torch
    from repro_torch.serve import engine as engine_mod
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=cache_len,
                                max_new_tokens=MAX_NEW, paged=True,
                                page_size=PAGE)
    engine = engine_mod.Engine(model, params, sc, device=s.dev)
    for r in _requests(model.cfg.vocab_size, prompt_lens)[:SLOTS]:
        engine.submit(r)
    for _ in range(PROFILED_STEPS[0]):
        engine.step()
    prof = _profiler(torch)
    if prof is None:
        return None
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS[1] - PROFILED_STEPS[0]):
        engine.step()                     # each step ends in a sync
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = _device_busy_ms(prof, PROFILED_STEPS[1] - PROFILED_STEPS[0])
    return None if busy_ms is None else busy_ms / wall_ms


def _profiler(torch):
    """Trace the card's kernels (no host ops: less overhead on the host,
    which is what the window measures against); None if it cannot."""
    try:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    except RuntimeError:
        traceback.print_exc()
        return None
    return prof


def _device_busy_ms(prof, steps: int):
    """Summed kernel time of the traced window, or None when the trace
    holds no device time (then the share is "not measured"); prints the
    six kernels that took the most of it, per step."""
    prof.stop()
    rows = sorted(((getattr(e, "self_device_time_total", 0.0), e.key)
                   for e in prof.key_averages()), reverse=True)
    for us, name in rows[:6]:
        if us > 0:
            print(f"    {us / 1e3 / steps:8.3f} ms per step  {name[:100]}")
    total_us = sum(us for us, _ in rows)
    return total_us / 1e3 if total_us > 0 else None


def teacher_gap(s: Smoke, model, params, reqs):
    """Largest (argmax logit - emitted token's logit) over every emitted
    token, from a plain-path forward over prompt + outputs; returns it
    and where it was (request, index of the emitted token: 0 is the
    prefill's sample), the emitted tokens and how many of them were not
    the plain forward's argmax (gap > 0)."""
    torch = s.torch
    worst, where, tokens, flipped = 0.0, None, 0, 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.tensor([r.tokens + r.out[:-1]], device=s.dev)
            p0 = len(r.tokens) - 1
            # logits only where tokens were emitted: at gemma2's vocab of
            # 256,000 every position of a 6,000-token prompt is 6 GB
            rows = model.forward_logits(params, seq, plain=True,
                                        start=p0)[0]
            got = rows[torch.arange(len(r.out), device=s.dev),
                       torch.tensor(r.out, device=s.dev)]
            gaps = rows.max(-1).values - got
            tokens += len(r.out)
            flipped += int((gaps > 0).sum())
            if float(gaps.max()) > worst:
                worst = float(gaps.max())
                where = (r.rid, int(gaps.argmax()))
    return worst, where, tokens, flipped


def check_serving(s: Smoke, model, params, name: str, mode: dict,
                  per_step, kernels_idle=(), teacher_checked=True,
                  prefill=("rmsnorm", "flash_attention"), per_group=None,
                  replay=False, margins=False, **shape):
    """Serve the 12 requests in ``mode`` (``shape``: the cache length and
    prompt lengths, if not granite's); check completion, the one-sync
    contract, that the prefill kernels launched, that each decode
    kernel in ``per_step`` launched exactly that many times per decode
    step (plus ``per_group[k]`` per admitted group, for a kernel that
    prefill runs too) and none in ``kernels_idle`` ever (nor B8 for a
    model without experts, nor B9 for one without mamba layers, nor B10
    for one without mLSTM layers), that a paged run's allocator audit is
    clean
    at the end and, with a window group, that pages behind the window
    were freed; and the teacher-forced gap (reported only where
    ``teacher_checked`` is false: a quantized pool is not the bf16
    model), against a plain forward over each request's tokens or, with
    ``replay``, against the plain replay of the run's own calls."""
    torch = s.torch
    per_group = per_group or {}
    t0 = time.perf_counter()
    reqs, st = serve(s, model, params, record=replay, margins=margins,
                     **shape, **mode)
    print(f"  served {len(reqs)} requests in {st['wall_s']:.3f} s "
          f"({time.perf_counter() - t0:.3f} s with set-up): "
          f"{st['tokens']} tokens, {st['tok_per_s']:.1f} tok/s, "
          f"{st['decode_steps']} decode steps (median "
          f"{st['step_ms_median']:.2f} ms), {st['groups']} prefill groups, "
          f"peak memory {st['peak_gib']:.2f} GiB, launches "
          f"{st['launches']}")
    s.check(all(r.done for r in reqs), f"{name}: every request done")
    s.check(all(len(r.out) == MAX_NEW for r in reqs),
            f"{name}: every request emitted {MAX_NEW} tokens")
    for kname in prefill + tuple(per_step):
        s.check(st["launches"][kname] > 0,
                f"{name}: {kname} launched {st['launches'][kname]} times")
        s.kernels[kname]["launches_by_path"][name] = st["launches"][kname]
    for kname, n in per_step.items():
        g = per_group.get(kname, 0)
        s.check(st["launches"][kname]
                == n * st["decode_steps"] + g * st["groups"],
                f"{name}: {kname} launched {n} times per decode step"
                + (f" and {g} per admitted group" if g else "")
                + f" ({st['launches'][kname]} = {n} x {st['decode_steps']}"
                + (f" + {g} x {st['groups']}" if g else "") + ")")
    if "mamba" not in model.cfg.layer_kinds():
        kernels_idle = tuple(kernels_idle) + ("mamba_scan",)
    if "mlstm" not in model.cfg.layer_kinds():
        kernels_idle = tuple(kernels_idle) + ("mlstm_scan",)
    if model.cfg.moe is None:
        kernels_idle = tuple(kernels_idle) + ("gmm",)
    else:
        print(f"  {name}: {st['moe_dropped']} MoE assignments dropped by "
              f"capacity over the run")
    for kname in kernels_idle:
        s.check(st["launches"][kname] == 0,
                f"{name}: {kname} not launched ({st['launches'][kname]})")
    s.check(st["syncs"] == st["decode_steps"] + st["groups"],
            f"{name}: {st['syncs']} host syncs = {st['decode_steps']} "
            f"decode steps + {st['groups']} admitted groups")
    s.check(st["hidden_syncs"]["decoding"] == 0,
            f"{name}: no other sync in steps that admitted nothing "
            f"({st['hidden_syncs']['decoding']}; "
            f"{st['hidden_syncs']['admitting']} in admitting steps)")
    if "audit" in st:
        s.check(st["audit"] == [], f"{name}: allocator audit clean at the "
                                   f"end ({st['audit'][:3]})")
    if "window_prefix_frees" in st:
        s.check(st["window_prefix_frees"] > 0,
                f"{name}: {st['window_prefix_frees']} pages behind the "
                f"window freed during the run (> 0); window pool peak "
                f"{st['window_peak_in_use']} pages")
    if replay:
        calls, routes = st.pop("calls")
        # the served expert choices too: at a near tie the plain path's
        # rounding can pick another expert, and past capacity that
        # reorders which assignments drop (reported below, unchecked)
        gap, dropped, flips, tokens, flipped = replay_gap(
            s, model, params, calls, routes, **shape, **mode)
        s.check(dropped == st["moe_dropped"],
                f"{name}: the replay on the served expert choices dropped "
                f"the served {st['moe_dropped']} assignments ({dropped}); "
                f"its own top-k differed in {flips} choices")
        free, free_dropped, *_ = replay_gap(s, model, params, calls, None,
                                            **shape, **mode)
        st.update(replay_routing_flips=flips, free_replay_gap=free,
                  free_replay_moe_dropped=free_dropped)
        print(f"  {name}: a replay routing by its own top-k dropped "
              f"{free_dropped} assignments, largest gap {free:.4f} logits "
              f"(reported)")
        where = None
    else:
        gap, where, tokens, flipped = teacher_gap(s, model, params, reqs)
    st["teacher_gap"], st["teacher_gap_at"] = gap, where
    st["teacher_tokens"], st["teacher_flipped"] = tokens, flipped
    at = "" if where is None else \
        f", request {where[0]}, emitted token {where[1]}"
    print(f"  {name}: {flipped} of {tokens} emitted tokens "
          f"({flipped / tokens:.4f}) are not the plain argmax")
    if teacher_checked:
        s.check(gap <= TEACHER_GAP,
                f"{name}: every emitted token within {TEACHER_GAP} logits "
                f"of the plain forward's argmax (largest gap {gap:.4f}{at})")
    else:
        print(f"  {name}: largest teacher-forced gap against the bf16 "
              f"plain forward {gap:.4f} logits{at} (reported)")
    if "spec_steps" in st:
        s.check(st["spec_rejections"] > 0,
                f"{name}: {st['spec_rejections']} rejected drafts (> 0)")
        print(f"  {name}: {st['spec_emitted']} tokens in "
              f"{st['spec_steps']} speculative steps, "
              f"{st['spec_emitted'] / st['spec_steps']:.3f} tokens per "
              f"step over {SLOTS} slots")
    torch.cuda.empty_cache()
    return reqs, st


def replay_gap(s: Smoke, model, params, calls, routes=None,
               cache_len=CACHE_LEN, prompt_lens=PROMPT_LENS, **mode):
    """The teacher-forced gap of a recorded run against the plain
    versions on the card, compared like with like: the same engine
    replays the same prefill groups and decode batches (every call's
    tokens answered with the served ones, so capacity follows each
    call's own token count as served) and, given ``routes``, the same
    expert choices, so the same assignments drop.  Returns (largest
    gap, the replay's dropped assignments, the expert choices its own
    routing would have changed, the emitted tokens, and those not the
    replay's argmax)."""
    from repro_torch.core.build import KERNELS
    from repro_torch.models import moe
    from repro_torch.serve import engine as engine_mod
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=cache_len,
                                max_new_tokens=MAX_NEW, page_size=PAGE,
                                **mode)
    replayer = _Replayer(model, calls, routes)
    engine = engine_mod.Engine(replayer, params, sc, device=s.dev)
    replayer.engine = engine
    for k in KERNELS:
        k.launches = 0
    drops = moe.count_drops(s.dev)
    real_route = moe._route
    moe._route = replayer.route(real_route)
    try:
        engine.run_to_completion(_requests(model.cfg.vocab_size, prompt_lens))
    finally:
        moe._route = real_route
        moe.stop_counting_drops()
        replayer.engine = None
    s.check(replayer.i == len(calls),
            f"replay made the served run's {len(calls)} model calls "
            f"({replayer.i})")
    if routes is not None:
        s.check(replayer.r == len(routes),
                f"replay made the served run's {len(routes)} MoE calls "
                f"({replayer.r})")
    s.check(all(k.launches == 0 for k in KERNELS),
            "replay launched no kernel (plain versions only)")
    return (float(replayer.worst), int(drops), int(replayer.flips),
            int(replayer.emitted), int(replayer.flipped))


def _agree(a, b) -> int:
    return sum(x == y for p, q in zip(a, b) for x, y in zip(p.out, q.out))


def run_serving(s: Smoke):
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.quant import resolve_kv_spec
    cfg = get_config("granite-8b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    print(f"  granite-8b: {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{n / 1e9:.3f} B parameters in {cfg.dtype}, random from seed 0 "
          f"({time.perf_counter() - t0:.2f} s)")
    runs, stats = {}, {}

    def run(name, mode, decode_kernel, idle=(), **kw):
        print(f"== serve, {name}", flush=True)
        runs[name], stats[name] = check_serving(
            s, model, params, name, mode, {decode_kernel: cfg.num_layers},
            idle, **kw)

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    print(f"  dense and paged agree on {_agree(runs['paged'], runs['dense'])}"
          f" of {stats['paged']['tokens']} tokens")
    quant_idle = ("paged_decode_attention", "spec_paged_decode_attention")
    for kv in ("int8", "fp8_e4m3"):
        # strict: a card without the dtype fails here, never serves int8
        resolve_kv_spec(kv, s.dev, strict=True)
        run(kv, dict(paged=True, kv_dtype=kv), "quant_paged_decode_attention",
            quant_idle, teacher_checked=False)
        st = stats[kv]
        s.check(st["kv_dtype"] == kv,
                f"{kv}: the engine's pools are {st['kv_dtype']}")
        ratio = st["pool_bytes_per_slot"] / \
            stats["paged"]["pool_bytes_per_slot"]
        s.check(ratio < 0.53,
                f"{kv}: pool bytes per slot {st['pool_bytes_per_slot']} = "
                f"{ratio:.4f} of bf16's {stats['paged']['pool_bytes_per_slot']}")
        print(f"  {kv} and bf16 paged agree on "
              f"{_agree(runs[kv], runs['paged'])} of {st['tokens']} tokens")
    spec_idle = ("paged_decode_attention", "quant_paged_decode_attention")
    spec = dict(paged=True, spec_mode="ngram", spec_k=SPEC_K)
    run("spec", spec, "spec_paged_decode_attention", spec_idle)
    print(f"  spec and plain paged agree on "
          f"{_agree(runs['spec'], runs['paged'])} of "
          f"{stats['spec']['tokens']} tokens")
    run("spec-int8", dict(spec, kv_dtype="int8"),
        "spec_paged_decode_attention", spec_idle, teacher_checked=False)
    print(f"  spec-int8 and int8 agree on "
          f"{_agree(runs['spec-int8'], runs['int8'])} of "
          f"{stats['spec-int8']['tokens']} tokens")
    return dict(stats, tokens_agree={
        "dense_paged": _agree(runs["paged"], runs["dense"]),
        "spec_paged": _agree(runs["spec"], runs["paged"]),
        "int8_paged": _agree(runs["int8"], runs["paged"]),
        "fp8_e4m3_paged": _agree(runs["fp8_e4m3"], runs["paged"]),
        "spec_int8_int8": _agree(runs["spec-int8"], runs["int8"])})


def run_traces(s: Smoke):
    """The card's busy share over paged decode steps of each model,
    fresh weights from the same seed; last, since tracing slows every
    later step (deepseek-v2-lite-16b's is traced first, then gemma2-2b's,
    granite-8b's, jamba-1.5-large-398b's and xlstm-1.3b's, each a lower
    bound)."""
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    shares = {}
    for arch, shape in (("deepseek-v2-lite-16b", {}),
                        ("gemma2-2b", dict(cache_len=G2_CACHE_LEN,
                                           prompt_lens=G2_PROMPT_LENS)),
                        ("granite-8b", {}),
                        ("jamba-1.5-large-398b", {}),
                        ("xlstm-1.3b", {})):
        model = build_model(_jamba_config() if arch.startswith("jamba")
                            else get_config(arch))
        params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                            device=s.dev)
        share = traced_busy_share(s, model, params, **shape)
        shares[arch] = share
        print(f"  {arch}: card busy over paged decode steps "
              f"{PROFILED_STEPS[0]}-{PROFILED_STEPS[1] - 1} (traced, a "
              f"lower bound): "
              + ("not measured" if share is None else f"{100 * share:.1f}%"))
        del params
        torch.cuda.empty_cache()
    return shares


def run_serving_gemma2(s: Smoke):
    """gemma2-2b at full width and depth, four ways: paged (B4 on the 13
    global layers, B7 over ring tables on the 13 local ones), dense
    (B3 on all 26, local layers over rings of the window), and from
    int8 and fp8 pools (B5 and B7q)."""
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.quant import resolve_kv_spec
    cfg = get_config("gemma2-2b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    kinds = cfg.layer_kinds()
    n_local = kinds.count("local")
    print(f"  gemma2-2b: {cfg.num_layers} layers ({n_local} local, window "
          f"{cfg.window}), d_model {cfg.d_model}, {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads of {cfg.head_dim}, {n / 1e9:.3f} B "
          f"parameters in {cfg.dtype}, random from seed 0 "
          f"({time.perf_counter() - t0:.2f} s); cache {G2_CACHE_LEN}, "
          f"prompts {G2_PROMPT_LENS}")
    shape = dict(cache_len=G2_CACHE_LEN, prompt_lens=G2_PROMPT_LENS)
    runs, stats = {}, {}
    decode = ("decode_attention", "paged_decode_attention",
              "window_paged_decode_attention",
              "quant_paged_decode_attention",
              "quant_window_paged_decode_attention",
              "spec_paged_decode_attention")
    n_global = cfg.num_layers - n_local

    def run(name, mode, per_step, **kw):
        print(f"== serve gemma2-2b, {name}", flush=True)
        idle = tuple(k for k in decode if k not in per_step)
        runs[name], stats[name] = check_serving(
            s, model, params, f"gemma2 {name}", mode, per_step, idle,
            **shape, **kw)

    run("paged", dict(paged=True),
        {"paged_decode_attention": n_global,
         "window_paged_decode_attention": n_local}, margins=True)
    run("dense", dict(paged=False), {"decode_attention": cfg.num_layers},
        margins=True)
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  gemma2 dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    divergences = first_divergences(
        s, model, params, runs["paged"], runs["dense"],
        stats["paged"].pop("top2"), stats["dense"].pop("top2"))
    for kv in ("int8", "fp8_e4m3"):
        resolve_kv_spec(kv, s.dev, strict=True)
        run(kv, dict(paged=True, kv_dtype=kv),
            {"quant_paged_decode_attention": n_global,
             "quant_window_paged_decode_attention": n_local},
            teacher_checked=False)
        agree[f"{kv}_paged"] = _agree(runs[kv], runs["paged"])
        print(f"  gemma2 {kv} and bf16 paged agree on "
              f"{agree[f'{kv}_paged']} of {stats[kv]['tokens']} tokens")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree, divergences=divergences)


def first_divergences(s: Smoke, model, params, paged, dense, top_p, top_d):
    """For each request whose paged and dense tokens differ, at the first
    token where they do: the margin between the two largest logits each
    run served there, and, from a plain forward over the common prefix,
    its own top-2 margin and the gap between the logits of the two
    tokens the runs chose, beside the bf16 spacing at the top logit (8
    significant bits).  Reported, not checked: the teacher-forced gap
    already holds every served token to TEACHER_GAP of the plain
    argmax.  Returns the rows."""
    import math
    torch = s.torch
    rows = []
    with torch.no_grad():
        for rp, rd in zip(paged, dense):
            j = next((i for i, (a, b) in enumerate(zip(rp.out, rd.out))
                      if a != b), None)
            if j is None:
                continue
            seq = rp.tokens + rp.out[:j]
            lg = model.forward_logits(params, torch.tensor([seq], device=s.dev),
                                      plain=True, start=len(seq) - 1)[0, 0]
            v, i = lg.topk(2)
            top = float(v[0])
            ulp = 2.0 ** (math.floor(math.log2(abs(top))) - 7) if top else 0.0
            tp, td = top_p[(rp.rid, j)], top_d[(rd.rid, j)]
            row = {"request": rp.rid, "token": j, "paged_token": rp.out[j],
                   "dense_token": rd.out[j],
                   "paged_margin": tp[0] - tp[1],
                   "dense_margin": td[0] - td[1],
                   "plain_margin": top - float(v[1]),
                   "plain_top2": [int(i[0]), int(i[1])],
                   "plain_gap_between_chosen": abs(
                       float(lg[rp.out[j]]) - float(lg[rd.out[j]])),
                   "plain_top_logit": top, "bf16_spacing_at_top": ulp}
            rows.append(row)
            print(f"  request {rp.rid}: first differs at emitted token {j} "
                  f"(paged {rp.out[j]}, dense {rd.out[j]}; plain top-2 "
                  f"{row['plain_top2']}): served top-2 margin paged "
                  f"{row['paged_margin']:.4f}, dense "
                  f"{row['dense_margin']:.4f}; plain top-2 margin "
                  f"{row['plain_margin']:.4f}, plain gap between the two "
                  f"chosen {row['plain_gap_between_chosen']:.4f} logits "
                  f"(top logit {top:.3f}, bf16 spacing there {ulp:.4f})")
    if rows:
        widest = max(r["plain_gap_between_chosen"] for r in rows)
        print(f"  {len(rows)} requests diverge; the widest plain gap between "
              f"the two chosen tokens is {widest:.4f} logits "
              f"(teacher-forced tolerance {TEACHER_GAP})")
    return rows


def run_serving_deepseek(s: Smoke):
    """deepseek-v2-lite-16b at full width and depth (27 MLA layers, the
    first dense, 26 of 64 routed experts top-6 with 2 shared experts),
    served paged (B4 at 192/128) and dense (B3 at 192/128), B8 on every
    MoE layer, held to a plain replay of its own calls."""
    import gc
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")
    cfg = get_config("deepseek-v2-lite-16b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.moe
    print(f"  deepseek-v2-lite-16b: {cfg.num_layers} layers (MLA, 16 heads "
          f"of 192/128; MoE on {cfg.num_layers - 1}: {m.num_experts} "
          f"experts top-{m.top_k}, d_ff {m.d_ff_expert}, "
          f"{m.num_shared_experts} shared), d_model {cfg.d_model}, "
          f"{n / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} GB), random "
          f"from seed 0 ({time.perf_counter() - t0:.2f} s)")
    runs, stats = {}, {}
    n_moe = cfg.num_layers - 1
    decode = ("decode_attention", "paged_decode_attention",
              "window_paged_decode_attention",
              "quant_paged_decode_attention",
              "quant_window_paged_decode_attention",
              "spec_paged_decode_attention")

    def run(name, mode, decode_kernel):
        print(f"== serve deepseek-v2-lite-16b, {name}", flush=True)
        per_step = {decode_kernel: cfg.num_layers, "gmm": 3 * n_moe}
        runs[name], stats[name] = check_serving(
            s, model, params, f"deepseek {name}", mode, per_step,
            tuple(k for k in decode if k != decode_kernel),
            prefill=("rmsnorm", "flash_attention", "gmm"),
            per_group={"gmm": 3 * n_moe}, replay=True)
        for kname in ("flash_attention", decode_kernel):
            s.kernels[kname]["deepseek"]["launches"] = \
                stats[name]["launches"][kname]

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  deepseek dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree)


def _jamba_config():
    """jamba-1.5-large-398b at full width, cut to its first 4 layers:
    one 8-layer period is 90.5 GB in bf16, more than the card holds;
    4 layers are the least depth with every layer combination it has
    (attention with a dense MLP, mamba with MoE, mamba with a dense
    MLP)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("jamba-1.5-large-398b"),
                               num_layers=JB_LAYERS)


def run_serving_jamba(s: Smoke):
    """jamba-1.5-large-398b at full width, 4 layers (attention, then
    three mamba layers, MoE of 16 experts top-2 on layers 1 and 3),
    served paged (B4) and dense (B3), B8 on every MoE layer and B9 on
    every mamba layer's prefill, held to a plain replay of its own
    calls."""
    import gc
    torch = s.torch
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")
    cfg = _jamba_config()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    kinds = cfg.layer_kinds()
    n_attn, n_mamba = kinds.count("global"), kinds.count("mamba")
    n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers))
    m = cfg.moe
    print(f"  jamba-1.5-large-398b: {cfg.num_layers} of its 72 layers "
          f"({kinds}; MoE on {n_moe}: {m.num_experts} experts top-"
          f"{m.top_k}, d_ff {m.d_ff_expert}), d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"mamba d_inner {cfg.ssm.expand * cfg.d_model} with "
          f"{cfg.ssm.d_state} states, {n / 1e9:.3f} B parameters "
          f"({nbytes / 1e9:.2f} GB), random from seed 0 "
          f"({time.perf_counter() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
    runs, stats = {}, {}
    decode = ("decode_attention", "paged_decode_attention",
              "window_paged_decode_attention",
              "quant_paged_decode_attention",
              "quant_window_paged_decode_attention",
              "spec_paged_decode_attention")

    def run(name, mode, decode_kernel):
        print(f"== serve jamba-1.5-large-398b, {name}", flush=True)
        per_step = {decode_kernel: n_attn, "gmm": 3 * n_moe, "mamba_scan": 0}
        runs[name], stats[name] = check_serving(
            s, model, params, f"jamba {name}", mode, per_step,
            tuple(k for k in decode if k != decode_kernel),
            prefill=("rmsnorm", "flash_attention", "gmm", "mamba_scan"),
            per_group={"gmm": 3 * n_moe, "mamba_scan": n_mamba},
            replay=True)
        for kname in ("rmsnorm", "flash_attention", "gmm", decode_kernel):
            s.kernels[kname]["jamba"]["launches"] = \
                stats[name]["launches"][kname]

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  jamba dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree)


def run_serving_xlstm(s: Smoke):
    """xlstm-1.3b at full width and depth (48 layers: seven mLSTM, then
    one sLSTM, six times; no attention layer), served paged and dense in
    bf16 and again, on the same weights, in f32 (XL_DTYPES): B10 with its
    state output on every mLSTM layer of every prefill (42 launches per
    admitted group), none in a decode step (the one-token recurrences are
    plain PyTorch); then ``Model.loss`` of one batch through the kernels
    and through their plain versions.  The teacher-forced gap and the
    loss are checked in f32 and reported in bf16 (see XL_DTYPES)."""
    import dataclasses
    import gc
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")
    idle = ("flash_attention", "decode_attention", "paged_decode_attention",
            "window_paged_decode_attention", "quant_paged_decode_attention",
            "quant_window_paged_decode_attention",
            "spec_paged_decode_attention")
    out, paged_runs = {}, {}
    for dt in XL_DTYPES:
        cfg = dataclasses.replace(get_config("xlstm-1.3b"), dtype=dt)
        checked = dt == "float32"
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                            device=s.dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        kinds = cfg.layer_kinds()
        n_mlstm = kinds.count("mlstm")
        print(f"  xlstm-1.3b in {dt}: {cfg.num_layers} layers ({n_mlstm} "
              f"mLSTM, {kinds.count('slstm')} sLSTM), d_model {cfg.d_model}, "
              f"mLSTM heads {XL_H} of {XL_D}, {n / 1e9:.3f} B parameters "
              f"({nbytes / 1e9:.2f} GB), random from seed 0 "
              f"({time.perf_counter() - t0:.2f} s)")
        runs, stats = {}, {}
        for mode in ("paged", "dense"):
            name = f"{mode} {dt}"
            print(f"== serve xlstm-1.3b, {name}", flush=True)
            runs[mode], stats[mode] = check_serving(
                s, model, params, f"xlstm {name}",
                dict(paged=mode == "paged"), {"mlstm_scan": 0}, idle,
                teacher_checked=checked, prefill=("rmsnorm", "mlstm_scan"),
                per_group={"mlstm_scan": n_mlstm})
        agree = _agree(runs["paged"], runs["dense"])
        print(f"  xlstm {dt}: dense and paged agree on {agree} of "
              f"{stats['paged']['tokens']} tokens")
        print(f"== xlstm-1.3b Model.loss, {dt}", flush=True)
        loss = xlstm_loss(s, model, params, XL_LOSS_TOL if checked else None)
        out[dt] = dict(stats, tokens_agree={"dense_paged": agree}, loss=loss)
        paged_runs[dt] = runs["paged"]
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    out["bf16_f32_paged_tokens_agree"] = _agree(*paged_runs.values())
    print(f"  xlstm paged: bf16 and f32 agree on "
          f"{out['bf16_f32_paged_tokens_agree']} of "
          f"{out[XL_DTYPES[0]]['paged']['tokens']} tokens")
    return out


def xlstm_loss(s: Smoke, model, params, tol):
    """``Model.loss`` of one batch of XL_LOSS_B x XL_LOSS_S random tokens
    and labels: through the kernels (the counts set to 0 just before and
    read just after: B10 once per mLSTM layer, without its state output,
    and B1), then through their plain versions (no launch); the two
    losses within ``tol``, or reported where it is None."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    g = torch.Generator(device=s.dev).manual_seed(5)
    batch = {name: torch.randint(0, model.cfg.vocab_size,
                                 (XL_LOSS_B, XL_LOSS_S), device=s.dev,
                                 generator=g)
             for name in ("tokens", "labels")}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    _, got = model.loss(params, batch)
    torch.cuda.synchronize()
    t_kern = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    _, want = model.loss(params, batch, plain=True)
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    dt = model.cfg.dtype
    n_mlstm = model.cfg.layer_kinds().count("mlstm")
    s.check(launches["mlstm_scan"] == n_mlstm,
            f"xlstm loss ({dt}): mlstm_scan launched once per mLSTM layer "
            f"({launches['mlstm_scan']} = {n_mlstm})")
    s.check(launches["rmsnorm"] > 0, f"xlstm loss ({dt}): rmsnorm launched "
                                     f"{launches['rmsnorm']} times")
    others = {k: n for k, n in launches.items()
              if k not in ("mlstm_scan", "rmsnorm") and n}
    s.check(not others, f"xlstm loss ({dt}): no other kernel launched "
                        f"({others})")
    s.check(all(k.launches == launches[k.name] for k in KERNELS),
            f"xlstm loss ({dt}): the plain loss launched no kernel")
    for kname in ("mlstm_scan", "rmsnorm"):
        s.kernels[kname]["launches_by_path"][f"xlstm loss {dt}"] = \
            launches[kname]
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(v) for k, v in want.items()}
    diff = {k: abs(got[k] - want[k]) for k in got}
    s.check(all(map(math.isfinite, list(got.values()) + list(
        want.values()))), f"xlstm loss ({dt}): every metric finite")
    what = (f"xlstm loss ({dt}) of a {XL_LOSS_B} x {XL_LOSS_S} batch: "
            f"{got['loss']:.6f} through the kernels, {want['loss']:.6f} "
            f"through their plain versions, |diff| {diff['loss']:.3e}")
    if tol is None:
        print(f"  {what} (reported)")
    else:
        s.check(diff["loss"] <= tol, f"{what} <= {tol}")
    print(f"  xlstm loss ({dt}): {1e3 * t_kern:.1f} ms through the kernels, "
          f"{1e3 * t_plain:.1f} ms through the plain versions (wall, "
          f"synchronised); peak memory {peak:.2f} GiB")
    return {"metrics": got, "plain_metrics": want, "abs_diff": diff,
            "ms": 1e3 * t_kern, "plain_ms": 1e3 * t_plain,
            "peak_gib": peak, "launches": launches}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# ----------------------------------------------------------------- main ----

def main() -> int:
    try:
        import torch
    except ImportError:
        _die("PyTorch is not installed")
    if not torch.cuda.is_available():
        _die("no CUDA device: the port's smoke run needs one card")
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.core import build
    except ImportError:
        _die(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    s = Smoke(torch)
    # built with the rest: the control of the operand-model check
    from repro_torch.kernels.flash_attention import ref as flash_ref
    s.flash_control = flash_p_terms_kernel(flash_ref.P_TERMS - 1)

    print("== card", flush=True)
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    smi = smi[0] if smi else "nvidia-smi gave nothing"
    print(f"  {kind}; nvidia-smi: {smi}; {torch.cuda.device_count()} "
          f"visible; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # the kernel modules register themselves with the builder on import
    from repro_torch.kernels.decode_attention import ops as _d  # noqa: F401
    from repro_torch.kernels.flash_attention import ops as _f  # noqa: F401
    from repro_torch.kernels.gmm import ops as _g  # noqa: F401
    from repro_torch.kernels.mamba_scan import ops as _m  # noqa: F401
    from repro_torch.kernels.mlstm_scan import ops as _x  # noqa: F401
    from repro_torch.kernels.rmsnorm import ops as _r  # noqa: F401
    # ... and so do B11's, the runtime test kernel's and the generic
    # builds of the parity path
    from repro_torch.bench import parity
    secs = s.phase("build", build.build_all, parity.generic_jobs())
    if secs is not None:
        print(f"  {len(build.KERNELS)} kernels (and "
              f"{len(parity.generic_jobs())} generic builds) built by nvcc "
              f"in {secs:.2f} s "
              f"into {build.BUILD_DIR.relative_to(ROOT)}")
    for name, fn in (("rmsnorm", check_rmsnorm), ("flash", check_flash),
                     ("decode", check_decode), ("paged", check_paged),
                     ("quant paged", check_quant_paged),
                     ("spec paged", check_spec),
                     ("window paged (gemma2 shapes)", check_window),
                     ("head-dim-256 builds (gemma2 shapes)",
                      check_head_dim_256),
                     ("gmm (deepseek shapes)", check_gmm),
                     ("192/128 builds (deepseek shapes)", check_mla_builds),
                     ("mamba_scan (jamba shapes)", check_mamba_scan),
                     ("B1-B4 and gmm (jamba shapes)", check_jamba_shapes),
                     ("mlstm_scan (xlstm shapes)", check_mlstm_scan)):
        s.phase(f"kernel {name} against its plain version", fn, s)
    s.phase("portable runtime against native twins", run_parity, s)
    s.phase("SPEC ACCEL stand-ins on the device runtime", run_spec_accel, s)
    s.phase("miniQMC regions on the device runtime", run_miniqmc, s)
    torch.cuda.empty_cache()
    if s.failures:
        # a kernel that is wrong would make the serving run meaningless
        _die("failed before serving:\n  " + "\n  ".join(s.failures))
    serving = s.phase("serve granite-8b at full width", run_serving, s)
    torch.cuda.empty_cache()
    serving_g2 = s.phase("serve gemma2-2b at full width", run_serving_gemma2,
                         s)
    torch.cuda.empty_cache()
    serving_ds = s.phase("serve deepseek-v2-lite-16b at full width",
                         run_serving_deepseek, s)
    serving_jb = s.phase("serve jamba-1.5-large-398b at full width, "
                         f"{JB_LAYERS} layers", run_serving_jamba, s)
    serving_xl = s.phase("serve xlstm-1.3b at full width and depth, and "
                         "its loss", run_serving_xlstm, s)
    traces = s.phase("trace the card over paged decode steps", run_traces, s)

    for k in s.kernels.values():
        # the main path's count: the first serving run that launched it
        k["launches"] = next((n for n in k["launches_by_path"].values()
                              if n), 0)
    if serving is not None:
        print(json.dumps({"serving": serving}))
    if serving_g2 is not None:
        print(json.dumps({"serving_gemma2": serving_g2}))
    if serving_ds is not None:
        print(json.dumps({"serving_deepseek": serving_ds}))
    if serving_jb is not None:
        print(json.dumps({"serving_jamba": serving_jb}))
    if serving_xl is not None:
        print(json.dumps({"serving_xlstm": serving_xl}))
    if traces is not None:
        print(json.dumps({"device_busy_share": traces}))
    print(f"== total {time.perf_counter() - t_start:.1f} s, builds included")
    if s.failures:
        _die("failed:\n  " + "\n  ".join(s.failures))
    print(json.dumps({"kernels": list(s.kernels.values())}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
