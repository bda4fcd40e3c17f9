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
   timed at one split and at SPLIT_CHECK beside their served records;
   B3-B7q again with NaN in one K page (or K scale) of a slot and,
   separately, one V page (or V scale), a page neither the slot's first
   nor its last, at one split, the served count and SPLIT_CHECK: the same
   finiteness mask as their plain versions (the slot exactly 0 for K, NaN
   for V, the others finite), the finite values within TOL_F32; B1
   at granite's, gemma2's and jamba's
   rows in bf16 and f32 is held bit for bit to its native twin B11a and
   its generic build, and timed in turns with B11a and ``F.rms_norm``;
   all at each of their shapes: granite-8b's
   shapes (head dim 128), then gemma2-2b's (head dim 256): the
   sliding-window kernels over ring tables (bf16, int8, fp8) and the
   head-dim-256 builds of the prefill, dense, paged and quantized
   decode kernels, at lengths 1 to 8,192, rings wrapped and not; then
   gemma3-4b's (8/4 heads of 256) and gemma3-27b's (32/16 heads of 128):
   the norm over rows of d_model and, for qk-norm, of the head (a
   prefill group's and a decode step's, bit for bit with its twin and
   its generic build, timed beside ``F.rms_norm``), the prefill kernel
   at S 4,000 over the 1,024-token window and over none, and the dense
   (caches of 4,608 and rings of 1,024), paged and window kernels at a
   GQA group of 2, and for gemma3-4b the quantized paged and window
   kernels over int8 and fp8 pools; then deepseek-v2-lite-16b's: the grouped matmul of the MoE experts (the
   reference's example with masked rows, sizes 0 and C, the decode
   shape and the largest prefill's, timed beside ``torch.bmm``) and
   the Dk 192 / Dv 128 builds of the prefill, dense and paged decode
   kernels (MLA), of the quantized paged kernel over int8 and fp8 pools
   (also against bf16 B4 within DECODE_TOL, and over a pool whose every
   16-byte key chunk differs, so that a swizzle fault cannot hide) and
   of the speculative kernel at K1 5 over bf16 and int8 pools; then
   jamba-1.5-large-398b's: the selective scan of the
   mamba layers (the reference's example, then B 1 and 2 x S 17, 64,
   200 and 511 at d_inner 16384 and 16 states, bf16 with f32 A and D),
   and the norm, prefill, dense, paged and quantized paged (int8, fp8)
   decode kernels (64 query heads on 8 KV heads of 128) and the grouped
   matmul (16 experts of 8192 x
   24576) at its shapes; then arctic-480b's: the norm at 7,168, the
   prefill, dense and paged decode kernels at 56 query heads over 8 (a
   GQA group of 7 through the group-8 builds) and the grouped matmul
   over 128 experts of 7168 x 4864 at decode and at prefills of C 24
   and 80; then whisper-base's and internvl2-26b's: the norm at rows of
   512 and 6,144 (bit for bit with its twin), the prefill kernel
   non-causal at head dim 64 over 1,500 encoder frames (the encoder's
   self-attention, cross-attention from 416 queries and from one) and
   causal at 48/8 heads of 128, the dense decode kernel at whisper's 8/8
   heads of 64 over caches of 448, and the dense and paged decode
   kernels at internvl2's group of 6; then xlstm-1.3b's: the mLSTM scan with its
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
8. the same requests paged under injected faults (``serve/faults.py``),
   three runs: (a) bf16 pools at a random fault rate of 0.05 (seed 0)
   plus one scheduled fault of each kind, the watchdog at 10x the
   slowest unfaulted decode step (at least 1 s) and stalls of twice
   that; (b) int8 pools, a corrupted V scale page, then NaN logits on
   slot 0 at every step from 6 to 17 with 2 retries; (c) spec k = 4,
   NaN logits on slot 0 at steps 2 and 3, drafting disabled after 2
   faults; each audited after every step, every request done (with its
   32 tokens) or failed, the host copies one per decode step (discarded
   ones too), admitted group and page scan, the decode kernel 36 times
   per decode step, the teacher-forced gap of the done requests (bf16),
   and (a) a recovery of each kind, watchdog trips = stalls injected, a
   failure only where a random draw hit; (a), (b) pages quarantined and
   the pool drained to what quarantine left; (b) a request failed; (c) a
   request degraded to plain decode; printed as a ``serving_faults``
   line; then the SLO phase: a bursty trace of 40 requests in three
   classes (chat, longdoc, batch; priorities 2, 1, 0; prompts 26 to 896
   tokens, budgets up to 96) from ``serve/workload.py``'s generator,
   replayed on the engine's step clock through
   ``workload.replay(audit=True)``, eight runs: priority over an
   oversubscribed pool (1 + 48 pages) twice with telemetry and once
   without, lru, priority with the pool unconstrained, and sampled at
   temperature 0.8 with seed 0 twice and seed 1; after a check of the
   sampler's frequencies against softmax on the card; each run audited
   every step, every request done with its budget, one copy per decode
   step and admitted group, 36 B4 launches a decode step, the trace
   valid; the three priority runs' tokens, admission and preemption
   orders equal, the seeded runs' tokens equal and the other seed's
   not, a preemption at admission, the gap against an f32 forward, and
   the decisions (kind, request, slot, step) of the greedy and the
   sampled run equal to the port's engine on the CPU over the same
   trace; per-class TTFT in steps and seconds and telemetry's step cost
   reported; printed as a ``serving_slo`` line;
9. free granite-8b and serve 12 greedy requests of 17 to 6,000 tokens
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
10. free gemma2-2b and serve the 12 requests with prompts of 17 to
   4,000 tokens on ``gemma3-4b`` at full width and depth (34 layers,
   five local layers of a 1,024-token window to each global one,
   qk-norm, RoPE bases 1e4 local and 1e6 global; random from a seed),
   cache 4,608: paged (5 launches of the paged kernel and 29 of the
   window kernel per step), dense (34 of the dense kernel, rings on
   local layers), int8 and fp8 (5 of the quantized paged kernel and 29
   of the quantized window kernel, pool bytes per slot under 0.53 of
   bf16's); then on ``gemma3-27b`` at full width cut to 8 layers (7
   local, 1 global, mid-cycle), paged (1 and 7) and dense (8); each
   checked as phase 9, with the norm kernel launched 6 times a layer
   plus once per decode step and per admitted group (the q and k norms
   among them) and the prefill kernel once a layer per group; the
   teacher-forced gap checked for bf16 and reported for int8/fp8, the
   modes' token agreement reported;
11. free gemma3-27b and serve the same 12 requests as granite on
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
   then from int8 and fp8 pools (27 launches of the quantized kernel
   at 192/128 a step, the pool bytes per slot under 0.53 of bf16's, the
   gap reported) and speculating k = 4 over bf16 pools (27 launches of
   the speculative kernel a step, the gap checked, rejections > 0, and
   served a second time: the same tokens, since the dead slots' rows
   that land in one null-page row are kept in index order) and
   over int8 pools (the gap reported), each held to a plain replay of
   its own calls (the verify calls too, the gap over the rows emitted);
12. free deepseek-v2-lite-16b and serve the same 12 requests on
   ``arctic-480b`` at full width cut to 2 layers (GQA, 56 query heads
   over 8, each layer 128 experts top-2 of d_ff 4,864 plus a dense
   residual MLP; 27.7 B parameters, 55.4 GB; random weights from a
   seed), paged and dense: checked as phase 11, with 2 launches of the
   mode's decode kernel and 6 of the grouped matmul per decode step
   (and 6 per admitted group), peak memory reported;
13. free arctic-480b and serve the same 12 requests on
   ``jamba-1.5-large-398b`` at full width cut to 4 layers (an attention
   layer with a dense MLP, then three mamba layers, the first and third
   with 16 experts top-2 of d_ff 24,576; 23 B parameters, 46 GB; random
   weights from a seed), paged, dense and from int8 and fp8 pools (the
   attention layer's pools quantized, the mamba state dense): checked
   as phase 11, with 1 launch of the mode's decode kernel (the quantized
   one from int8/fp8) and 6 of the grouped matmul per decode step (and
   6 per admitted group), and 3 of the selective scan per admitted
   group and none in a decode step; the quantized runs' gap against
   their own replays and pool bytes per slot reported;
14. free jamba-1.5-large-398b and serve the same 12 requests on
   ``xlstm-1.3b`` at full width cut to 8 of its 48 layers (seven mLSTM,
   then one sLSTM; no attention layer; random from a seed),
   paged and dense, in bf16 and in f32, and paged with ``kv_dtype``
   int8 in bf16 (no pool to quantize: the paged run's tokens, token for
   token): checked as phase 4, with 7
   launches of the mLSTM scan per admitted group (every mLSTM layer's prefill,
   with its state output) and none in a decode step, and no attention
   kernel launched; then ``Model.loss`` of one batch of 2 x 512 tokens
   through the kernels (the mLSTM scan once per mLSTM layer) and
   through their plain versions, the two within XL_LOSS_TOL;
15. free xlstm-1.3b and drive ``whisper-base`` in full (6 encoder and 6
   decoder layers, d_model 512, 8/8 heads of 64; random from a seed)
   through its own entry points, since neither the engine nor the
   reference's takes an encoder input: 8 requests, each with 1,500
   encoder frames from the seed and a prompt of 17 to 416 tokens,
   prefilled by prompt-length group with ``encoder_embeds`` into dense
   caches, then 31 decode steps: every request's 32 tokens, one host copy
   per step and per group and no other sync in a decode step, per step 6
   launches of the dense decode kernel, 6 of the prefill kernel (the
   cross-attention's one-token query over the 1,500 encoder keys) and 19
   of the norm, per group 18 of the prefill kernel (encoder, causal,
   cross) and 32 of the norm, and the teacher-forced gap against a plain
   replay of the same calls (the reference's decode rotates the cross
   query at position 0, so a plain forward is not the same computation);
   ``Model.loss`` of 2 x 448 tokens with their frames through the
   kernels and their plain versions, within WH_LOSS_TOL;
16. free whisper-base and serve the 12 requests on ``internvl2-26b`` at
   full width and depth (48 layers, 48/8 heads of 128, d_ff 16,384; 19.9
   B parameters; random from a seed) paged and dense as phase 4 (48
   launches of the mode's decode kernel and 97 of the norm per step, 48
   of the prefill kernel and 97 of the norm per group), the gap checked
   against an f32 plain forward of the same weights and reported
   against the bf16 plain forward and the bf16 plain replay of the
   run's own calls; then its vision
   splice through the model's entry points: 2 prompts of 512 tokens whose
   first 256 positions carry patch embeddings from the seed, checked as
   phase 15 against its plain replay; ``Model.loss`` of that batch with
   the patch positions' labels masked, within IV_LOSS_TOL;
17. trace five paged decode steps of each model for the card's busy
   share (reported, not checked); a profiler that cannot start fails the
   phase.

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
G2 = dict(hq=G2_HQ, hkv=G2_HKV, d=G2_D)
# gemma3: five local layers of a 1,024-token window to each global one,
# qk-norm (B1 over rows of the head) and a RoPE base of 10,000 on local
# layers, 1e6 on global ones; no softcap.  gemma3-4b: 8 query / 4 KV
# heads of 256 over d_model 2560, served at its full 34 layers (4.3 B
# parameters, under 10 GB in bf16); gemma3-27b: 32 / 16 heads of 128 over
# d_model 5376, cut to 8 of its 62 layers (one period and two local
# layers, so that it ends mid-cycle as 62 = 10 x 6 + 2 does).  Prompts of
# 1,000 tokens decode past the window; 2,100 and 4,000 start with rings
# wrapped two and three times.
G3_PROMPT_LENS = (17, 1000, 2100, 4000)
G3_CACHE_LEN, G3_WINDOW, G3_27B_LAYERS = 4608, 1024, 8
# (query heads, KV heads, head dim, d_model) of each
G3_SHAPES = {"gemma3-4b": (8, 4, 256, 2560),
             "gemma3-27b": (32, 16, 128, 5376)}
# decode lengths of the gemma3 kernel checks: inside the window, at its
# edge and one past it, rings wrapped, and the last row of the cache
G3_LENGTHS = (1, 17, 1000, 1024, 1025, 2101, 4001, 4608)
G3_FLASH_S = 4000             # the longest prompt
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
# arctic-480b at full width, cut to 2 of its 35 layers (one layer is 13.61
# B parameters, 27.2 GB in bf16: 2 layers and the embeddings make 55.4
# GB, 3 would not fit the card): 56 query / 8 KV heads of 128 (a GQA
# group of 7) over d_model 7168; on every layer 128 experts top-2 of
# d_ff 4864 and a dense residual MLP of d_ff 4864
AR_LAYERS, AR_HQ, AR_HKV, AR_DM = 2, 56, 8, 7168
AR_E, AR_TOPK, AR_FF = 128, 2, 4864
# B8's capacity at a prefill of 8 x 511 tokens (ceil(4088 x 2 / 128 x
# 1.25) = 80): a batch the served runs' groups of 2 do not reach
AR_C_PREFILL = 80
# xlstm-1.3b at full width: d_model 2048, mLSTM d_inner 4096 in 4 heads
# of 1024, so B10 runs at Dk = Dv = 1024.  Served and its loss taken at
# 8 of its 48 layers (one of its six periods of seven mLSTM and one
# sLSTM): the whole depth took 281 s of the run's 1,200, 16 layers 122 s
# on a slow host once gemma3's phases came, and the run's time is
# held under 1,000 s
XL_H, XL_D, XL_LAYERS = 4, 1024, 8
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
# whisper-base in full: 6 encoder and 6 decoder layers, d_model 512, 8
# query heads over 8 of 64 (a GQA group of 1), vocabulary 51,865.  Eight
# requests, each with 1,500 encoder frames from the seed (1,500 is
# openai/whisper-base's max_source_positions: 30 s of audio) and a
# decoder prompt of 17 to 416 tokens, then 32 greedy tokens, inside the
# model's 448 target positions.  The engine takes no encoder input (nor
# does the reference's), so the model's own prefill and decode_step
# drive it, prompt-length groups into slot rows as the dense engine does.
WH_FRAMES, WH_CACHE_LEN, WH_REQUESTS = 1500, 448, 8
WH_PROMPT_LENS = (17, 64, 200, 416)
# the dense decode kernel's check lengths: a short prompt's first
# step, served lengths, and the last row of the cache
WH_LENGTHS = (1, 17, 64, 100, 200, 300, 416, 448)
# internvl2-26b at full width and depth (48 layers, 48 query heads over 8
# of 128, a GQA group of 6; d_ff 16,384; 19.9 B parameters, 39.7 GB in
# bf16): served paged and dense on the 12 text requests, then the
# vision splice: 2 prompts of 512 tokens whose first 256 positions carry
# patch embeddings from the seed, through prefill and 32 decode steps
IV_SPLICE_B, IV_SPLICE_S = 2, 512
# Model.loss of whisper and internvl2 in bf16, through the kernels and
# through their plain versions: each limit about ten times the
# difference its sound run read (2.384e-5 and 7.048e-4 on an H100, PERF.md
# §2): with random labels the mean cross-entropy follows the logits'
# spread more than which token they favour, so a limit near the
# teacher-forced gap's would let a kernel that keeps the scale pass
WH_LOSS_TOL = 3e-4
IV_LOSS_TOL = 7e-3
# decode steps traced for the card's busy share: all 8 slots decoding,
# none admitting (8 requests admitted at step 1 finish at step 32)
PROFILED_STEPS = (10, 15)
# the fault phase (granite-8b, paged): the random draws of run (a), one
# scheduled fault of each kind at these steps, the watchdog's deadline
# as a multiple of the slowest decode step of the unfaulted paged run
# (at least WATCHDOG_MIN_S), and a stall of twice the deadline
FAULT_RATE, FAULT_SEED = 0.05, 0
FAULT_STEPS = (("kv_corrupt", 3), ("nan_logits", 6), ("alloc_fail", 9),
               ("stall", 12))
WATCHDOG_STEPS, WATCHDOG_MIN_S = 10, 1.0
# the SLO phase (granite-8b paged, 8 slots, pages of 64): a bursty trace
# (gamma arrivals at SLO_RATE a step, squared CV SLO_BURSTINESS) of
# SLO_REQUESTS requests in three classes, token ids below SLO_VOCAB (ids
# granite and the CPU smoke model both embed), replayed on the engine's
# step clock; "oversubscribed" is SLO_PAGES = 1 + 48 pages, 0.375 of the
# 128-page working set and above the 16 pages the largest request ends
# with (896 + 96 tokens)
SLO_REQUESTS, SLO_RATE, SLO_BURSTINESS, SLO_SEED = 40, 0.3, 4.0, 0
SLO_VOCAB, SLO_MAX_NEW, SLO_PAGES, SLO_TEMPERATURE = 256, 96, 1 + 48, 0.8
# (name, priority, mix, prompt mean, sigma, lo, hi, out mean, sigma, lo,
# hi): serve/workload.py's TrafficClass, capped to fit CACHE_LEN
SLO_CLASSES = (("chat", 2, 0.5, 128, 0.6, 16, 512, 24, 0.5, 4, 64),
               ("longdoc", 1, 0.2, 640, 0.3, 256, 896, 16, 0.4, 4, 64),
               ("batch", 0, 0.3, 192, 0.7, 32, 512, 48, 0.5, 16, 96))
# the sampler's check: draws from one 32-way row, each class's frequency
# within SAMPLER_SE standard errors of softmax(logits / T)
SAMPLER_DRAWS, SAMPLER_SE = 1 << 18, 5.0


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


def _decode_shapes(s: Smoke, key, lengths, s_len, hq, hkv, d, quant):
    """B3 over dense caches of ``s_len`` rows and B4 over the same rows
    in scrambled pages (and, with ``quant``, B5 over them in int8 and
    fp8) at 8 slots of ``lengths``, ``hq`` query heads over ``hkv`` of
    ``d``: each by its split rule against its plain version, timed at
    its served split count and at 1 and SPLIT_CHECK beside its bound and
    SDPA (B3), into each record under ``key``.  Returns the query and
    the dense caches for the caller's own checks."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads = dict(hq=hq, hkv=hkv, d=d)
    grp = f"{key}: B 8, {hq}/{hkv} x {d}"
    rkw = dict(return_residuals=True)
    q, kc, vc, ln = _decode_operands(s, lengths, s_len=s_len, **heads)
    got = check_split_decode(s, f"decode ({grp}, cache {s_len})", q, kc, vc,
                             ln)
    want = ref.decode_attention_ref(q, kc, vc, ln, **rkw)
    s.compare(f"decode residuals ({grp})", got, want)
    err = s.compare(f"decode group {hq // hkv} output acc / l ({grp})",
                    _normalized(got), _normalized(want))
    nbytes, flops = _decode_cost(lengths, **heads)
    mask = (torch.arange(s_len, device=s.dev)[None, :]
            < ln[:, None])[:, None, None, :]
    plain_ms = s.time_ms(lambda: ref.decode_attention_ref(q, kc, vc, ln,
                                                          **rkw))
    library_ms = s.time_ms(lambda: sdpa(q[:, :, None], kc, vc,
                                        attn_mask=mask, enable_gqa=True))
    s.record_also("decode_attention", key, err,
                  s.time_ms(lambda: ops.decode_attention(q, kc, vc, ln,
                                                         **rkw)),
                  plain_ms, nbytes, flops, library_ms)
    _split_timings(s, "decode_attention", key,
                   lambda n: ops.decode_attention(q, kc, vc, ln, splits=n,
                                                  **rkw),
                   plain_ms, nbytes, flops, library_ms)
    kp, vp, bt = _pages(s, kc, vc, lengths, PAGE)
    got = check_split_paged(s, f"paged ({grp}, table {tuple(bt.shape)})",
                            q, kp, vp, bt, ln)
    want = ref.paged_decode_attention_ref(q, kp, vp, bt, ln, **rkw)
    s.compare(f"paged residuals ({grp})", got, want)
    err = s.compare(f"paged group {hq // hkv} output acc / l ({grp})",
                    _normalized(got), _normalized(want))
    live_pages = sum(-(-n // PAGE) for n in lengths)
    plain_ms = s.time_ms(lambda: ref.paged_decode_attention_ref(
        q, kp, vp, bt, ln, **rkw))
    s.record_also("paged_decode_attention", key, err,
                  s.time_ms(lambda: ops.paged_decode_attention(
                      q, kp, vp, bt, ln, **rkw)),
                  plain_ms, nbytes + 4 * live_pages, flops, None)
    _split_timings(s, "paged_decode_attention", key,
                   lambda n: ops.paged_decode_attention(
                       q, kp, vp, bt, ln, splits=n, **rkw),
                   plain_ms, nbytes + 4 * live_pages, flops)
    if quant:
        nbytes, flops = _decode_cost(lengths, 1, **heads)
        nbytes += live_pages * (2 * hkv * 4 + 4)
        for kv in ("int8", "fp8_e4m3"):
            kq, vq, ks, vs = _quantize(s, kp, vp, kv)
            args = (q, kq, vq, ks, vs, bt, ln)
            got = check_split_quant(s, f"quant paged {kv} ({grp})", args)
            want = ref.quant_paged_decode_attention_ref(*args, **rkw)
            s.compare(f"quant paged {kv} residuals ({grp})", got, want)
            err = s.compare(f"quant paged {kv} output acc / l ({grp})",
                            _normalized(got), _normalized(want))
            plain_ms = s.time_ms(lambda: ref.quant_paged_decode_attention_ref(
                *args, **rkw))
            times = (s.time_ms(lambda: ops.quant_paged_decode_attention(
                         *args, **rkw)),
                     plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
            if kv == "int8":
                s.record_also("quant_paged_decode_attention", key, err,
                              *times)
            else:
                s.timings(f"quant_paged_decode_attention ({kv}, {key})",
                          *times)
            del kq, vq
    del kp, vp, bt
    return q, kc, vc, ln


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

def _ring_pools(s: Smoke, lengths, window=G2_WINDOW, hq=G2_HQ, hkv=G2_HKV,
                d=G2_D, seed=7):
    """Window pools at a model's decode shapes (by default gemma2's:
    (4, 1 + 8 T_w, 64, 256) bf16 pools and (8, T_w) ring tables, T_w =
    65), mapping each slot's live window pages to scrambled pages
    (global page g at column g % T_w; null elsewhere)."""
    torch = s.torch
    from repro_torch.serve.paging import live_window_pages, window_table_width
    tw = window_table_width(window, PAGE)
    b = len(lengths)
    perm = (torch.randperm(b * tw, generator=torch.Generator().manual_seed(6))
            + 1).tolist()
    bt = torch.zeros(b, tw, dtype=torch.int32)
    for i, n in enumerate(lengths):
        for gp in live_window_pages(n, window, PAGE):
            bt[i, gp % tw] = perm.pop()
    g = torch.Generator(device=s.dev).manual_seed(seed)
    kp, vp = (torch.randn(hkv, 1 + b * tw, PAGE, d, device=s.dev,
                          generator=g).bfloat16() for _ in range(2))
    q = torch.randn(b, hq, d, device=s.dev, generator=g).bfloat16()
    ln = torch.tensor(lengths, dtype=torch.int32, device=s.dev)
    return q, kp, vp, bt.to(s.dev), ln


def _window_cost(lengths, kv_bytes: int = 2, scale_bytes: int = 0,
                 window=G2_WINDOW, heads=G2):
    """What the window kernels must read and write: the window's live
    tokens, min(L, window) per slot, a table entry (and the scales) per
    live page, q and the f32 residuals; the flops of those tokens."""
    from repro_torch.serve.paging import live_window_pages
    live = [min(n, window) for n in lengths]
    nbytes, flops = _decode_cost(live, kv_bytes, **heads)
    pages = sum(len(live_window_pages(n, window, PAGE)) for n in lengths)
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


def _nan_compare(s: Smoke, what, got, want):
    """The NaN law's comparison: the residuals (acc, m, l) and acc / l of
    a kernel and of its plain version have the same finiteness mask, and
    their finite values agree within TOL_F32 (the f32 residuals' tol);
    returns the kernel's acc / l."""
    torch = s.torch

    def norm(res):
        return res[0] / torch.where(res[2] == 0, 1.0, res[2])[..., None]

    ok, err = True, 0.0
    for a, w in zip(tuple(got) + (norm(got),), tuple(want) + (norm(want),)):
        fa, fw = torch.isfinite(a), torch.isfinite(w)
        if not torch.equal(fa, fw):
            ok = False
            continue
        if fa.any():
            err = max(err, float((a[fa] - w[fw]).abs().max()))
            ok &= bool(torch.allclose(a[fa], w[fw], atol=TOL_F32,
                                      rtol=TOL_F32))
    out = norm(got)
    s.check(ok, f"{what}: finiteness masks equal "
                f"({int((~torch.isfinite(out)).sum())} non-finite outputs), "
                f"finite values within {TOL_F32} (max abs diff {err:.3e})")
    return out


def _nan_splits(s: Smoke, what, kernel, run, plain, served, chunk_of, slot,
                kside):
    """A split-KV kernel on operands with NaN in one K-side or V-side page
    of ``slot`` that is neither its first nor its last, at one split, at
    the served count and at SPLIT_CHECK, each against its plain version
    (unsplit at one split, else split: its rounding model): the slot
    comes out exactly 0 for a K-side NaN (m NaN, p and l 0, as jnp.max
    leaves the reference's), NaN for a V-side one, every other slot
    finite."""
    torch = s.torch
    for n in sorted({1, served, SPLIT_CHECK}):
        before = kernel.launches
        got = run(n)
        s.check(kernel.launches == before + 1,
                f"{what}: {n} split(s) in one launch")
        out = _nan_compare(s, f"{what}, {n} split(s)", got,
                           plain(None if n == 1 else chunk_of(n)))
        rest = torch.cat([out[:slot], out[slot + 1:]])
        hit = (bool((out[slot] == 0).all()) if kside
               else bool(torch.isnan(out[slot]).all()))
        s.check(hit and bool(torch.isfinite(rest).all()),
                f"{what}, {n} split(s): slot {slot} "
                f"{'exactly 0' if kside else 'NaN'}, every other slot "
                f"finite")


def check_nan_law(s: Smoke) -> None:
    """B3-B7q at the served shapes with NaN in one K page (or K scale) of
    a slot and, separately, in one V page (or V scale), a page neither
    the slot's first nor its last: the kernels take the reference's K/V
    NaN semantics (:func:`_nan_splits`).  granite's shapes for B3 (slot 7,
    1,024 rows, rows 320-383), B4 and B5 (int8, fp8; slot 7's sixth
    page) and B6 (bf16, int8; slot 6's sixth page, K1 5); gemma2's rings
    for B7 and B7q (int8, fp8; the middle of slot 5's 65 live pages)."""
    from repro_torch.kernels.decode_attention import decode_attention as dk
    from repro_torch.kernels.decode_attention import ops, paged, quant, \
        ref, spec
    from repro_torch.serve.paging import live_window_pages
    nan = float("nan")
    q, kc, vc, ln = _decode_operands(s, DECODE_LENGTHS)
    kp, vp, bt = _pages(s, kc, vc, DECODE_LENGTHS, PAGE)
    reach = bt.shape[1] * PAGE
    paged_n = dk.paged_splits(reach, PAGE)

    def chunk(n):
        return dk.split_chunk(reach, n, PAGE)

    page = int(bt[7, 5])
    for side in ("K", "V"):
        k, v = kc.clone(), vc.clone()
        (k if side == "K" else v)[7, :, 320:384] = nan
        _nan_splits(s, f"B3 decode, NaN in slot 7's {side} rows 320-383",
                    dk.KERNEL, lambda n: ops.decode_attention(
                        q, k, v, ln, splits=n, return_residuals=True),
                    lambda c: ref.decode_attention_ref(
                        q, k, v, ln, chunk=c, return_residuals=True),
                    dk.decode_splits(CACHE_LEN),
                    lambda n: dk.split_chunk(CACHE_LEN, n), 7, side == "K")
        k, v = kp.clone(), vp.clone()
        (k if side == "K" else v)[:, page] = nan
        _nan_splits(s, f"B4 paged, NaN in slot 7's sixth {side} page",
                    paged.KERNEL, lambda n: ops.paged_decode_attention(
                        q, k, v, bt, ln, splits=n, return_residuals=True),
                    lambda c: ref.paged_decode_attention_ref(
                        q, k, v, bt, ln, chunk=c, return_residuals=True),
                    paged_n, chunk, 7, side == "K")
        for kv in ("int8", "fp8_e4m3"):
            kq, vq, ks, vs = _quantize(s, kp, vp, kv)
            (ks if side == "K" else vs)[:, page] = nan
            args = (q, kq, vq, ks, vs, bt, ln)
            _nan_splits(
                s, f"B5 {kv}, NaN in the {side} scale of slot 7's sixth "
                   f"page", quant.KERNEL,
                lambda n: ops.quant_paged_decode_attention(
                    *args, splits=n, return_residuals=True),
                lambda c: ref.quant_paged_decode_attention_ref(
                    *args, chunk=c, return_residuals=True),
                paged_n, chunk, 7, side == "K")
    k1 = SPEC_K + 1
    g = s.torch.Generator(device=s.dev).manual_seed(5)
    sq = s.torch.randn(len(SPEC_BASES), k1, 32, 128, device=s.dev,
                       generator=g).bfloat16()
    skp, svp, sbt = _pages(s, kc, vc, [n + k1 for n in SPEC_BASES], PAGE)
    base = s.torch.tensor(SPEC_BASES, dtype=s.torch.int32, device=s.dev)
    page = int(sbt[6, 5])
    for side in ("K", "V"):
        for kv in (None, "int8"):
            if kv is None:
                k, v = skp.clone(), svp.clone()
                (k if side == "K" else v)[:, page] = nan
                args = (sq, k, v, sbt, base)
                fn, plain = (ops.spec_paged_decode_attention,
                             ref.spec_paged_decode_attention_ref)
            else:
                kq, vq, ks, vs = _quantize(s, skp, svp, kv)
                (ks if side == "K" else vs)[:, page] = nan
                args = (sq, kq, vq, ks, vs, sbt, base)
                fn, plain = (ops.quant_spec_paged_decode_attention,
                             ref.quant_spec_paged_decode_attention_ref)
            _nan_splits(
                s, f"B6 spec K1 {k1} {kv or 'bf16'}, NaN in slot 6's sixth "
                   f"{side} page{' scale' if kv else ''}", spec.KERNEL,
                lambda n: fn(*args, splits=n, return_residuals=True),
                lambda c: plain(*args, chunk=c, return_residuals=True),
                paged_n, chunk, 6, side == "K")
    q, kp, vp, bt, ln = _ring_pools(s, G2_LENGTHS)
    live = list(live_window_pages(G2_LENGTHS[5], G2_WINDOW, PAGE))
    page = int(bt[5, live[len(live) // 2] % bt.shape[1]])
    kw = dict(window=G2_WINDOW, softcap=G2_SOFTCAP)
    reach = bt.shape[1] * PAGE
    for side in ("K", "V"):
        for kv in (None, "int8", "fp8_e4m3"):
            if kv is None:
                k, v = kp.clone(), vp.clone()
                (k if side == "K" else v)[:, page] = nan
                args, kern = (q, k, v, bt, ln), paged.WINDOW_KERNEL
                fn, plain = (ops.window_paged_decode_attention,
                             ref.window_paged_decode_attention_ref)
            else:
                kq, vq, ks, vs = _quantize(s, kp, vp, kv)
                (ks if side == "K" else vs)[:, page] = nan
                args = (q, kq, vq, ks, vs, bt, ln)
                kern = paged.QUANT_WINDOW_KERNEL
                fn, plain = (ops.quant_window_paged_decode_attention,
                             ref.quant_window_paged_decode_attention_ref)
            _nan_splits(
                s, f"{'B7q ' + kv if kv else 'B7'} gemma2 window, NaN in "
                   f"the middle {side} page{' scale' if kv else ''} of slot "
                   f"5's live window", kern,
                lambda n: fn(*args, splits=n, return_residuals=True, **kw),
                lambda c: plain(*args, chunk=c, return_residuals=True, **kw),
                dk.paged_splits(reach, PAGE),
                lambda n: dk.split_chunk(reach, n, PAGE), 5, side == "K")


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


# ------------------------------------------------- gemma3 kernels -----

def check_gemma3_shapes(s: Smoke) -> None:
    """The kernels of gemma3's path at its shapes, each against its
    plain version, timed beside its bound and library call, into each
    record under "gemma3-4b" or "gemma3-27b": B1 over the largest
    prefill group's rows of d_model and of the head (qk-norm: 2 x 4,000
    tokens times the query heads, rows of 256 or 128; bit for bit with
    its twin B11a and its generic build) and over one decode step's
    heads; B2 causal at S 4,000 over the window of 1,024 (local layers)
    and over none (global); B3 over caches of 4,608 (global layers) and
    rings of 1,024 (local ones), B4 over page tables of 72 pages, B7
    over ring tables of the window at lengths up to 4,608, each by its
    split rule; for gemma3-4b, also B5 and B7q over int8 and fp8 pools.
    Both at a GQA group of 2."""
    for key, (hq, hkv, d, dm) in G3_SHAPES.items():
        _gemma3_norm_and_flash(s, key, hq, hkv, d, dm)
        _gemma3_decode(s, key, hq, hkv, d, quant=key == "gemma3-4b")


def _gemma3_norm_and_flash(s: Smoke, key, hq, hkv, d, dm):
    torch = s.torch
    from repro_torch.core.context import target
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import native
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rms = torch.nn.functional.rms_norm
    g = torch.Generator(device=s.dev).manual_seed(19)
    kw = dict(eps=1e-6, weight_offset=1.0)
    b, n = 2, G3_FLASH_S

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g,
                           dtype=torch.bfloat16)

    # B1 at d_model, then at the head over q's rows (qk-norm), then over
    # one decode step's q heads
    for what, x in (("", rnd(b * n, dm)), (" q-norm", rnd(b, hq, n, d)),
                    (" q-norm decode", rnd(SLOTS, hq, d))):
        w = 0.5 * rnd(x.shape[-1])
        rows, width = x.numel() // x.shape[-1], x.shape[-1]
        label = f"rmsnorm {key}{what} ({rows}, {width}) bf16"
        got = rops.rmsnorm(x, w, **kw)
        err = s.compare(label, got, rref.rmsnorm_ref(x, w, **kw))
        with target("generic"):
            generic = rops.rmsnorm(x, w, **kw)
        s.check(bool(torch.equal(got, native.rmsnorm_native(x, w, **kw))
                     and torch.equal(got, generic)),
                f"{label}: B1, B11a and B1's generic build bit for bit")
        times = (s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
                 s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
                 2 * x.numel() * 2 + 2 * width, 4 * x.numel(),
                 s.time_ms(lambda: rms(x, (width,), w + 1.0, 1e-6)))
        if what == " q-norm decode":
            s.timings(f"rmsnorm ({key}{what})", *times)
        else:
            s.record_also("rmsnorm", key + what, err, *times)
        del x, got, generic
    # B2: checked at B 1 (the plain version holds S x S scores), timed
    # at B 2 x S 4,000, the largest group; local layers' window first
    one = (rnd(1, hq, n, d), rnd(1, hkv, n, d), rnd(1, hkv, n, d))
    err = 0.0
    for what, window in (("local", G3_WINDOW), ("global", None)):
        fkw = dict(window=window)
        label = f"flash {key} (1, {hq}/{hkv}, {n}, {d}) causal, {what}"
        err = max(err, s.compare(label, fops.flash_attention(*one, **fkw),
                                 fref.flash_attention_ref(*one, **fkw)))
        operands_model(s, label, one, fkw)
    del one
    two = (rnd(b, hq, n, d), rnd(b, hkv, n, d), rnd(b, hkv, n, d))
    pos = torch.arange(n, device=s.dev)
    band = ((pos[None, :] <= pos[:, None])
            & (pos[None, :] > pos[:, None] - G3_WINDOW))
    pairs = sum(min(i + 1, G3_WINDOW) for i in range(n))
    nbytes = 2 * b * hq * n * d * 2 + 2 * b * hkv * n * d * 2
    s.record_also("flash_attention", key, err,
                  s.time_ms(lambda: fops.flash_attention(
                      *two, window=G3_WINDOW)),
                  s.time_ms(lambda: fref.flash_attention_ref(
                      *two, window=G3_WINDOW)),
                  nbytes, 4 * b * hq * d * pairs,
                  s.time_ms(lambda: sdpa(*two, attn_mask=band,
                                         enable_gqa=True)))
    s.timings(f"flash_attention ({key} global)",
              s.time_ms(lambda: fops.flash_attention(*two)),
              s.time_ms(lambda: fref.flash_attention_ref(*two)),
              nbytes, 4 * b * hq * d * n * (n + 1) // 2,
              s.time_ms(lambda: sdpa(*two, is_causal=True, enable_gqa=True)))
    del two, band


def _gemma3_decode(s: Smoke, key, hq, hkv, d, quant):
    from repro_torch.kernels.decode_attention import ops, paged, ref
    from repro_torch.quant import DECODE_TOL
    heads = dict(hq=hq, hkv=hkv, d=d)
    grp = f"{key}: B 8, {hq}/{hkv} x {d}"
    rkw = dict(return_residuals=True)
    # B3 over the global layers' caches of 4,608 (and the local layers'
    # rings of the window), B4 over the global layers' pages, B5 over
    # them quantized
    q, kc, vc, ln = _decode_shapes(s, key, G3_LENGTHS, G3_CACHE_LEN, hq, hkv,
                                   d, quant)
    ring_ln = ln.clamp(max=G3_WINDOW)
    ring = (kc[:, :, :G3_WINDOW].contiguous(),
            vc[:, :, :G3_WINDOW].contiguous())
    del kc, vc
    check_split_decode(s, f"decode over a ring of {G3_WINDOW} ({grp})", q,
                       *ring, ring_ln)
    rnb, rfl = _decode_cost(ring_ln.tolist(), **heads)
    s.timings(f"decode_attention ({key} ring of {G3_WINDOW})",
              s.time_ms(lambda: ops.decode_attention(q, *ring, ring_ln,
                                                     **rkw)),
              s.time_ms(lambda: ref.decode_attention_ref(q, *ring, ring_ln,
                                                         **rkw)),
              rnb, rfl, None)
    del q, ring
    # B7 (and B7q) over the local layers' ring tables
    q, kp, vp, bt, ln = _ring_pools(s, G3_LENGTHS, window=G3_WINDOW, seed=20,
                                    **heads)
    wkw = dict(window=G3_WINDOW)
    got = check_split_window(
        s, f"window ({grp}, window {G3_WINDOW}, lengths 1..{G3_CACHE_LEN})",
        (q, kp, vp, bt, ln), ops.window_paged_decode_attention,
        ref.window_paged_decode_attention_ref, paged.WINDOW_KERNEL, **wkw)
    want = ref.window_paged_decode_attention_ref(q, kp, vp, bt, ln, **rkw,
                                                 **wkw)
    s.compare(f"window residuals ({grp})", got, want)
    err = s.compare(f"window output acc / l ({grp})", _normalized(got),
                    _normalized(want))
    bf16 = _normalized(got)
    nbytes, flops = _window_cost(G3_LENGTHS, window=G3_WINDOW, heads=heads)
    plain_ms = s.time_ms(lambda: ref.window_paged_decode_attention_ref(
        q, kp, vp, bt, ln, **rkw, **wkw))
    s.record_also("window_paged_decode_attention", key, err,
                  s.time_ms(lambda: ops.window_paged_decode_attention(
                      q, kp, vp, bt, ln, **rkw, **wkw)),
                  plain_ms, nbytes, flops, None)
    _split_timings(s, "window_paged_decode_attention", key,
                   lambda n: ops.window_paged_decode_attention(
                       q, kp, vp, bt, ln, splits=n, **rkw, **wkw),
                   plain_ms, nbytes, flops)
    if not quant:
        return
    nbytes, flops = _window_cost(G3_LENGTHS, 1, 2 * hkv * 4,
                                 window=G3_WINDOW, heads=heads)
    for kv in ("int8", "fp8_e4m3"):
        kq, vq, ks, vs = _quantize(s, kp, vp, kv)
        args = (q, kq, vq, ks, vs, bt, ln)
        got = check_split_window(
            s, f"quant window {kv} ({grp})", args,
            ops.quant_window_paged_decode_attention,
            ref.quant_window_paged_decode_attention_ref,
            paged.QUANT_WINDOW_KERNEL, **wkw)
        want = ref.quant_window_paged_decode_attention_ref(*args, **rkw,
                                                           **wkw)
        s.compare(f"quant window {kv} residuals ({grp})", got, want)
        err = s.compare(f"quant window {kv} output acc / l ({grp})",
                        _normalized(got), _normalized(want))
        gap = float((_normalized(got) - bf16).abs().max())
        s.check(gap <= DECODE_TOL[kv],
                f"quant window {kv} ({key}) against bf16 window on the "
                f"unquantized data: max abs diff {gap:.4f} <= DECODE_TOL "
                f"{DECODE_TOL[kv]}")
        plain_ms = s.time_ms(
            lambda: ref.quant_window_paged_decode_attention_ref(
                *args, **rkw, **wkw))
        times = (s.time_ms(lambda: ops.quant_window_paged_decode_attention(
                     *args, **rkw, **wkw)),
                 plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
        if kv == "int8":
            s.record_also("quant_window_paged_decode_attention", key, err,
                          *times)
        else:
            s.timings(f"quant_window_paged_decode_attention ({kv}, {key})",
                      *times)


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
    """The Dk 192 / Dv 128 builds of B2, B3, B4, B5 (int8, fp8) and B6
    (bf16, int8) at deepseek's serving shapes (16 query heads on 16 kv
    heads), against their plain versions; their times go into each
    kernel's record under "deepseek"."""
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
    bf16 = _normalized(ops.paged_decode_attention(qd, kp, vp, bt, ln, **kw))
    check_mla_quant(s, qd, kp, vp, bt, ln, bf16)
    del kp, vp
    check_mla_spec(s, kc, vc, rnd)


def _distinct_keys(s: Smoke, b, h, n, d):
    """A (b, h, n, d) bf16 key cache whose every 16-element chunk (one
    16-byte chunk of a 1-byte pool's row) holds its own value: 251
    consecutive chunks of a head apart, heads shifted, so that a chunk
    the stage's swizzle put in another token's row changes the
    scores."""
    torch = s.torch
    t = torch.arange(n, device=s.dev)[:, None]
    c = torch.arange(d // 16, device=s.dev)[None, :]
    hh = torch.arange(h, device=s.dev)[:, None, None]
    val = ((t * (d // 16) + c)[None] * 7 + hh * 3) % 251 - 125.0
    return (val.repeat_interleave(16, -1) / 125.0).expand(
        b, -1, -1, -1).bfloat16().contiguous()


def check_mla_quant(s: Smoke, qd, kp, vp, bt, ln, bf16):
    """B5's 192/128 build (twelve 16-byte chunks a 1-byte key row: the
    stage swizzles 4 tokens) over deepseek's pools quantized to int8
    and fp8, and over a pool of distinct key chunks: by
    :func:`check_split_quant` (one split, the served count and
    SPLIT_CHECK, against ``quant_paged_decode_attention_ref(chunk=...)``),
    against bf16 B4 on the unquantized data (``bf16``) within
    DECODE_TOL, timed at one split, the served count and SPLIT_CHECK
    beside its bound; int8's times go into B5's record under
    "deepseek"."""
    from repro_torch.kernels.decode_attention import ops, ref
    from repro_torch.quant import DECODE_TOL
    scale = DS_DK ** -0.5
    kw = dict(scale=scale, return_residuals=True)
    live = sum(DECODE_LENGTHS)
    live_pages = sum(-(-n // PAGE) for n in DECODE_LENGTHS)
    # q, one byte per live K/V element, the K and V scales and a table
    # entry per live page, lengths, the f32 residuals
    nbytes = (qd.numel() * 2 + live * DS_H * (DS_DK + DS_DV)
              + live_pages * (2 * DS_H * 4 + 4) + 4 * SLOTS
              + SLOTS * DS_H * (DS_DV + 2) * 4)
    flops = 2 * DS_H * (DS_DK + DS_DV) * live
    for kv in ("int8", "fp8_e4m3"):
        kq, vq, ks, vs = _quantize(s, kp, vp, kv)
        args = (qd, kq, vq, ks, vs, bt, ln)
        what = f"quant paged {kv} (B 8, 16/16 x 192/128, page 64)"
        got = check_split_quant(s, what, args, scale=scale)
        check_split_quant(s, f"quant paged {kv} 192/128, logical page 16 "
                             f"of 64", args, page_size=16, scale=scale)
        want = ref.quant_paged_decode_attention_ref(*args, **kw)
        err = s.compare(f"quant paged {kv} 192/128 output acc / l",
                        _normalized(got), _normalized(want))
        gap = float((_normalized(got) - bf16).abs().max())
        s.check(gap <= DECODE_TOL[kv],
                f"quant paged {kv} 192/128 against bf16 paged on the "
                f"unquantized data: max abs diff {gap:.4f} <= DECODE_TOL "
                f"{DECODE_TOL[kv]}")
        # the same table (``_pages`` scrambles by a fixed seed)
        kd = _distinct_keys(s, SLOTS, DS_H, CACHE_LEN, DS_DK)
        kdp = _pages(s, kd, kd, DECODE_LENGTHS, PAGE)[0]
        kdq, _, kds, _ = _quantize(s, kdp, vp, kv)
        check_split_quant(s, f"quant paged {kv} 192/128, every 16-byte key "
                             f"chunk distinct",
                          (qd, kdq, vq, kds, vs, bt, ln), scale=scale)
        del kd, kdp, kdq
        plain_ms = s.time_ms(lambda: ref.quant_paged_decode_attention_ref(
            *args, **kw))
        times = (s.time_ms(lambda: ops.quant_paged_decode_attention(
                     *args, **kw)),
                 plain_ms, nbytes, flops, None, INT8_OPS_PER_S)
        if kv == "int8":
            s.record_also("quant_paged_decode_attention", "deepseek", err,
                          *times)
        else:
            s.timings(f"quant_paged_decode_attention (deepseek {kv})",
                      *times)
        _split_timings(s, "quant_paged_decode_attention", f"deepseek {kv}",
                       lambda n: ops.quant_paged_decode_attention(
                           *args, splits=n, **kw),
                       plain_ms, nbytes, flops, ops_per_s=INT8_OPS_PER_S)


def check_mla_spec(s: Smoke, kc, vc, rnd):
    """B6's 192/128 build at K1 = SPEC_K + 1 (a group of 1: 5 live rows
    of its G_SPEC rows) over deepseek's caches paged to the speculation
    horizons, bf16 and int8 (and int8 over distinct key chunks): by
    :func:`check_split_spec`, against its plain version; bf16's times go
    into B6's record under "deepseek"."""
    torch = s.torch
    from repro_torch.kernels.decode_attention import ops, ref
    scale = DS_DK ** -0.5
    k1 = SPEC_K + 1
    horizons = [n + k1 for n in SPEC_BASES]
    qs = rnd(SLOTS, k1, DS_H, DS_DK)
    kp, vp, bt = _pages(s, kc, vc, horizons, PAGE)
    base = torch.tensor(SPEC_BASES, dtype=torch.int32, device=s.dev)
    live = sum(horizons)
    live_pages = sum(-(-n // PAGE) for n in horizons)
    flops = 2 * DS_H * (DS_DK + DS_DV) * sum(
        n + 1 + i for n in SPEC_BASES for i in range(k1))
    out_bytes = SLOTS * k1 * DS_H * (DS_DV + 2) * 4
    kd = _distinct_keys(s, SLOTS, DS_H, CACHE_LEN, DS_DK)
    kdp = _pages(s, kd, kd, horizons, PAGE)[0]
    del kd
    for kv in (None, "int8", "int8 distinct"):
        if kv is None:
            args = (qs, kp, vp, bt, base)
            fn, plain = (ops.spec_paged_decode_attention,
                         ref.spec_paged_decode_attention_ref)
            kv_bytes, scale_bytes, rate = 2, 0, BF16_FLOPS_PER_S
        else:
            kq, vq, ks, vs = _quantize(s, kdp if kv.endswith("distinct")
                                       else kp, vp, "int8")
            args = (qs, kq, vq, ks, vs, bt, base)
            fn, plain = (ops.quant_spec_paged_decode_attention,
                         ref.quant_spec_paged_decode_attention_ref)
            kv_bytes, scale_bytes, rate = 1, 2 * DS_H * 4, INT8_OPS_PER_S
        what = f"spec K1 = {k1} {kv or 'bf16'} 192/128"
        got = check_split_spec(s, f"{what} (B 8, 16/16, page 64)", args, fn,
                               plain, scale=scale)
        want = plain(*args, return_residuals=True, scale=scale)
        err = s.compare(f"{what} output acc / l", _normalized(got),
                        _normalized(want))
        if kv == "int8 distinct":
            continue
        nbytes = (qs.numel() * 2 + live * DS_H * (DS_DK + DS_DV) * kv_bytes
                  + out_bytes + live_pages * (scale_bytes + 4)
                  + SLOTS * k1 * 4)
        plain_ms = s.time_ms(lambda: plain(*args, return_residuals=True,
                                           scale=scale))
        times = (s.time_ms(lambda: fn(*args, return_residuals=True,
                                      scale=scale)),
                 plain_ms, nbytes, flops, None, rate)
        if kv is None:
            s.record_also("spec_paged_decode_attention", "deepseek", err,
                          *times)
        else:
            s.timings(f"spec_paged_decode_attention (deepseek {kv})", *times)
        _split_timings(s, "spec_paged_decode_attention", f"deepseek {what}",
                       lambda n: fn(*args, return_residuals=True, splits=n,
                                    scale=scale),
                       plain_ms, nbytes, flops, ops_per_s=rate)


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
    """B1, B2, B3, B4 and B5 (int8 and fp8 pools) at jamba's shapes
    (d_model 8192; 64 query heads on 8 KV heads of 128, a GQA group of
    8) and B8 at its expert shapes (16 experts of 8192 x 24576: 6.4 GB
    of weights per call), against their plain versions; their times go
    into each kernel's record under "jamba"."""
    check_model_shapes(s, "jamba", JB_DM, JB_HQ, JB_HKV, JB_E, JB_TOPK,
                       JB_FF, seed=12, quant=True)


def check_arctic_shapes(s: Smoke) -> None:
    """B1, B2, B3 and B4 at arctic's shapes (d_model 7168; 56 query
    heads on 8 KV heads of 128, a GQA group of 7 through B3's and B4's
    group-8 builds, every head held so that the eighth row, masked, would
    show in the next group's first head) and B8 at its expert shapes
    (128 experts of 7168 x 4864: 8.9 GB of weights per call, at most 16
    of them live at decode), against their plain versions; their times
    go into each kernel's record under "arctic".  B8 also at a prefill
    capacity of AR_C_PREFILL rows (8 x 511 tokens)."""
    check_model_shapes(s, "arctic", AR_DM, AR_HQ, AR_HKV, AR_E, AR_TOPK,
                       AR_FF, seed=18, more_c=(AR_C_PREFILL,))


def check_model_shapes(s: Smoke, key, dm, hq, hkv, e, topk, ff, seed,
                       more_c=(), quant=False):
    """B1 at the largest prefill group's rows (2 x 511 of ``dm``), B2 at
    its causal prefill, B3 and B4 at 8 slots of lengths 1..1024 (``hq``
    query heads over ``hkv`` of 128) and, with ``quant``, B5 over the
    same pages in int8 and fp8, B8 at the decode capacity of 8
    slots (gate/up and down) and the prefill group's (and each of
    ``more_c``) over ``e`` experts of ``dm`` x ``ff``, each against its
    plain version and timed beside its library call; the times go into
    each record under ``key``."""
    torch = s.torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.gmm import ops as gops
    from repro_torch.kernels.gmm import ref as gref
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    from repro_torch.models.moe import _capacity
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=s.dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g,
                           dtype=torch.bfloat16)

    # B1: the largest prefill group, 2 x 511 rows of dm
    b, n = 2, PROMPT_LENS[-1]
    x, w = rnd(b * n, dm), 0.1 * rnd(dm)
    kw = dict(eps=1e-6, weight_offset=1.0)
    err = s.compare(f"rmsnorm ({b * n}, {dm}) bf16",
                    rops.rmsnorm(x, w, **kw), rref.rmsnorm_ref(x, w, **kw))
    s.record_also("rmsnorm", key, err,
                  s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
                  s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
                  2 * x.numel() * 2 + 2 * dm, 4 * x.numel(),
                  s.time_ms(lambda: torch.nn.functional.rms_norm(
                      x, (dm,), w + 1.0, 1e-6)))
    # B2: B 2 x S 511, hq/hkv heads of 128, causal
    q, k, v = rnd(b, hq, n, 128), rnd(b, hkv, n, 128), rnd(b, hkv, n, 128)
    err = s.compare(f"flash ({b}, {hq}/{hkv}, {n}, 128) causal bf16",
                    fops.flash_attention(q, k, v),
                    fref.flash_attention_ref(q, k, v))
    operands_model(s, f"flash ({b}, {hq}/{hkv}, {n}, 128) causal bf16",
                   (q, k, v), {})
    s.record_also("flash_attention", key, err,
                  s.time_ms(lambda: fops.flash_attention(q, k, v)),
                  s.time_ms(lambda: fref.flash_attention_ref(q, k, v)),
                  2 * (q.numel() + 2 * k.numel() + q.numel()),
                  4 * b * hq * 128 * n * (n + 1) // 2,
                  s.time_ms(lambda: sdpa(q, k, v, is_causal=True,
                                         enable_gqa=True)))
    del q, k, v
    # B3 and B4 (and B5): 8 slots, lengths 1..1024, a group of hq / hkv
    _decode_shapes(s, key, DECODE_LENGTHS, CACHE_LEN, hq, hkv, 128, quant)
    # B8: decode (C 8 at 8 slots) gate/up and down, and the largest
    # prefill group's gate/up (C 160 for 2 x 511 tokens)
    c_dec = _capacity(SLOTS, e, topk, 1.25)
    c_pre = _capacity(b * n, e, topk, 1.25)
    print(f"  capacity: {c_dec} rows per expert at decode ({SLOTS} slots), "
          f"{c_pre} at the largest prefill ({b} x {n} tokens)")

    def run(c, kk, nn, what):
        lhs, rhs = rnd(e, c, kk), rnd(e, kk, nn)
        gs = torch.full((e,), c, dtype=torch.int32, device=s.dev)
        err = s.compare(f"gmm {what} ({e}, {c}, {kk}) @ ({e}, {kk}, "
                        f"{nn}) bf16", gops.gmm(lhs, rhs, gs),
                        gref.gmm_ref(lhs, rhs, gs))
        nbytes = 2 * (lhs.numel() + rhs.numel() + e * c * nn) + 4 * e
        return err, (s.time_ms(lambda: gops.gmm(lhs, rhs, gs)),
                     s.time_ms(lambda: gref.gmm_ref(lhs, rhs, gs)),
                     nbytes, 2 * e * c * kk * nn,
                     s.time_ms(lambda: torch.bmm(lhs, rhs)))

    err, times = run(c_dec, dm, ff, f"{key} decode gate/up")
    s.record_also("gmm", key, err, *times)
    _, times = run(c_dec, ff, dm, f"{key} decode down")
    s.timings(f"gmm ({key} decode down projection)", *times)
    err, times = run(c_pre, dm, ff, f"{key} prefill gate/up")
    s.record_also("gmm", f"{key} prefill", err, *times)
    for c in more_c:
        _, times = run(c, dm, ff, f"{key} prefill gate/up at C {c}")
        s.timings(f"gmm ({key} prefill gate/up, C {c})", *times)


# ------------------------------------- whisper and internvl2 kernels -----

def check_whisper_internvl2_shapes(s: Smoke) -> None:
    """The kernels at the shapes whisper-base and internvl2-26b give
    them, each against its plain version (B2's bf16 body also against its
    rounding model), timed beside its bound and SDPA, into each record
    under "whisper ..." or "internvl2": B1 over a prefill group's
    encoder rows of 512 (2 x 1,500) and internvl2's rows of 6,144 (2 x
    511), bit for bit with B11a; B2 non-causal at head dim 64 and a
    group of 1 (the encoder's self-attention over 1,500 frames, timed at
    8 requests; cross-attention at prefill, 2 x 416 queries over 1,500
    keys; at decode, 8 one-token queries over 1,500 keys), causal at
    internvl2's 48/8 heads of 128 (a group of 6); B3 at whisper's dense
    caches of 448 rows (8/8 heads of 64) and B3 and B4 at internvl2's
    (48/8 x 128), each by its split rule (``_decode_shapes``, which
    also holds B4 at whisper's heads)."""
    torch = s.torch
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.flash_attention import ref as fref
    from repro_torch.kernels.rmsnorm import native
    from repro_torch.kernels.rmsnorm import ops as rops
    from repro_torch.kernels.rmsnorm import ref as rref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    g = torch.Generator(device=s.dev).manual_seed(21)
    kw = dict(eps=1e-6, weight_offset=1.0)

    def rnd(*shape):
        return torch.randn(*shape, device=s.dev, generator=g,
                           dtype=torch.bfloat16)

    for key, rows, dm in (("whisper", 2 * WH_FRAMES, 512),
                          ("internvl2", 2 * PROMPT_LENS[-1], 6144)):
        x, w = rnd(rows, dm), 0.1 * rnd(dm)
        label = f"rmsnorm {key} ({rows}, {dm}) bf16"
        got = rops.rmsnorm(x, w, **kw)
        err = s.compare(label, got, rref.rmsnorm_ref(x, w, **kw))
        s.check(bool(torch.equal(got, native.rmsnorm_native(x, w, **kw))),
                f"{label}: B1 and B11a bit for bit")
        s.record_also("rmsnorm", key, err,
                      s.time_ms(lambda: rops.rmsnorm(x, w, **kw)),
                      s.time_ms(lambda: rref.rmsnorm_ref(x, w, **kw)),
                      2 * x.numel() * 2 + 2 * dm, 4 * x.numel(),
                      s.time_ms(lambda: torch.nn.functional.rms_norm(
                          x, (dm,), w + 1.0, 1e-6)))
        del x, got

    def flash(key, b, hq, hkv, sq, skv, d, causal):
        q, k, v = rnd(b, hq, sq, d), rnd(b, hkv, skv, d), rnd(b, hkv, skv, d)
        fkw = dict(causal=causal)
        label = (f"flash {key} ({b}, {hq}/{hkv}, {sq} x {skv}, {d}) "
                 f"{'causal' if causal else 'non-causal'} bf16")
        err = s.compare(label, fops.flash_attention(q, k, v, **fkw),
                        fref.flash_attention_ref(q, k, v, **fkw))
        operands_model(s, label, (q, k, v), fkw)
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        s.record_also(
            "flash_attention", key, err,
            s.time_ms(lambda: fops.flash_attention(q, k, v, **fkw)),
            s.time_ms(lambda: fref.flash_attention_ref(q, k, v, **fkw)),
            2 * (2 * q.numel() + k.numel() + v.numel()),
            4 * b * hq * d * pairs,
            s.time_ms(lambda: sdpa(q, k, v, is_causal=causal,
                                   enable_gqa=True)))

    flash("whisper encoder", WH_REQUESTS, 8, 8, WH_FRAMES, WH_FRAMES, 64,
          False)
    flash("whisper cross prefill", 2, 8, 8, WH_PROMPT_LENS[-1], WH_FRAMES,
          64, False)
    flash("whisper cross decode", WH_REQUESTS, 8, 8, 1, WH_FRAMES, 64, False)
    flash("internvl2", 2, 48, 8, PROMPT_LENS[-1], PROMPT_LENS[-1], 128, True)
    _decode_shapes(s, "whisper", WH_LENGTHS, WH_CACHE_LEN, 8, 8, 64, False)
    _decode_shapes(s, "internvl2", DECODE_LENGTHS, CACHE_LEN, 48, 8, 128,
                   False)


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

    def spec_decode_step(self, params, caches, tokens, lengths,
                         block_tables):
        logits = self.model.spec_decode_step(params, caches, tokens,
                                             lengths, block_tables)
        self.calls.append(logits.argmax(-1))          # (B, K1)
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

    def _answer(self, logits, emitting, forced):
        """One-hot logits at the served tokens ``forced`` (B,) or (B,
        K1), keeping the gap over the ``emitting`` rows."""
        shape = logits.shape
        logits, forced = logits.reshape(-1, shape[-1]), forced.reshape(-1)
        emitting = emitting.reshape(-1)
        gap = logits.max(-1).values - logits.gather(
            1, forced[:, None].long())[:, 0]
        gap = gap.where(emitting, gap.new_zeros(()))
        self.emitted = self.emitted + emitting.sum()
        self.flipped = self.flipped + (gap > 0).sum()
        gap = gap.max()
        self.worst = gap if self.worst is None else self.worst.maximum(gap)
        return logits.new_zeros(logits.shape).scatter_(
            1, forced[:, None].long(), 1.0).view(shape)

    def _next(self):
        forced = self.calls[self.i]
        self.i += 1
        return forced

    def prefill(self, params, tokens, cache_len):
        logits, caches = self.model.prefill(params, tokens, cache_len,
                                            plain=True)
        return self._answer(logits, logits.new_ones(
            logits.shape[:1], dtype=bool), self._next()), caches

    def decode_step(self, params, caches, tokens, lengths,
                    block_tables=None):
        logits = self.model.decode_step(params, caches, tokens, lengths,
                                        block_tables, plain=True)
        return self._answer(logits, self.engine.active_mask, self._next())

    def spec_decode_step(self, params, caches, tokens, lengths,
                         block_tables):
        """The verify call through the plain versions, answered with the
        served argmax of every row; the gap is kept over the rows the
        engine emits (``Engine._spec_step``'s rule: row 0 of an active
        slot, then each row whose draft is the previous row's served
        token, before the request's budget or the cache ends)."""
        import torch
        logits = self.model.spec_decode_step(params, caches, tokens,
                                             lengths, block_tables,
                                             plain=True)
        forced, eng = self._next(), self.engine
        t = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        done_t = ((eng.n_out[:, None] + t + 1 >= eng.max_new[:, None])
                  | (lengths[:, None] + t + 2 > eng.sc.cache_len))
        cont = ((tokens[:, 1:] == forced[:, :-1]) & ~done_t[:, :-1]
                & eng._spec_ok_dev[:, None])
        active = eng.active_mask[:, None]
        emitting = torch.cat(
            [active, active & torch.cumprod(cont.int(), 1).bool()], 1)
        return self._answer(logits, emitting, forced)


class _Dispatches:
    """The served model, counting the decode steps that reach the card
    (``decode_step`` and ``spec_decode_step`` calls: a step the watchdog
    discards counts, it launched; one an injected allocation failure
    emptied does not)."""

    def __init__(self, model):
        self.model, self.cfg, self.decodes = model, model.cfg, 0

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *args, **kw):
        self.decodes += 1
        return self.model.decode_step(*args, **kw)

    def spec_decode_step(self, *args, **kw):
        self.decodes += 1
        return self.model.spec_decode_step(*args, **kw)


def serve(s: Smoke, model, params, cache_len=CACHE_LEN,
          prompt_lens=PROMPT_LENS, record=False, margins=False, plan=None,
          **mode):
    """Drive the engine over the 12 requests in a serving ``mode``
    (ServeConfig fields), under the fault ``plan`` if one is given, the
    allocator audited after every step (outside ``wall_s``, so
    ``tok_per_s`` is the engine's alone); returns (requests, stats).  Counts the host copies (the step's, the admitted groups'
    and the page scans'), the syncs hidden elsewhere (sync debug mode),
    the decode steps that launched and every fault the recovery ladder
    took (step, request, kind).  ``record`` keeps every call's sampled
    tokens in ``stats["calls"]`` for the replay; ``margins`` every
    emitted token's two largest served logits in ``stats["top2"]``
    (``_Top2.by_request``); an MoE model's dropped assignments are
    counted on the card and read after the run."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    from repro_torch.models import moe
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve.paging import paged_bytes_per_slot
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=cache_len,
                                max_new_tokens=MAX_NEW, page_size=PAGE,
                                **mode)
    inner = _Recorder(model) if record else \
        _Top2(model) if margins else model
    served = _Dispatches(inner)
    engine = engine_mod.Engine(served, params, sc, device=s.dev,
                               fault_plan=plan)
    if margins:
        inner.engine = engine
    real_route = moe._route
    if record:
        moe._route = inner.route(real_route)
    reqs = _requests(model.cfg.vocab_size, prompt_lens)
    syncs, groups, scans, events = [0], [0], [0], []
    real_get, real_scan = engine_mod._device_get, engine_mod.nonfinite_pages
    real_admit, real_requeue = engine._admit_group, engine._fault_requeue

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

    def counted_scan(*args):
        scans[0] += 1
        return real_scan(*args)

    def logged_requeue(slot, kind):
        events.append((engine.step_count, engine.active[slot].rid, kind))
        return real_requeue(slot, kind)

    engine_mod._device_get = counted_get
    engine_mod.nonfinite_pages = counted_scan
    engine._admit_group = counted_admit
    engine._fault_requeue = logged_requeue
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    drops = moe.count_drops(s.dev) if model.cfg.moe is not None else None
    step_s, audits, audit_s = [], [], 0.0
    hidden = {"admitting": 0, "decoding": 0}
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
                if busy and groups[0] == g0:
                    step_s.append(dt)
                ta = time.perf_counter()
                audits += [(engine.step_count, p) for p in engine.audit()]
                audit_s += time.perf_counter() - ta
                if not busy and not engine.queue and not engine.requeue:
                    break
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0 - audit_s
        finally:
            torch.cuda.set_sync_debug_mode(0)
            moe.stop_counting_drops()
            moe._route = real_route
            engine_mod._device_get = real_get
            engine_mod.nonfinite_pages = real_scan
            # the wrappers hold the engine's bound methods: without this
            # the cycle keeps its weights and pools alive after the run
            del engine._admit_group, engine._fault_requeue
    launches = {k.name: k.launches for k in KERNELS}
    est = engine.stats()
    stats = {"wall_s": wall, "steps": est["steps"],
             "decode_steps": served.decodes, "groups": groups[0],
             "syncs": syncs[0], "page_scans": scans[0],
             "step_ms_median": 1e3 * statistics.median(step_s),
             "step_ms_max": 1e3 * max(step_s),
             "tokens": sum(len(r.out) for r in reqs),
             "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
             "launches": launches, "preemptions": engine.preemptions,
             "hidden_syncs": hidden, "audit": audits,
             "statuses": {x: sum(r.status == x for r in reqs)
                          for x in ("done", "failed", "pending")}}
    stats["tok_per_s"] = stats["tokens"] / wall
    if plan is not None:
        stats["injections"] = list(plan.injection_log)
        stats["events"] = events
        for key in ("recoveries", "recoveries_total", "failed_requests",
                    "watchdog_trips", "last_watchdog_trip", "last_recovery",
                    "faults_injected", "quarantined", "available",
                    "total_pages"):
            stats[key] = est[key]
        stats["usable"] = engine.allocator.usable
        if engine.spec:
            stats["spec_disabled"] = sum(r.spec_disabled for r in reqs)
    if drops is not None:
        stats["moe_dropped"] = int(drops)
    if record:
        stats["calls"] = (inner.calls, inner.routes)
    if margins:
        stats["top2"] = inner.by_request(reqs)
        inner.engine = None
    if engine.paged:
        stats["kv_dtype"] = (None if engine.kv_spec is None
                             else engine.kv_spec.dtype)
        stats["pool_bytes_per_slot"] = paged_bytes_per_slot(
            engine.caches, engine.allocator.total_pages,
            engine.pages_per_slot)
        if engine.windowed:
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
    t0 = time.perf_counter()
    for _ in range(PROFILED_STEPS[1] - PROFILED_STEPS[0]):
        engine.step()                     # each step ends in a sync
    wall_ms = 1e3 * (time.perf_counter() - t0)
    busy_ms = _device_busy_ms(prof, PROFILED_STEPS[1] - PROFILED_STEPS[0])
    return None if busy_ms is None else busy_ms / wall_ms


def _profiler(torch):
    """Trace the card's kernels (no host ops: less overhead on the host,
    which is what the window measures against).  A profiler that cannot
    start raises, and the trace phase fails like any other."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
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


def teacher_gap(s: Smoke, model, params, reqs, forward=None):
    """Largest (argmax logit - emitted token's logit) over every emitted
    token, from a plain-path forward over prompt + outputs (``forward(seq,
    start)``'s logits, if given); returns it and where it was (request,
    index of the emitted token: 0 is the prefill's sample), the emitted
    tokens and how many of them were not the plain forward's argmax (gap
    > 0)."""
    torch = s.torch
    worst, where, tokens, flipped = 0.0, None, 0, 0
    with torch.no_grad():
        for r in reqs:
            seq = torch.tensor([r.tokens + r.out[:-1]], device=s.dev)
            p0 = len(r.tokens) - 1
            # logits only where tokens were emitted: at gemma2's vocab of
            # 256,000 every position of a 6,000-token prompt is 6 GB
            rows = (model.forward_logits(params, seq, plain=True, start=p0)
                    if forward is None else forward(seq, p0))[0]
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
                  replay=False, margins=False, free_replay=True, **shape):
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
    ``replay``, against the plain replay of the run's own calls (and,
    with ``free_replay``, a second replay routing by its own top-k is
    reported)."""
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
    s.check(st["syncs"] == st["decode_steps"] + st["groups"]
            and st["page_scans"] == 0,
            f"{name}: {st['syncs']} host syncs = {st['decode_steps']} "
            f"decode steps + {st['groups']} admitted groups "
            f"({st['page_scans']} page scans)")
    s.check(st["hidden_syncs"]["decoding"] == 0,
            f"{name}: no other sync in steps that admitted nothing "
            f"({st['hidden_syncs']['decoding']}; "
            f"{st['hidden_syncs']['admitting']} in admitting steps)")
    s.check(st["audit"] == [], f"{name}: allocator audit clean after every "
                               f"step ({st['audit'][:3]})")
    del st["audit"]
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
        moe = model.cfg.moe is not None
        gap, dropped, flips, tokens, flipped = replay_gap(
            s, model, params, calls, routes if moe else None, **shape,
            **mode)
        if moe:
            s.check(dropped == st["moe_dropped"],
                    f"{name}: the replay on the served expert choices "
                    f"dropped the served {st['moe_dropped']} assignments "
                    f"({dropped}); its own top-k differed in {flips} "
                    f"choices")
            st.update(replay_routing_flips=flips)
        if free_replay:
            free, free_dropped, *_ = replay_gap(s, model, params, calls,
                                                None, **shape, **mode)
            st.update(free_replay_gap=free,
                      free_replay_moe_dropped=free_dropped)
            print(f"  {name}: a replay routing by its own top-k dropped "
                  f"{free_dropped} assignments, largest gap {free:.4f} "
                  f"logits (reported)")
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
        against = ("the plain replay of its own calls" if replay
                   else "the bf16 plain forward")
        print(f"  {name}: largest teacher-forced gap against {against} "
              f"{gap:.4f} logits{at} (reported)")
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
    s.serving_faults = s.phase(
        "serve granite-8b at full width under injected faults", run_faults,
        s, model, params, runs, stats["paged"]["step_ms_max"])
    s.serving_slo = s.phase(
        "serve granite-8b at full width under a replayed bursty SLO "
        "workload", run_slo, s, model, params)
    return dict(stats, tokens_agree={
        "dense_paged": _agree(runs["paged"], runs["dense"]),
        "spec_paged": _agree(runs["spec"], runs["paged"]),
        "int8_paged": _agree(runs["int8"], runs["paged"]),
        "fp8_e4m3_paged": _agree(runs["fp8_e4m3"], runs["paged"]),
        "spec_int8_int8": _agree(runs["spec-int8"], runs["int8"])})


def run_faults(s: Smoke, model, params, unfaulted, step_ms_max):
    """granite-8b at full width served paged under injected faults, three
    runs (``serve/faults.py``; the engine's recovery ladder):

    (a) bf16 pools, ``FaultPlan(FAULT_RATE, FAULT_SEED)`` plus one
        scheduled fault of each kind (FAULT_STEPS), the watchdog at
        WATCHDOG_STEPS x the slowest decode step of the unfaulted paged
        run (at least WATCHDOG_MIN_S), a stall of twice that;
    (b) int8 pools (B5): kv_corrupt at step 3 (NaN in a V scale page),
        then nan_logits on slot 0 at steps 6-17, max_retries 2;
    (c) spec, ngram, k 4 (B6): nan_logits on slot 0 at steps 2 and 3,
        spec_disable_after 2 (retry_backoff 1, so that the same request
        takes both).

    Each is checked: audit clean after every step; every request done or
    failed, a done one with MAX_NEW tokens; the host copies = decode
    steps (discarded ones too) + admitted groups + page scans, no other
    sync in a step that admitted nothing; the decode kernel launched 36
    times a decode step; the teacher-forced gap of every done request's
    tokens (bf16 runs; int8 reported); and each run's own contract
    below.  The share of tokens equal to the same mode's unfaulted run is
    reported: a resumed request's next token comes from re-prefill, B2's
    rounding instead of B4's, so a near tie may flip."""
    from repro_torch.serve.faults import FaultPlan
    watchdog = max(WATCHDOG_MIN_S, WATCHDOG_STEPS * step_ms_max / 1e3)
    plan_a = FaultPlan(rate=FAULT_RATE, seed=FAULT_SEED, stall_s=2 * watchdog)
    for kind, step in FAULT_STEPS:
        plan_a.at(step, kind)
    plan_b = FaultPlan().at(3, "kv_corrupt")
    for step in range(6, 18):
        plan_b.at(step, "nan_logits", slot=0)
    plan_c = FaultPlan().at(2, "nan_logits", slot=0).at(3, "nan_logits",
                                                       slot=0)
    print(f"  watchdog {watchdog:.3f} s ({WATCHDOG_STEPS} x the slowest "
          f"unfaulted paged decode step, {step_ms_max:.2f} ms; at least "
          f"{WATCHDOG_MIN_S} s), stall {2 * watchdog:.3f} s")
    runs = (("a", "paged", plan_a, dict(watchdog_s=watchdog),
             "paged_decode_attention", True),
            ("b", "int8", plan_b, dict(kv_dtype="int8", max_retries=2),
             "quant_paged_decode_attention", False),
            ("c", "spec", plan_c, dict(spec_mode="ngram", spec_k=SPEC_K,
                                       spec_disable_after=2,
                                       retry_backoff=1),
             "spec_paged_decode_attention", True))
    out = {}
    for run, mode_name, plan, mode, kernel, checked in runs:
        name = f"faults ({run}) {mode_name}"
        print(f"== serve, {name}", flush=True)
        reqs, st = serve(s, model, params, plan=plan, paged=True, **mode)
        print(f"  {name}: {st['steps']} steps, {st['decode_steps']} decode "
              f"steps, {st['groups']} groups, {st['page_scans']} page scans, "
              f"{st['wall_s']:.2f} s; statuses {st['statuses']}; injected "
              f"{st['faults_injected']}; recoveries {st['recoveries']}; "
              f"failed {st['failed_requests']}; watchdog trips "
              f"{st['watchdog_trips']}; quarantined {st['quarantined']}")
        print(f"  {name}: injections {st['injections']}")
        print(f"  {name}: ladder (step, request, kind) {st['events']}")
        s.check(st["audit"] == [], f"{name}: allocator audit clean after "
                                   f"every step ({st['audit'][:3]})")
        s.check(st["statuses"]["pending"] == 0,
                f"{name}: every request done or failed "
                f"({st['statuses']})")
        done = [r for r in reqs if r.done]
        failed = [r for r in reqs if r.failed]
        s.check(all(len(r.out) == MAX_NEW for r in done),
                f"{name}: every done request emitted {MAX_NEW} tokens")
        s.check(st["failed_requests"] == len(failed),
                f"{name}: failed_requests {st['failed_requests']} = the "
                f"failed requests {len(failed)}")
        s.check(st["syncs"] == st["decode_steps"] + st["groups"]
                + st["page_scans"],
                f"{name}: {st['syncs']} host syncs = {st['decode_steps']} "
                f"decode steps + {st['groups']} admitted groups + "
                f"{st['page_scans']} page scans")
        s.check(st["hidden_syncs"]["decoding"] == 0,
                f"{name}: no other sync in steps that admitted nothing "
                f"({st['hidden_syncs']['decoding']})")
        n = model.cfg.num_layers
        s.check(st["launches"][kernel] == n * st["decode_steps"],
                f"{name}: {kernel} launched {n} times a decode step "
                f"({st['launches'][kernel]} = {n} x {st['decode_steps']})")
        s.kernels[kernel]["launches_by_path"][name] = st["launches"][kernel]
        drained = st["total_pages"] - 1 - st["quarantined"]
        s.check(st["available"] == drained == st["usable"],
                f"{name}: the pool drained to total - 1 - quarantined = "
                f"{drained} ({st['available']} free, usable "
                f"{st['usable']})")
        if run == "a":
            s.check(all(v >= 1 for v in st["recoveries"].values()),
                    f"{name}: a recovery of each kind ({st['recoveries']})")
            # stalls drawn for one step sleep once
            stalls = {step for step, kind, _ in st["injections"]
                      if kind == "stall"}
            s.check(st["watchdog_trips"] == len(stalls),
                    f"{name}: watchdog trips {st['watchdog_trips']} = the "
                    f"steps a stall was injected at {sorted(stalls)}")
            scheduled = list(FAULT_STEPS)
            random_steps = set()
            for step, kind, _ in st["injections"]:
                if (kind, step) in scheduled:
                    scheduled.remove((kind, step))
                else:
                    random_steps.add(step)
            hit = {rid for step, rid, _ in st["events"]
                   if step in random_steps}
            s.check(all(r.rid in hit for r in failed),
                    f"{name}: every failed request was hit by a random draw "
                    f"(failed {[r.rid for r in failed]}; random draws at "
                    f"steps {sorted(random_steps)})")
        if run in ("a", "b"):
            s.check(st["quarantined"] >= 1,
                    f"{name}: {st['quarantined']} pages quarantined (>= 1)")
        if run == "b":
            s.check(len(failed) >= 1,
                    f"{name}: {len(failed)} requests failed past "
                    f"max_retries 2 (>= 1)")
        if run == "c":
            s.check(st["spec_disabled"] >= 1,
                    f"{name}: {st['spec_disabled']} requests degraded to "
                    f"plain decode (>= 1)")
        gap, where, tokens, flipped = teacher_gap(s, model, params, done)
        st.update(teacher_gap=gap, teacher_gap_at=where,
                  teacher_tokens=tokens, teacher_flipped=flipped)
        what = (f"{name}: largest teacher-forced gap over the {tokens} "
                f"tokens of the done requests {gap:.4f} logits "
                f"({flipped} not the plain argmax)")
        if checked:
            s.check(gap <= TEACHER_GAP, f"{what} <= {TEACHER_GAP}")
        else:
            print(f"  {what} (reported)")
        base = {r.rid: r.out for r in unfaulted[mode_name]}
        same = sum(a == b for r in done for a, b in zip(r.out, base[r.rid]))
        st["tokens_equal_unfaulted"] = same
        st["done_tokens"] = sum(len(r.out) for r in done)
        print(f"  {name}: {same} of {st['done_tokens']} tokens of done "
              f"requests equal the unfaulted {mode_name} run's (reported)")
        del st["audit"]
        out[run] = st
        s.torch.cuda.empty_cache()
    return out


def slo_trace():
    """The SLO phase's trace, from the port's generator."""
    from repro_torch.serve import workload
    spec = workload.WorkloadSpec(
        classes=tuple(workload.TrafficClass(*c) for c in SLO_CLASSES),
        arrival=workload.ArrivalProcess("gamma", SLO_RATE, SLO_BURSTINESS),
        vocab_size=SLO_VOCAB, seed=SLO_SEED)
    return workload.generate_trace(spec, SLO_REQUESTS)


def _decisions(tel):
    """Every scheduling decision of a run: (kind, request, slot, step) of
    each trace event.  With eos_id unset none reads a token value."""
    return [(e.kind, e.rid, e.slot, e.step) for e in tel.trace.events]


def replay_slo(s: Smoke, model, params, trace, name, telemetry=True,
               **mode):
    """Replay ``trace`` through a paged granite engine on the card
    (``workload.replay(audit=True)``) in ``mode`` (ServeConfig fields),
    with a ServeTelemetry unless ``telemetry`` is false; returns
    (requests, stats, telemetry).  Counts what ``serve`` counts (the
    engine's host copies, other syncs by sync debug mode, admitted
    groups, decode steps, launches, decode-only step times), and logs
    the admission order, the preemption order and the preemptions made
    at admission by the priority rule."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import workload
    from repro_torch.serve.telemetry import ServeTelemetry
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=CACHE_LEN,
                                max_new_tokens=SLO_MAX_NEW, page_size=PAGE,
                                paged=True, **mode)
    served = _Dispatches(model)
    tel = ServeTelemetry() if telemetry else None
    engine = engine_mod.Engine(served, params, sc, device=s.dev,
                               telemetry=tel)
    syncs, groups, evictions = [0], [0], [0]
    admits, preempts, step_s, caught = [], [], [], []
    hidden = {"admitting": 0, "decoding": 0}
    real_get = engine_mod._device_get
    real_step, real_admit = engine.step, engine._admit_group
    real_preempt = engine._preempt
    real_evict = engine._priority_admission_preempt

    def counted_get(t):
        syncs[0] += 1
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real_get(t)
        finally:
            torch.cuda.set_sync_debug_mode(1)

    def counted_admit(reqs_, plen):
        n = real_admit(reqs_, plen)
        groups[0] += n > 0
        admits.extend(r.rid for r in reqs_[:n])
        return n

    def logged_preempt(slot):
        preempts.append(engine.active[slot].rid)
        return real_preempt(slot)

    def counted_evict():
        n0 = len(preempts)
        real_evict()
        evictions[0] += len(preempts) - n0

    def timed_step():
        g0, n0, t0 = groups[0], len(caught), time.perf_counter()
        busy = real_step()              # ends in its host copy: synced
        dt = time.perf_counter() - t0
        n = sum("synchroniz" in str(w.message) for w in caught[n0:])
        hidden["decoding" if groups[0] == g0 else "admitting"] += n
        if busy and groups[0] == g0:
            step_s.append(dt)
        return busy

    engine_mod._device_get = counted_get
    engine._admit_group, engine._preempt = counted_admit, logged_preempt
    engine._priority_admission_preempt = counted_evict
    engine.step = timed_step
    for k in KERNELS:
        k.launches = 0
    error = None
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        caught = rec
        torch.cuda.set_sync_debug_mode(1)
        t0 = time.perf_counter()
        try:
            reqs = workload.replay(engine, trace, audit=True)
        except AssertionError as e:           # audit or drain: reported
            error, reqs = str(e)[:300], []
        finally:
            torch.cuda.set_sync_debug_mode(0)
            engine_mod._device_get = real_get
            wall = time.perf_counter() - t0
            del (engine.step, engine._admit_group, engine._preempt,
                 engine._priority_admission_preempt)
    st = {"error": error, "wall_s": wall, "steps": engine.step_count,
          "decode_steps": served.decodes, "groups": groups[0],
          "syncs": syncs[0], "hidden_syncs": hidden,
          "preemptions": engine.preemptions,
          "admission_evictions": evictions[0],
          "step_ms_median": (1e3 * statistics.median(step_s)
                             if step_s else None),
          "tokens": sum(len(r.out) for r in reqs),
          "launches": {k.name: k.launches for k in KERNELS}}
    print(f"  {name}: {st['steps']} steps, {st['decode_steps']} decode "
          f"steps (median {st['step_ms_median']:.2f} ms), {st['groups']} "
          f"groups, {st['preemptions']} preemptions "
          f"({st['admission_evictions']} at admission), {st['tokens']} "
          f"tokens in {wall:.2f} s" if error is None else
          f"  {name}: {error}")
    n = model.cfg.num_layers
    s.check(error is None, f"{name}: replay drained, allocator audit clean "
                           f"after every step ({error})")
    s.check(len(reqs) == len(trace.entries) and all(
        r.done and len(r.out) == min(r.max_new, SLO_MAX_NEW) for r in reqs),
        f"{name}: every request done with min(max_new, {SLO_MAX_NEW}) "
        f"tokens")
    s.check(st["syncs"] == st["decode_steps"] + st["groups"]
            and hidden["decoding"] == 0,
            f"{name}: {st['syncs']} host syncs = {st['decode_steps']} "
            f"decode steps + {st['groups']} admitted groups, 0 others in "
            f"steps that admitted nothing ({hidden['decoding']}; "
            f"{hidden['admitting']} in admitting steps)")
    b4 = st["launches"]["paged_decode_attention"]
    s.check(b4 == n * st["decode_steps"],
            f"{name}: paged_decode_attention launched {n} times a decode "
            f"step ({b4} = {n} x {st['decode_steps']})")
    for kname in ("rmsnorm", "flash_attention"):
        s.check(st["launches"][kname] > 0,
                f"{name}: {kname} launched {st['launches'][kname]} times")
    for kname in ("rmsnorm", "flash_attention", "paged_decode_attention"):
        s.kernels[kname]["launches_by_path"][f"slo ({name})"] = \
            st["launches"][kname]
    if tel is not None:
        problems = tel.trace.validate()
        s.check(problems == [], f"{name}: Trace.validate() found no problem "
                                f"({problems[:3]})")
    st.update(admits=admits, preempts=preempts)
    del engine
    torch.cuda.empty_cache()
    return reqs, st, tel


def cpu_decisions(trace, **mode):
    """The decisions of the port's engine on the CPU over ``trace``, the
    same slots, pages and budgets, on a one-layer float32 granite smoke
    model (random from seed 0): decisions read no token value, so the
    full-width run on the card must make the same ones."""
    import dataclasses
    import torch
    from repro_torch.configs.smoke import smoke_config
    from repro_torch.models.registry import build_model
    from repro_torch.serve import engine as engine_mod
    from repro_torch.serve import workload
    from repro_torch.serve.telemetry import ServeTelemetry
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=1),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    sc = engine_mod.ServeConfig(slots=SLOTS, cache_len=CACHE_LEN,
                                max_new_tokens=SLO_MAX_NEW, page_size=PAGE,
                                paged=True, **mode)
    tel = ServeTelemetry()
    engine = engine_mod.Engine(model, params, sc, device="cpu",
                               telemetry=tel)
    workload.replay(engine, trace, audit=True)
    return _decisions(tel)


def ttft_by_class(tel):
    """Per class: TTFT p50/p99 in engine steps (the trace's step fields,
    first token minus submission) and in seconds (the telemetry's)."""
    import numpy as np
    sub, first = {}, {}
    for e in tel.trace.events:
        if e.kind == "submitted":
            sub[e.rid] = e.step
        elif e.kind == "first_token":
            first[e.rid] = e.step
    out = {}
    for label in tel.class_labels():
        rids = [rid for rid, rec in tel.requests.items()
                if tel._class_label(rec) == label]
        steps = [first[r] - sub[r] for r in rids]
        secs = tel.samples("ttft_s", cls=label)
        out[label] = {
            "requests": len(rids),
            "ttft_steps_p50": float(np.percentile(steps, 50)),
            "ttft_steps_p99": float(np.percentile(steps, 99)),
            "ttft_s_p50": float(np.percentile(secs, 50)),
            "ttft_s_p99": float(np.percentile(secs, 99))}
    return out


def _upcast(tree):
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_upcast(v) for v in tree)
    return tree.float() if tree.is_floating_point() else tree


def _f32_model(model, params):
    """The same weights upcast to f32, and a model that computes in f32:
    the exact function the bf16 served path approximates.  The SLO
    phase's gap is taken against it: over its 1,075 tokens the bf16 plain
    forward's own rounding reaches past TEACHER_GAP where the served
    token is the f32 argmax (PERF.md §6)."""
    import dataclasses
    from repro_torch.models.registry import build_model
    return (build_model(dataclasses.replace(model.cfg, dtype="float32")),
            _upcast(params))


def _f32_layerwise_logits(model, params):
    """``forward(seq, start)`` for ``teacher_gap``: ``forward_logits``'s
    plain text path (embed, the layers, the final norm and unembed)
    computed in f32, each layer's weights upcast as the loop reaches it,
    so that one layer's f32 copy is held at a time: internvl2-26b's
    weights take 79.5 GB in f32."""
    import dataclasses
    import torch
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(model.cfg, dtype="float32")
    top = {k: _upcast(v) for k, v in params.items() if k != "layers"}

    def forward(seq, start):
        x = L.embed_tokens(top["embed"], seq, cfg)
        ropes = T._rope_tables(cfg, torch.arange(seq.shape[1],
                                                 device=seq.device),
                               lambda t: t)
        for p, kind in zip(params["layers"], cfg.layer_kinds()):
            x, _ = T.apply_layer_prefill(_upcast(p), x, cfg, kind, None,
                                         ropes[T._theta(cfg, kind)],
                                         plain=True)
        return T._logits(top, x[:, start:].contiguous(), cfg, plain=True)
    return forward


def check_sampler(s: Smoke):
    """The engine's sampling function on the card: SAMPLER_DRAWS draws
    from one fixed 32-way row at SLO_TEMPERATURE, a generator seeded 0;
    returns the largest |frequency - softmax| in standard errors."""
    import numpy as np
    torch = s.torch
    from repro_torch.serve.engine import sample
    row = torch.from_numpy(
        np.random.default_rng(0).standard_normal(32).astype(np.float32) * 2)
    logits = row.to(s.dev).expand(SAMPLER_DRAWS, 32).contiguous()
    got = sample(logits, SLO_TEMPERATURE,
                 torch.Generator(device=s.dev).manual_seed(0))
    freq = torch.bincount(got.long(), minlength=32).double().cpu() \
        / SAMPLER_DRAWS
    p = torch.softmax(row.double() / SLO_TEMPERATURE, dim=0)
    z = float(((freq - p).abs() / torch.sqrt(p * (1 - p) / SAMPLER_DRAWS))
              .max())
    s.check(z <= SAMPLER_SE,
            f"sampler: {SAMPLER_DRAWS} Gumbel-max draws at T "
            f"{SLO_TEMPERATURE} on the card, every class within "
            f"{SAMPLER_SE} standard errors of softmax (largest {z:.3f})")
    return z


def run_slo(s: Smoke, model, params):
    """granite-8b at full width, paged, serving a replayed bursty
    three-class trace (``slo_trace``) on the engine's step clock through
    ``workload.replay(audit=True)``, eight runs:

    (a1), (a2) priority, oversubscribed (SLO_PAGES), greedy, telemetry;
    (a3) the same without telemetry;
    (b) lru, oversubscribed, greedy, telemetry;
    (c) priority, the pool unconstrained, greedy, telemetry;
    (d1), (d2) priority, oversubscribed, temperature 0.8, seed 0;
    (d3) the same with seed 1.

    Each run is checked by ``replay_slo``; across runs: (a1)-(a3) the
    same tokens, admission and preemption orders, (a1) and (a2) the same
    per-class telemetry counts (the reference's workload-smoke
    contract), a preemption and an admission-time eviction in (a1), its
    teacher-forced gap against an f32 forward of the same weights (the
    bf16 plain forward's is reported), (d1) = (d2) and (d3) != (d1) in
    tokens, and the
    decisions of (a1) and (d1) equal to the port's engine on the CPU
    over the same trace (``cpu_decisions``).  Reported: per-class TTFT
    in steps and seconds for (a1), (b), (c), the top class's p99 TTFT
    over its unloaded p50, in steps, and the median decode step with
    telemetry on, (a1) and (a2), and off, (a3)."""
    import tempfile
    t_phase = time.perf_counter()
    trace = slo_trace()
    classes = {c: sum(e.cls == c for e in trace.entries)
               for c in trace.classes_present()}
    span = trace.entries[-1].arrival_step
    print(f"  trace: {len(trace.entries)} requests over {span} steps, "
          f"classes {classes}, prompts {min(len(e.tokens) for e in trace.entries)}"
          f"-{max(len(e.tokens) for e in trace.entries)} tokens")
    s.check(len(classes) >= 2, f"trace holds {len(classes)} classes (>= 2)")
    z = check_sampler(s)
    oversub = dict(preempt_policy="priority", total_pages=SLO_PAGES)
    sampled = dict(oversub, temperature=SLO_TEMPERATURE)
    plan = (("a1", oversub, True), ("a2", oversub, True),
            ("a3", oversub, False),
            ("b", dict(oversub, preempt_policy="lru"), True),
            ("c", dict(preempt_policy="priority"), True),
            ("d1", dict(sampled, seed=0), True),
            ("d2", dict(sampled, seed=0), True),
            ("d3", dict(sampled, seed=1), True))
    runs = {}
    for name, mode, tel_on in plan:
        print(f"== serve, slo ({name})", flush=True)
        runs[name] = replay_slo(s, model, params, trace, name,
                                telemetry=tel_on, **mode)
    outs = {k: [r.out for r in v[0]] for k, v in runs.items()}
    st = {k: v[1] for k, v in runs.items()}
    tel = {k: v[2] for k, v in runs.items()}
    a1 = st["a1"]
    s.check(a1["preemptions"] >= 1 and a1["admission_evictions"] >= 1,
            f"(a1): {a1['preemptions']} preemptions (>= 1), "
            f"{a1['admission_evictions']} at admission by class (>= 1)")
    for other in ("a2", "a3"):
        s.check(outs[other] == outs["a1"]
                and st[other]["admits"] == a1["admits"]
                and st[other]["preempts"] == a1["preempts"],
                f"({other}) and (a1): equal tokens, admission order and "
                f"preemption order")
    counts = {k: {c: {f: blk[f] for f in ("requests", "completed",
                                          "preempts")}
                  for c, blk in tel[k].summary_by_class().items()}
              for k in ("a1", "a2")}
    s.check(counts["a1"] == counts["a2"],
            f"(a1) and (a2): equal per-class telemetry counts "
            f"{counts['a1']}")
    s.check([e.rid for e in tel["a1"].trace.events if e.kind == "admitted"]
            == a1["admits"], "(a1): the trace's admissions are the "
                             "engine's")
    bgap, bwhere, _, bflipped = teacher_gap(s, model, params, runs["a1"][0])
    print(f"  (a1): against the bf16 plain forward, largest gap {bgap:.4f} "
          f"at {bwhere}, {bflipped} tokens not its argmax (reported)")
    model32, params32 = _f32_model(model, params)
    gap, where, tokens, flipped = teacher_gap(s, model32, params32,
                                              runs["a1"][0])
    del params32
    s.torch.cuda.empty_cache()
    s.check(gap <= TEACHER_GAP,
            f"(a1): every emitted token within {TEACHER_GAP} logits of the "
            f"f32 plain forward's argmax (largest gap {gap:.4f} at {where}; "
            f"{flipped} of {tokens} not the argmax)")
    s.check(outs["d1"] == outs["d2"],
            "(d1) and (d2): the same seed samples the same tokens")
    differ = sum(a != b for p, q in zip(outs["d1"], outs["d3"])
                 for a, b in zip(p, q))
    s.check(differ >= 1, f"(d3) differs from (d1) in {differ} tokens (>= 1)")
    t_cpu = time.perf_counter()
    for name, mode in (("a1", oversub), ("d1", dict(sampled, seed=0))):
        want = cpu_decisions(trace, **mode)
        got = _decisions(tel[name])
        first = next((i for i, (a, b) in enumerate(zip(got, want))
                      if a != b), None)
        s.check(got == want,
                f"({name}): its {len(got)} decisions (kind, request, slot, "
                f"step) equal the CPU engine's {len(want)} (first "
                f"difference at {first})")
    t_cpu = time.perf_counter() - t_cpu
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "trace.json")
        doc = tel["a1"].trace.export(path)
        with open(path) as f:
            back = json.load(f)
        mpath = os.path.join(td, "metrics.json")
        tel["a1"].registry.export(mpath)
        with open(mpath) as f:
            metrics = json.load(f)
        s.check(back == doc and metrics["counters"]["serve.finished"]
                == SLO_REQUESTS,
                f"(a1): Chrome trace ({len(doc['traceEvents'])} events) "
                f"and metrics export read back")
    ttft = {k: ttft_by_class(tel[k]) for k in ("a1", "b", "c")}
    for k, rows in ttft.items():
        for label, row in rows.items():
            print(f"  ({k}) {label}: {row['requests']} requests, TTFT p50 "
                  f"{row['ttft_steps_p50']:g} / p99 {row['ttft_steps_p99']:g}"
                  f" steps, {row['ttft_s_p50']:.4f} / {row['ttft_s_p99']:.4f}"
                  f" s")
    top = tel["a1"].class_labels()[0]
    ratio = ttft["a1"][top]["ttft_steps_p99"] / \
        ttft["c"][top]["ttft_steps_p50"]
    print(f"  top class {top}: p99 TTFT loaded (a1) over its unloaded p50 "
          f"(c), in steps: {ratio:.3f} (reported)")
    medians = {k: st[k]["step_ms_median"] for k in ("a1", "a2", "a3")}
    print(f"  median decode step, telemetry on (a1) {medians['a1']:.3f} ms, "
          f"(a2) {medians['a2']:.3f} ms, off (a3) {medians['a3']:.3f} ms "
          f"(reported)")
    phase_s = time.perf_counter() - t_phase
    print(f"  SLO phase {phase_s:.1f} s ({t_cpu:.1f} s of it the CPU "
          f"engine's decisions)")
    keep = ("wall_s", "steps", "decode_steps", "groups", "syncs",
            "preemptions", "admission_evictions", "step_ms_median",
            "tokens")
    return {"trace": {"requests": len(trace.entries), "span_steps": span,
                      "classes": classes},
            "sampler_max_se": z, "teacher_gap_a1": gap,
            "teacher_gap_a1_at": where, "teacher_gap_a1_bf16": bgap,
            "teacher_gap_a1_bf16_at": bwhere,
            "runs": {k: {f: v[f] for f in keep} for k, v in st.items()},
            "ttft_by_class": ttft, "top_class_p99_over_unloaded_p50": ratio,
            "d3_tokens_differing": differ, "phase_s": phase_s,
            "cpu_decisions_s": t_cpu}


def run_traces(s: Smoke):
    """The card's busy share over paged decode steps of each model,
    fresh weights from the same seed; last, since tracing slows every
    later step (deepseek-v2-lite-16b's is traced first, then gemma2-2b's,
    gemma3-4b's, granite-8b's, jamba-1.5-large-398b's (4 layers), arctic-480b's (2
    layers) and xlstm-1.3b's, each a lower bound)."""
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    shares = {}
    for arch, shape in (("deepseek-v2-lite-16b", {}),
                        ("gemma2-2b", dict(cache_len=G2_CACHE_LEN,
                                           prompt_lens=G2_PROMPT_LENS)),
                        ("gemma3-4b", dict(cache_len=G3_CACHE_LEN,
                                           prompt_lens=G3_PROMPT_LENS)),
                        ("granite-8b", {}),
                        ("jamba-1.5-large-398b", {}),
                        ("arctic-480b", {}),
                        ("xlstm-1.3b", {})):
        cut = {"jamba-1.5-large-398b": _jamba_config,
               "arctic-480b": _arctic_config}.get(arch)
        model = build_model(cut() if cut else get_config(arch))
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


def _gemma3_27b_config():
    """gemma3-27b at full width, cut to G3_27B_LAYERS of its 62 layers:
    one period of five local layers and a global one, then two local
    layers, so that the stack ends mid-cycle as 62 = 10 x 6 + 2 does."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("gemma3-27b"),
                               num_layers=G3_27B_LAYERS)


def run_serving_gemma3(s: Smoke):
    """gemma3-4b at full width and depth (34 layers: 29 local of a
    1,024-token window, 5 global), served four ways: paged (B4 on the
    global layers, B7 over ring tables on the local ones), dense (B3 on
    all, local layers over rings of the window), and from int8 and fp8
    pools (B5 and B7q); then gemma3-27b at full width cut to 8 layers (7
    local, 1 global), paged and dense.  B1 launches 6 times a layer
    (ln1, q-norm, k-norm, post_ln1, ln2, post_ln2) and once for the final
    norm, per decode step and per admitted group; B2 once a layer per
    group."""
    import gc
    torch = s.torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model
    from repro_torch.quant import resolve_kv_spec
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")
    shape = dict(cache_len=G3_CACHE_LEN, prompt_lens=G3_PROMPT_LENS)
    out = {}
    for arch, cfg, modes in (
            ("gemma3-4b", get_config("gemma3-4b"),
             ("paged", "dense", "int8", "fp8_e4m3")),
            ("gemma3-27b", _gemma3_27b_config(), ("paged", "dense"))):
        model = build_model(cfg)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                            device=s.dev)
        torch.cuda.synchronize()
        n = sum(t.numel() for t in _leaves(params))
        nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
        kinds = cfg.layer_kinds()
        n_local = kinds.count("local")
        n_global = cfg.num_layers - n_local
        print(f"  {arch}: {cfg.num_layers} layers ({n_local} local, window "
              f"{cfg.window}, RoPE base {cfg.rope_theta_local:g}; "
              f"{n_global} global, base {cfg.rope_theta:g}; qk-norm), "
              f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
              f"heads of {cfg.head_dim}, {n / 1e9:.3f} B parameters "
              f"({nbytes / 1e9:.2f} GB) in {cfg.dtype}, random from seed 0 "
              f"({time.perf_counter() - t0:.2f} s); cache {G3_CACHE_LEN}, "
              f"prompts {G3_PROMPT_LENS}")
        norms = 6 * cfg.num_layers + 1
        runs, stats = {}, {}

        def run(name, mode, per_step, **kw):
            print(f"== serve {arch}, {name}", flush=True)
            idle = tuple(k for k in DECODE_KERNELS if k not in per_step)
            runs[name], stats[name] = check_serving(
                s, model, params, f"{arch} {name}", mode,
                dict(per_step, rmsnorm=norms, flash_attention=0), idle,
                per_group={"rmsnorm": norms,
                           "flash_attention": cfg.num_layers},
                **shape, **kw)
            for kname in ("rmsnorm", "flash_attention", *per_step):
                s.kernels[kname][arch]["launches"] = \
                    stats[name]["launches"][kname]

        for name in modes:
            if name == "paged":
                run(name, dict(paged=True),
                    {"paged_decode_attention": n_global,
                     "window_paged_decode_attention": n_local})
            elif name == "dense":
                run(name, dict(paged=False),
                    {"decode_attention": cfg.num_layers})
            else:
                resolve_kv_spec(name, s.dev, strict=True)
                run(name, dict(paged=True, kv_dtype=name),
                    {"quant_paged_decode_attention": n_global,
                     "quant_window_paged_decode_attention": n_local},
                    teacher_checked=False)
                ratio = stats[name]["pool_bytes_per_slot"] / \
                    stats["paged"]["pool_bytes_per_slot"]
                s.check(ratio < 0.53,
                        f"{arch} {name}: pool bytes per slot (global group) "
                        f"{stats[name]['pool_bytes_per_slot']} = "
                        f"{ratio:.4f} of bf16's")
        agree = {f"{m}_paged": _agree(runs[m], runs["paged"])
                 for m in modes if m != "paged"}
        for key, n_agree in agree.items():
            print(f"  {arch} {key[:-6]} and paged agree on {n_agree} of "
                  f"{stats['paged']['tokens']} tokens")
        out[arch] = dict(stats, tokens_agree=agree, parameters=n)
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    return out


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

    def run(name, mode, decode_kernel, **kw):
        print(f"== serve deepseek-v2-lite-16b, {name}", flush=True)
        per_step = {decode_kernel: cfg.num_layers, "gmm": 3 * n_moe}
        runs[name], stats[name] = check_serving(
            s, model, params, f"deepseek {name}", mode, per_step,
            tuple(k for k in DECODE_KERNELS if k != decode_kernel),
            prefill=("rmsnorm", "flash_attention", "gmm"),
            per_group={"gmm": 3 * n_moe}, replay=True, **kw)
        for kname in ("flash_attention", decode_kernel):
            # the first run that served through it
            s.kernels[kname]["deepseek"].setdefault(
                "launches", stats[name]["launches"][kname])

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  deepseek dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    # B5 at 192/128 from int8 and fp8 pools, B6 speculating over bf16
    # and int8 pools: one replay each (on the served expert choices)
    for kv in ("int8", "fp8_e4m3"):
        run(kv, dict(paged=True, kv_dtype=kv), "quant_paged_decode_attention",
            teacher_checked=False, free_replay=False)
        st = stats[kv]
        s.check(st["kv_dtype"] == kv,
                f"deepseek {kv}: the engine's pools are {st['kv_dtype']}")
        ratio = st["pool_bytes_per_slot"] / \
            stats["paged"]["pool_bytes_per_slot"]
        s.check(ratio < 0.53,
                f"deepseek {kv}: pool bytes per slot "
                f"{st['pool_bytes_per_slot']} = {ratio:.4f} of bf16's "
                f"{stats['paged']['pool_bytes_per_slot']}")
        agree[f"{kv}_paged"] = _agree(runs[kv], runs["paged"])
    spec = dict(paged=True, spec_mode="ngram", spec_k=SPEC_K)
    run("spec", spec, "spec_paged_decode_attention", free_replay=False)
    # dead slots' rows land in the null page, which their own attention
    # reads and their hidden states route through MoE capacity beside
    # the live slots': the pools keep those rows in index order, so a
    # second run emits the same tokens
    again, _ = serve(s, model, params, **spec)
    s.check([r.out for r in again] == [r.out for r in runs["spec"]],
            f"deepseek spec: a second run emits the same tokens "
            f"({_agree(again, runs['spec'])} of {stats['spec']['tokens']} "
            f"agree)")
    del again
    run("spec-int8", dict(spec, kv_dtype="int8"),
        "spec_paged_decode_attention", teacher_checked=False,
        free_replay=False)
    agree["spec_paged"] = _agree(runs["spec"], runs["paged"])
    agree["spec_int8_int8"] = _agree(runs["spec-int8"], runs["int8"])
    print(f"  deepseek tokens agreeing: {agree} of "
          f"{stats['paged']['tokens']}")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree)


#: the decode kernels: a run that serves through one checks the others idle
DECODE_KERNELS = ("decode_attention", "paged_decode_attention",
                  "window_paged_decode_attention",
                  "quant_paged_decode_attention",
                  "quant_window_paged_decode_attention",
                  "spec_paged_decode_attention")


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
    served paged (B4), dense (B3) and from int8 and fp8 pools (B5 at
    64/8 heads of 128, the mamba state dense), B8 on every MoE layer and
    B9 on every mamba layer's prefill, held to a plain replay of its own
    calls."""
    import gc
    torch = s.torch
    from repro_torch.models.registry import build_model
    from repro_torch.quant import resolve_kv_spec
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

    def run(name, mode, decode_kernel, **kw):
        print(f"== serve jamba-1.5-large-398b, {name}", flush=True)
        per_step = {decode_kernel: n_attn, "gmm": 3 * n_moe, "mamba_scan": 0}
        runs[name], stats[name] = check_serving(
            s, model, params, f"jamba {name}", mode, per_step,
            tuple(k for k in DECODE_KERNELS if k != decode_kernel),
            prefill=("rmsnorm", "flash_attention", "gmm", "mamba_scan"),
            per_group={"gmm": 3 * n_moe, "mamba_scan": n_mamba},
            replay=True, **kw)
        for kname in ("rmsnorm", "flash_attention", "gmm", decode_kernel):
            s.kernels[kname]["jamba"]["launches"] = \
                stats[name]["launches"][kname]

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  jamba dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    # the attention layer's pools in int8 and fp8, the mamba state dense;
    # the gap against the plain replay of each run's own calls (its
    # prefills scattered into the same quantized pools) is reported
    for kv in ("int8", "fp8_e4m3"):
        resolve_kv_spec(kv, s.dev, strict=True)
        run(kv, dict(paged=True, kv_dtype=kv), "quant_paged_decode_attention",
            teacher_checked=False, free_replay=False)
        st = stats[kv]
        ratio = st["pool_bytes_per_slot"] / \
            stats["paged"]["pool_bytes_per_slot"]
        s.check(st["kv_dtype"] == kv and ratio < 0.53,
                f"jamba {kv}: the engine's pools are {st['kv_dtype']}, pool "
                f"bytes per slot {st['pool_bytes_per_slot']} = {ratio:.4f} "
                f"of bf16's {stats['paged']['pool_bytes_per_slot']}")
        agree[f"{kv}_paged"] = _agree(runs[kv], runs["paged"])
        print(f"  jamba {kv} and bf16 paged agree on {agree[f'{kv}_paged']} "
              f"of {st['tokens']} tokens")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree)


def _arctic_config():
    """arctic-480b at full width, cut to its first AR_LAYERS layers (each
    the same: GQA attention, 128 experts top-2 and the dense residual
    MLP)."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("arctic-480b"),
                               num_layers=AR_LAYERS)


def run_serving_arctic(s: Smoke):
    """arctic-480b at full width, 2 layers (55.4 GB of weights), served
    paged (B4) and dense (B3) at its GQA group of 7, B8 three times on
    every layer, held to a plain replay of its own calls; peak memory
    reported."""
    import gc
    torch = s.torch
    from repro_torch.models.registry import build_model
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")
    cfg = _arctic_config()
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    m = cfg.moe
    print(f"  arctic-480b: {cfg.num_layers} of its 35 layers (MoE on each: "
          f"{m.num_experts} experts top-{m.top_k}, d_ff {m.d_ff_expert}, "
          f"and a dense residual MLP of d_ff {cfg.d_ff}), d_model "
          f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim}, {n / 1e9:.3f} B parameters ({nbytes / 1e9:.2f} "
          f"GB), random from seed 0 ({time.perf_counter() - t0:.2f} s, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB)")
    runs, stats = {}, {}

    def run(name, mode, decode_kernel):
        print(f"== serve arctic-480b, {name}", flush=True)
        per_step = {decode_kernel: cfg.num_layers, "gmm": 3 * cfg.num_layers}
        runs[name], stats[name] = check_serving(
            s, model, params, f"arctic {name}", mode, per_step,
            tuple(k for k in DECODE_KERNELS if k != decode_kernel),
            prefill=("rmsnorm", "flash_attention", "gmm"),
            per_group={"gmm": 3 * cfg.num_layers}, replay=True,
            free_replay=False)
        for kname in ("rmsnorm", "flash_attention", "gmm", decode_kernel):
            s.kernels[kname]["arctic"]["launches"] = \
                stats[name]["launches"][kname]

    run("paged", dict(paged=True), "paged_decode_attention")
    run("dense", dict(paged=False), "decode_attention")
    agree = {"dense_paged": _agree(runs["paged"], runs["dense"])}
    print(f"  arctic dense and paged agree on {agree['dense_paged']} of "
          f"{stats['paged']['tokens']} tokens")
    del params
    torch.cuda.empty_cache()
    return dict(stats, tokens_agree=agree)


def run_serving_xlstm(s: Smoke):
    """xlstm-1.3b at full width cut to XL_LAYERS = 8 of its 48 layers
    (one period of seven mLSTM and one sLSTM; no attention layer),
    served paged and dense in bf16 (and paged with ``kv_dtype`` int8,
    which has no pool to quantize: the paged run's tokens) and again, on
    the same weights, in f32 (XL_DTYPES): B10 with its state output on
    every mLSTM layer of every prefill (7 launches per admitted group),
    none in a decode step
    (the one-token recurrences are plain PyTorch); then ``Model.loss`` of
    one batch through the kernels and through their plain versions.  The
    teacher-forced gap and the loss are checked in f32 and reported in
    bf16 (see XL_DTYPES)."""
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
        cfg = dataclasses.replace(get_config("xlstm-1.3b"), dtype=dt,
                                  num_layers=XL_LAYERS)
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
        if dt == XL_DTYPES[0]:
            # kv_dtype int8 once: no attention layer, so no pool to
            # quantize; the same kernels on the same inputs as paged bf16
            name = f"paged int8 {dt}"
            print(f"== serve xlstm-1.3b, {name}", flush=True)
            runs["int8"], stats["int8"] = check_serving(
                s, model, params, f"xlstm {name}",
                dict(paged=True, kv_dtype="int8"), {"mlstm_scan": 0}, idle,
                teacher_checked=checked, prefill=("rmsnorm", "mlstm_scan"),
                per_group={"mlstm_scan": n_mlstm})
            st = stats["int8"]
            s.check(st["kv_dtype"] == "int8"
                    and st["pool_bytes_per_slot"]
                    == stats["paged"]["pool_bytes_per_slot"] == 0,
                    f"xlstm int8: the engine reports {st['kv_dtype']}, pool "
                    f"bytes per slot {st['pool_bytes_per_slot']} (bf16 "
                    f"{stats['paged']['pool_bytes_per_slot']}): no pool")
            same = _agree(runs["int8"], runs["paged"])
            s.check(same == st["tokens"],
                    f"xlstm int8 emits the paged bf16 run's tokens ({same} "
                    f"of {st['tokens']})")
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
    and labels (``check_loss``: B10 once per mLSTM layer, without its
    state output, and B1), the two losses within ``tol``, or reported
    where it is None."""
    torch = s.torch
    g = torch.Generator(device=s.dev).manual_seed(5)
    batch = {name: torch.randint(0, model.cfg.vocab_size,
                                 (XL_LOSS_B, XL_LOSS_S), device=s.dev,
                                 generator=g)
             for name in ("tokens", "labels")}
    dt = model.cfg.dtype
    out = check_loss(s, model, params, f"xlstm {dt}", batch,
                     ("mlstm_scan", "rmsnorm"), tol)
    n_mlstm = model.cfg.layer_kinds().count("mlstm")
    s.check(out["launches"]["mlstm_scan"] == n_mlstm,
            f"xlstm loss ({dt}): mlstm_scan launched once per mLSTM layer "
            f"({out['launches']['mlstm_scan']} = {n_mlstm})")
    return out


# ------------------------------------------- whisper-base, internvl2-26b ----

def drive_model(s: Smoke, model, params, prompts, extras, cache_len,
                max_new=MAX_NEW, plain=False, forced=None):
    """Serve ``prompts`` through the model's own entry points with each
    row's stub inputs (``extras``: name -> (rows, ...) on the card), as
    the dense engine admits: each group of equal prompt length in one
    ``Model.prefill`` with its rows' extras, its caches copied into the
    rows of one dense cache per layer (``enc_len`` encoder rows beside
    K/V for an encoder-decoder), its first token sampled from the
    prefill's logits; then ``max_new - 1`` decode steps over every row.
    Greedy, one host copy per group and per step (``copies``); sync
    debugging counts any other sync in the decode steps (``hidden``).
    With ``forced`` (the served run's ``calls``) every call's tokens are
    the served ones instead of its argmax, and ``worst`` keeps the
    largest (argmax logit - served token's logit), ``flipped`` the
    served tokens that are not the argmax: the plain replay of the same
    calls, with ``plain``."""
    torch = s.torch
    n = len(prompts)
    enc = extras.get("encoder_embeds")
    caches = model.init_decode_caches(n, cache_len, s.dev, enc_len=(
        0 if enc is None else enc.shape[1]))
    groups = {}
    for i, p in enumerate(prompts):
        groups.setdefault(len(p), []).append(i)
    tok = torch.zeros(n, dtype=torch.long, device=s.dev)
    lengths = torch.tensor([len(p) for p in prompts], dtype=torch.int32,
                           device=s.dev)
    calls, outs, st = [], [[] for _ in prompts], {
        "copies": 0, "hidden": 0, "worst": None, "flipped": 0,
        "emitted": 0, "groups": len(groups), "steps": max_new - 1}

    def sample(logits):
        if forced is None:
            nxt = logits.argmax(-1)
        else:
            nxt = forced[len(calls)]
            gap = logits.max(-1).values - logits.gather(
                1, nxt[:, None])[:, 0]
            st["flipped"] = st["flipped"] + (gap > 0).sum()
            gap = gap.max()
            st["worst"] = gap if st["worst"] is None else \
                st["worst"].maximum(gap)
        calls.append(nxt)
        st["emitted"] += nxt.numel()
        st["copies"] += 1
        return nxt, nxt.tolist()

    with torch.no_grad():
        for rows in groups.values():
            idx = torch.tensor(rows, device=s.dev)
            logits, group = model.prefill(
                params, torch.tensor([prompts[i] for i in rows],
                                     device=s.dev), cache_len,
                {k: v.index_select(0, idx) for k, v in extras.items()},
                plain=plain)
            for c, c1 in zip(caches, group):
                for name in c:
                    c[name].index_copy_(0, idx, c1[name])
            nxt, host = sample(logits)
            tok.index_copy_(0, idx, nxt)
            for i, t in zip(rows, host):
                outs[i].append(t)
            del group
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(max_new - 1):
                torch.cuda.set_sync_debug_mode(1)
                try:
                    logits = model.decode_step(params, caches, tok, lengths,
                                               plain=plain)
                    lengths += 1
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                tok, host = sample(logits)
                for out, t in zip(outs, host):
                    out.append(t)
            st["hidden"] = sum("synchroniz" in str(w.message)
                               for w in caught)
    if forced is not None:
        st["worst"], st["flipped"] = float(st["worst"]), int(st["flipped"])
    del caches
    return outs, calls, st


def check_driven(s: Smoke, model, params, name, prompts, extras, cache_len,
                 per_step, per_group):
    """``drive_model`` through the kernels (every count set to 0 just
    before, read just after), then its plain replay: every row's
    ``MAX_NEW`` tokens, one host copy per step and group and no other
    sync in a decode step, each kernel in ``per_step`` launched exactly
    that many times per decode step plus ``per_group[k]`` per prefill
    group and none of the others, the replay launching none, and the
    gap against the replay within TEACHER_GAP.  Returns the run's
    stats."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    outs, calls, st = drive_model(s, model, params, prompts, extras,
                                  cache_len)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    tokens = sum(map(len, outs))
    print(f"  {name}: {len(prompts)} requests, {tokens} tokens in "
          f"{wall:.3f} s ({st['groups']} prefill groups, {st['steps']} "
          f"decode steps), peak memory {peak:.2f} GiB, launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    s.check(all(len(o) == MAX_NEW for o in outs),
            f"{name}: every request emitted {MAX_NEW} tokens")
    s.check(st["copies"] == st["steps"] + st["groups"] and st["hidden"] == 0,
            f"{name}: {st['copies']} host copies = {st['steps']} decode "
            f"steps + {st['groups']} groups; {st['hidden']} other syncs in "
            f"decode steps")
    expected = {**per_step, **per_group}
    for kname in expected:
        n, g = per_step.get(kname, 0), per_group.get(kname, 0)
        want = n * st["steps"] + g * st["groups"]
        s.check(launches[kname] == want,
                f"{name}: {kname} launched {n} times per decode step and "
                f"{g} per group ({launches[kname]} = {want})")
        s.kernels[kname]["launches_by_path"][name] = launches[kname]
    others = {k: v for k, v in launches.items() if v and k not in expected}
    s.check(not others, f"{name}: no other kernel launched ({others})")
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    _, _, rep = drive_model(s, model, params, prompts, extras, cache_len,
                            plain=True, forced=calls)
    torch.cuda.synchronize()
    s.check(all(k.launches == 0 for k in KERNELS),
            f"{name}: the replay launched no kernel (plain versions only)")
    print(f"  {name}: {rep['flipped']} of {rep['emitted']} emitted tokens "
          f"are not the replay's argmax ({time.perf_counter() - t0:.3f} s)")
    s.check(rep["worst"] <= TEACHER_GAP,
            f"{name}: every emitted token within {TEACHER_GAP} logits of "
            f"the plain replay's argmax (largest gap {rep['worst']:.4f})")
    return {"wall_s": wall, "tokens": tokens, "groups": st["groups"],
            "decode_steps": st["steps"], "peak_gib": peak,
            "launches": launches, "replay_gap": rep["worst"],
            "replay_flipped": rep["flipped"], "emitted": rep["emitted"]}


def check_loss(s: Smoke, model, params, name, batch, kernels, tol):
    """``Model.loss`` of ``batch`` through the kernels (the counts set to
    0 just before and read just after: each of ``kernels`` launched, no
    other) and through their plain versions (no launch): every metric
    finite, the losses within ``tol``, or reported where it is None."""
    torch = s.torch
    from repro_torch.core.build import KERNELS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    _, got = model.loss(params, batch)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    launches = {k.name: k.launches for k in KERNELS}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    t0 = time.perf_counter()
    _, want = model.loss(params, batch, plain=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    s.check(all(launches[k] > 0 for k in kernels)
            and not {k for k, v in launches.items()
                     if v and k not in kernels},
            f"{name} loss: launches "
            f"{ {k: v for k, v in launches.items() if v} }, of {kernels} "
            f"alone")
    s.check(all(k.launches == launches[k.name] for k in KERNELS),
            f"{name} loss: the plain loss launched no kernel")
    for kname in kernels:
        s.kernels[kname]["launches_by_path"][f"{name} loss"] = \
            launches[kname]
    got = {k: float(v) for k, v in got.items()}
    want = {k: float(v) for k, v in want.items()}
    diff = {k: abs(got[k] - want[k]) for k in got}
    s.check(all(map(math.isfinite, list(got.values()) + list(
        want.values()))), f"{name} loss: every metric finite")
    what = (f"{name} loss of a {tuple(batch['tokens'].shape)} batch: "
            f"{got['loss']:.6f} through the kernels, {want['loss']:.6f} "
            f"through their plain versions, |diff| {diff['loss']:.3e}")
    if tol is None:
        print(f"  {what} (reported)")
    else:
        s.check(diff["loss"] <= tol, f"{what} <= {tol}")
    print(f"  {name} loss: {ms:.1f} ms through the kernels, {plain_ms:.1f} "
          f"ms through the plain versions (wall, synchronised); peak "
          f"memory {peak:.2f} GiB")
    return {"metrics": got, "plain_metrics": want, "abs_diff": diff,
            "ms": ms, "plain_ms": plain_ms, "peak_gib": peak,
            "launches": launches}


def _freed(s: Smoke) -> None:
    import gc
    gc.collect()
    s.torch.cuda.empty_cache()
    held = s.torch.cuda.memory_allocated() / 2 ** 30
    s.check(held < 1.0, f"the earlier models' weights and pools are freed "
                        f"({held:.3f} GiB still allocated)")


def _model_at_seed(s: Smoke, cfg, what):
    from repro_torch.models.registry import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(s.torch.Generator(device=s.dev).manual_seed(0),
                        device=s.dev)
    s.torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    nbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"  {cfg.name}: {what}, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {n / 1e9:.4f} B "
          f"parameters ({nbytes / 1e9:.2f} GB) in {cfg.dtype}, random from "
          f"seed 0 ({time.perf_counter() - t0:.2f} s)")
    return model, params, n


def run_whisper(s: Smoke):
    """whisper-base in full (6 + 6 layers): 8 requests of 1,500 encoder
    frames and prompts of 17 to 416 tokens, 32 greedy tokens each,
    through ``Model.prefill`` with ``encoder_embeds`` and ``decode_step``
    over dense caches (``check_driven``): per prefill group B2 18 times
    (6 encoder layers non-causal, 6 causal, 6 cross over the frames) and
    B1 32 times (2 a layer and a final norm in the encoder, 3 a layer in
    the decoder, the final norm); per decode step B3 6 times, B2 6 times
    (the cross-attention's one-token query over the encoder's 1,500
    keys) and B1 19 times; held to a plain replay of the same calls,
    since the reference's decode rotates the cross query at position 0
    and so is no teacher-forced forward.  Then ``Model.loss`` of 2 x 448
    tokens with 1,500 frames each."""
    import numpy as np
    torch = s.torch
    from repro_torch.configs import get_config
    _freed(s)
    cfg = get_config("whisper-base")
    model, params, n = _model_at_seed(
        s, cfg, f"{cfg.encoder_layers} encoder and {cfg.num_layers} decoder "
                f"layers, ungated GELU")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, size=WH_PROMPT_LENS[
        i % len(WH_PROMPT_LENS)]).tolist() for i in range(WH_REQUESTS)]
    g = torch.Generator(device=s.dev).manual_seed(7)
    frames = torch.randn(WH_REQUESTS, WH_FRAMES, cfg.d_model, device=s.dev,
                         generator=g).bfloat16()
    L = cfg.num_layers
    run = check_driven(
        s, model, params, "whisper", prompts, {"encoder_embeds": frames},
        WH_CACHE_LEN,
        {"decode_attention": L, "flash_attention": L,
         "rmsnorm": 3 * L + 1},
        {"flash_attention": cfg.encoder_layers + 2 * L,
         "rmsnorm": 2 * cfg.encoder_layers + 1 + 3 * L + 1})
    g = torch.Generator(device=s.dev).manual_seed(8)
    batch = {name: torch.randint(0, cfg.vocab_size, (2, WH_CACHE_LEN),
                                 device=s.dev, generator=g)
             for name in ("tokens", "labels")}
    batch["encoder_embeds"] = frames[:2]
    loss = check_loss(s, model, params, "whisper", batch,
                      ("flash_attention", "rmsnorm"), WH_LOSS_TOL)
    del params
    return dict(run, parameters=n, loss=loss)


def run_serving_internvl2(s: Smoke):
    """internvl2-26b at full width and depth (48 layers, 48/8 heads of
    128, 19.9 B parameters): the 12 text requests served paged (B4 48
    times a step) and dense (B3), as the reference's engine serves the
    model, each held to an f32 plain forward of the same weights (a
    layer upcast at a time), the exact function the served path
    approximates: over 48 layers a bf16 forward, or a bf16 replay of the
    same calls, adds its own rounding to the served path's and misses by
    more (PERF.md §2); the gaps against both are reported; B1 97 times a
    step and a group, B2 48 times a group.  Then the vision splice
    through the model's entry points (``check_driven``): 2 prompts of 512
    tokens whose first 256 positions carry patch embeddings from the
    seed, 32 greedy tokens, held to a plain replay; then ``Model.loss``
    of the same batch with ``vision_embeds`` (the patch positions'
    labels masked)."""
    torch = s.torch
    from repro_torch.configs import get_config
    _freed(s)
    cfg = get_config("internvl2-26b")
    torch.cuda.reset_peak_memory_stats()
    model, params, n = _model_at_seed(s, cfg, f"{cfg.num_layers} layers, "
                                              f"frontend {cfg.frontend}")
    norms = 2 * cfg.num_layers + 1
    runs, stats = {}, {}
    f32 = _f32_layerwise_logits(model, params)
    for name, mode, kname in (("paged", dict(paged=True),
                               "paged_decode_attention"),
                              ("dense", dict(paged=False),
                               "decode_attention")):
        print(f"== serve internvl2-26b, {name}", flush=True)
        runs[name], stats[name] = check_serving(
            s, model, params, f"internvl2 {name}", mode,
            {kname: cfg.num_layers, "rmsnorm": norms, "flash_attention": 0},
            tuple(k for k in DECODE_KERNELS if k != kname),
            teacher_checked=False, replay=True, free_replay=False,
            per_group={"rmsnorm": norms, "flash_attention": cfg.num_layers})
        bgap, bwhere, _, bflipped = teacher_gap(s, model, params, runs[name])
        print(f"  internvl2 {name}: largest teacher-forced gap against the "
              f"bf16 plain forward {bgap:.4f} logits at {bwhere}, "
              f"{bflipped} not its argmax (reported)")
        gap, where, tokens, flipped = teacher_gap(s, model, params,
                                                  runs[name], forward=f32)
        s.check(gap <= TEACHER_GAP,
                f"internvl2 {name}: every emitted token within "
                f"{TEACHER_GAP} logits of the f32 plain forward's argmax "
                f"(largest gap {gap:.4f} at {where}; {flipped} of {tokens} "
                f"not its argmax)")
        stats[name].update(f32_gap=gap, f32_gap_at=where, f32_flipped=flipped,
                           bf16_forward_gap=bgap)
        for k in ("rmsnorm", "flash_attention", kname):
            s.kernels[k]["internvl2"]["launches"] = \
                stats[name]["launches"][k]
    del f32
    agree = _agree(runs["paged"], runs["dense"])
    print(f"  internvl2 dense and paged agree on {agree} of "
          f"{stats['paged']['tokens']} tokens")
    print("== internvl2-26b, the vision splice", flush=True)
    g = torch.Generator(device=s.dev).manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (IV_SPLICE_B, IV_SPLICE_S),
                           device=s.dev, generator=g)
    patches = torch.randn(IV_SPLICE_B, cfg.frontend_tokens, cfg.d_model,
                          device=s.dev, generator=g).bfloat16()
    splice = check_driven(
        s, model, params, "internvl2 splice", tokens.tolist(),
        {"vision_embeds": patches}, CACHE_LEN,
        {"decode_attention": cfg.num_layers, "rmsnorm": norms},
        {"flash_attention": cfg.num_layers, "rmsnorm": norms})
    batch = {"tokens": tokens, "labels": torch.randint(
        0, cfg.vocab_size, tokens.shape, device=s.dev, generator=g),
        "vision_embeds": patches}
    loss = check_loss(s, model, params, "internvl2", batch,
                      ("flash_attention", "rmsnorm"), IV_LOSS_TOL)
    peak = max(stats["paged"]["peak_gib"], stats["dense"]["peak_gib"],
               splice["peak_gib"], loss["peak_gib"])
    print(f"  internvl2-26b: peak memory {peak:.2f} GiB")
    del params, runs
    return dict(stats, tokens_agree={"dense_paged": agree}, splice=splice,
                loss=loss, parameters=n, peak_gib=peak)


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
                     ("decode NaN law (B3-B7q)", check_nan_law),
                     ("head-dim-256 builds (gemma2 shapes)",
                      check_head_dim_256),
                     ("B1-B7q (gemma3 shapes)", check_gemma3_shapes),
                     ("gmm (deepseek shapes)", check_gmm),
                     ("192/128 builds (deepseek shapes)", check_mla_builds),
                     ("mamba_scan (jamba shapes)", check_mamba_scan),
                     ("B1-B4 and gmm (jamba shapes)", check_jamba_shapes),
                     ("B1-B4 and gmm (arctic shapes)", check_arctic_shapes),
                     ("B1-B4 (whisper and internvl2 shapes)",
                      check_whisper_internvl2_shapes),
                     ("mlstm_scan (xlstm shapes)", check_mlstm_scan)):
        s.phase(f"kernel {name} against its plain version", fn, s)
    s.phase("portable runtime against native twins", run_parity, s)
    s.phase("SPEC ACCEL stand-ins on the device runtime", run_spec_accel, s)
    s.phase("miniQMC regions on the device runtime", run_miniqmc, s)
    torch.cuda.empty_cache()
    if s.failures:
        # a kernel that is wrong would make the serving run meaningless
        _die("failed before serving:\n  " + "\n  ".join(s.failures))
    s.serving_faults = s.serving_slo = None
    serving = s.phase("serve granite-8b at full width", run_serving, s)
    torch.cuda.empty_cache()
    serving_g2 = s.phase("serve gemma2-2b at full width", run_serving_gemma2,
                         s)
    torch.cuda.empty_cache()
    serving_g3 = s.phase("serve gemma3-4b at full width and depth, and "
                         f"gemma3-27b at full width, {G3_27B_LAYERS} layers",
                         run_serving_gemma3, s)
    torch.cuda.empty_cache()
    serving_ds = s.phase("serve deepseek-v2-lite-16b at full width",
                         run_serving_deepseek, s)
    serving_ar = s.phase(f"serve arctic-480b at full width, {AR_LAYERS} "
                         f"layers", run_serving_arctic, s)
    serving_jb = s.phase("serve jamba-1.5-large-398b at full width, "
                         f"{JB_LAYERS} layers", run_serving_jamba, s)
    serving_xl = s.phase(f"serve xlstm-1.3b at full width, {XL_LAYERS} "
                         f"layers, and its loss", run_serving_xlstm, s)
    serving_wh = s.phase("serve whisper-base in full through its entry "
                         "points, and its loss", run_whisper, s)
    serving_iv = s.phase("serve internvl2-26b at full width and depth, its "
                         "vision splice and its loss", run_serving_internvl2,
                         s)
    traces = s.phase("trace the card over paged decode steps", run_traces, s)

    for k in s.kernels.values():
        # the main path's count: the first serving run that launched it
        k["launches"] = next((n for n in k["launches_by_path"].values()
                              if n), 0)
    if serving is not None:
        print(json.dumps({"serving": serving}))
    if s.serving_faults is not None:
        print(json.dumps({"serving_faults": s.serving_faults}))
    if s.serving_slo is not None:
        print(json.dumps({"serving_slo": s.serving_slo}))
    if serving_g2 is not None:
        print(json.dumps({"serving_gemma2": serving_g2}))
    if serving_g3 is not None:
        print(json.dumps({"serving_gemma3": serving_g3}))
    if serving_ds is not None:
        print(json.dumps({"serving_deepseek": serving_ds}))
    if serving_ar is not None:
        print(json.dumps({"serving_arctic": serving_ar}))
    if serving_jb is not None:
        print(json.dumps({"serving_jamba": serving_jb}))
    if serving_xl is not None:
        print(json.dumps({"serving_xlstm": serving_xl}))
    if serving_wh is not None:
        print(json.dumps({"serving_whisper": serving_wh}))
    if serving_iv is not None:
        print(json.dumps({"serving_internvl2": serving_iv}))
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
