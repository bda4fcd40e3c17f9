"""Continuous-batching serving engine (``repro.serve.engine``): batched
prefill admission and a device-resident decode loop over a paged or a
dense KV cache.

Scheduler state (active mask, lengths, current tokens, emitted-token
counts, per-slot decode budgets) lives on the device.  ``step()`` runs
the model step, the sampling and the length/finish updates as device
ops and then makes exactly one device-to-host copy
(:func:`_device_get`) of the (next token, done) pair.  The host keeps numpy mirrors, updated from that copy, for
admission and page allocation only.  Admission groups queued requests
by exact effective prompt length and prefills each group in one batched
call (one more copy per group, for the first sampled tokens), then
scatters the group's K/V into slot rows (dense) or fresh pages (paged).

Sampling: greedy (argmax) at ``temperature`` 0; above it, Gumbel-max
over the whole (slots, vocab) logits, ``argmax(logits / T + g)`` in f32
with ``g = -log(-log(u))`` and ``u`` from one ``torch.Generator`` on the
engine's device seeded from ``ServeConfig.seed`` (the law
``jax.random.categorical`` samples by).  The same seed gives the same
tokens on one device; a CPU and a CUDA generator give different
streams, and neither gives the reference's threefry stream.

Termination: a slot finishes when it has emitted its budget
(``min(Request.max_new, max_new_tokens)``, held on the device per slot
and written by the admission's upload), sampled ``eos_id``, or filled
its cache (``lengths == cache_len`` after the final row is written, so
the last row is usable).

Oversubscription (paged): when an explicit ``total_pages`` leaves the
pool smaller than the working set, a slot crossing a page boundary can
find the pool dry.  ``preempt_policy`` "lru" preempts the least-recently
admitted other slot, "shortest" the one with the fewest generated
tokens, "priority" the lowest ``Request.priority_class`` (oldest
admission on ties; it also lets a waiting request of a strictly higher
class evict at admission), "fail" raises the allocator's error.  A
preempted request is checkpointed as prompt + tokens so far onto a
requeue deque and re-prefills on re-admission, which under greedy
decoding reproduces the un-preempted outputs token for token.
Admission takes the highest ``priority_class`` first and, within a
class, checkpoints ahead of fresh requests (the starvation guard), FIFO
within each; with uniform classes that is checkpoints, then the queue.

Quantized KV (paged): ``kv_dtype`` "int8" or "fp8_e4m3" stores the
pools in that type with per-(head, page) f32 scales, resolved against
what the device holds (``quant.resolve_kv_spec``, fp8 -> int8 -> bf16
with a warning).

Sliding-window layers (paged): a model with ``local`` layers whose
window is shorter than the cache pages them as a *window group*, over
a pool of their own (``total_pages_window``, default 1 + slots * T_w)
through ring block tables of width T_w = ``paging.window_table_width``.
A slot holds only its live window pages there: admission allocates the
prompt's, and each step first frees the pages the window slid past
(``paging.free_prefix``, counted in ``serve.window_prefix_frees``),
then ensures the write page.  The dense engine keeps such layers in
rings of the window.

MLA models (deepseek-v2-lite-16b) cache the materialised per-head K
and V, of their own widths, in the pools and the dense caches alike,
and are served from int8/fp8 pools and speculatively as GQA models
are.

Models with recurrent layers (jamba-1.5's mamba layers; xlstm-1.3b's
mLSTM and sLSTM layers) keep each such layer's state (mamba ``h``;
mLSTM ``C``, ``n``, ``m``; sLSTM ``c``, ``n``, ``m``, ``h``; and the
conv tail) dense and slot-major in both engines.  Every decode step
updates every slot's state, idle ones too; admission overwrites the
whole state of the slots it fills, so a re-admitted slot (after
preemption, or a new request) starts from its own prefill alone.  A
model with no attention layer (xlstm-1.3b) has no page pool that any
kernel reads, yet the paged engine keeps its block tables, allocator
and preemption as for any other model, as the reference's does.  With
``kv_dtype`` int8/fp8 their attention layers' pools quantize as any
model's do, while the recurrent state keeps its dense slot-major leaves
in the model's dtype (``repro`` paging.py:454); a model of recurrent
layers alone then has no pool to quantize, and its engine differs from
the bf16 one only in the spec it reports and the page size it resolves,
as the reference's does.  Speculation is refused as for every recurrent
layer: a batched verify cannot roll the state back.

An encoder-decoder (whisper-base) is refused at construction: a request
carries no encoder input, and the reference's engine, which prefills
with no extras, fails at its first admission for want of the encoder's
K/V.  A vision model (internvl2-26b) is served as the reference serves
it, on text prompts alone; the patch splice is reached through
``Model.prefill``'s and ``Model.loss``'s extras.

Self-speculative decoding (paged, greedy): ``spec_mode="ngram"`` drafts
``spec_k`` tokens per slot from the slot's own token history
(``tok_hist``: prompt lookup, no draft model), verifies the committed
token and the drafts in one K1 = spec_k + 1 position step, accepts the
longest prefix that agrees with the argmax chain, and rolls the
rejected tail's pages back with ``paging.truncate_suffix``.  Still one
device-to-host copy per step, of (tokens, accepted count, done).

Fault recovery (paged; ``serve/faults.py`` injects the faults): the
step computes a NaN/Inf logits sentinel ``bad`` per slot and carries it
in its one copy, beside the tokens and ``done``, so detection costs no
extra sync.  A host watchdog bounds the time from dispatch to that
copy.  Nothing of a step commits before the watchdog check: a step past
its deadline is discarded and every active slot requeues.  A flagged
slot commits nothing either; its live pages are scanned on the device
(one more copy, of the per-page flags, on the fault path only), the
corrupted ones quarantined, and the request checkpointed onto the
requeue deque, with a retry budget (``max_retries``) and an exponential
backoff in engine steps (``retry_backoff``, read at admission through
``Request.not_before``).  An exhausted budget ends the request with
status ``failed`` instead of raising.  An injected allocation failure
sends the slot asking for a page down the same ladder.  In speculative
mode, ``spec_disable_after`` faults of one request pin it to one token
a step (``spec_ok``, a device mask re-uploaded only when it changes).
The decode step writes K/V rows, recurrent state and the token history
in place, so a discarded or flagged step has already written them: it
is still safe, because every such slot is requeued and re-prefilled,
and re-admission rewrites all of its rows.  Recovery is re-prefill of
the committed checkpoint, so under greedy decoding a recovered request
emits the tokens of an unfaulted run (on the card, up to the prefill
kernel's rounding at a near tie).

Telemetry (``serve/telemetry.py``): ``Engine(..., telemetry=...)``
records every lifecycle transition (submit, admit, first token, tokens,
preempt, fault, requeue, spec degrade, finish, fail, watchdog trip) and
a per-step sample (emitted and accepted tokens, flagged slots, page
pools) into a bounded trace and latency histograms.  The hooks run on
the host after the step's one copy and read host state only: they add
no copy and no launch, and without telemetry each site costs one ``is
None`` check.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import tuning
from repro_torch.core.device import DeviceLike, dtype_of, resolve_device
from repro_torch.models.registry import Model
from repro_torch.models.transformer import (RECURRENT_KINDS, kv_dims,
                                            recurrent_cache)
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.quant import resolve_kv_spec
from repro_torch.serve import paging
from repro_torch.serve.faults import (FAULT_KINDS, FaultPlan, corrupt_page,
                                      nonfinite_pages)


def _device_get(t: torch.Tensor) -> np.ndarray:
    """The engine's device-to-host copy (tests count its calls)."""
    return t.cpu().numpy()


def sample(logits: torch.Tensor, temperature: float,
           generator: torch.Generator) -> torch.Tensor:
    """Next tokens (int32) from (..., vocab) logits: the argmax at
    ``temperature`` 0, else Gumbel-max, ``argmax(logits / T + g)`` in
    f32 with ``g = -log(-log(u))``, ``u`` uniform from ``generator``
    (on the logits' device) and clamped away from 0.  Device ops only:
    no host sync."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    g = -torch.log(-torch.log(u.clamp_(min=torch.finfo(torch.float32).tiny)))
    return torch.argmax(logits.float() / temperature + g,
                        dim=-1).to(torch.int32)


@dataclasses.dataclass
class ServeConfig:
    slots: int = 4
    cache_len: int = 128
    max_new_tokens: int = 16
    temperature: float = 0.0           # 0: greedy; > 0: Gumbel-max
    eos_id: Optional[int] = None
    seed: int = 0                      # the sampler's generator
    paged: bool = False
    page_size: Optional[int] = None    # None -> the tuning table (64)
    total_pages: Optional[int] = None  # None -> 1 + slots*pages_per_slot
    # the window group's pool (paged, local layers): None -> 1 + slots*T_w
    total_pages_window: Optional[int] = None
    on_overflow: str = "reject"        # "reject" | "truncate"
    # "lru" | "shortest" | "priority" (lowest Request.priority_class
    # first, and admission-time eviction by a strictly higher class) |
    # "fail"
    preempt_policy: str = "lru"
    # KV pool dtype (paged only): None = the model's dtype; "bf16" |
    # "int8" | "fp8_e4m3" resolve against what the device holds
    kv_dtype: Optional[str] = None
    # self-speculative decoding (paged, greedy): "ngram" drafts spec_k
    # tokens per step from the slot's own history; "off" is plain
    spec_mode: str = "off"
    spec_k: int = 4
    # fault recovery (paged): a faulted slot is requeued and re-prefilled
    # at most max_retries times, retry_backoff * 2**(retries - 1) engine
    # steps apart, then fails; watchdog_s bounds one step's dispatch and
    # copy (None: off), armed after the engine's first step, which
    # builds the kernels; spec_disable_after faults of one request in
    # speculative steps pin it to one token a step
    max_retries: int = 3
    retry_backoff: int = 2
    watchdog_s: Optional[float] = None
    spec_disable_after: int = 2


#: Valid ServeConfig.preempt_policy values (launch/serve.py choices).
PREEMPT_POLICIES = ("lru", "shortest", "priority", "fail")

#: Valid ServeConfig.spec_mode values (launch/serve.py choices).
SPEC_MODES = ("off", "ngram")


@dataclasses.dataclass
class Request:
    rid: int
    tokens: List[int]
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False
    preempts: int = 0       # times this request was preempted/requeued
    # SLO class: higher = more latency-sensitive (admission order, the
    # "priority" policy, per-class telemetry); traffic_class is the
    # workload's label ("chat", "longdoc", "batch")
    priority_class: int = 0
    traffic_class: Optional[str] = None
    # this request's decode budget, capped by ServeConfig.max_new_tokens
    # (None: the engine's)
    max_new: Optional[int] = None
    # fault recovery (engine-managed): retries spent, the earliest engine
    # step of re-admission (the backoff stamp), the terminal failure, and
    # the speculative-step faults that disable drafting at
    # ServeConfig.spec_disable_after
    retries: int = 0
    not_before: int = 0
    failed: bool = False
    spec_faults: int = 0
    spec_disabled: bool = False

    @property
    def status(self) -> str:
        """'done' | 'failed' | 'pending'."""
        if self.failed:
            return "failed"
        return "done" if self.done else "pending"


class Engine:
    def __init__(self, model: Model, params: Dict[str, Any],
                 sc: ServeConfig, device: DeviceLike = None,
                 fault_plan: Optional[FaultPlan] = None, telemetry=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine on {self.device}")
        if sc.spec_mode not in SPEC_MODES:
            raise ValueError(f"spec_mode must be one of {SPEC_MODES}, "
                             f"got {sc.spec_mode!r}")
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"{model.cfg.name}: the engine serves decoders; an "
                f"encoder-decoder needs each request's encoder input, "
                f"which neither this engine nor the reference's takes "
                f"(its prefill passes no extras, so its first admission "
                f"finds no encoder K/V): drive Model.prefill(tokens, "
                f"cache_len, {{'encoder_embeds': ...}}) and decode_step")
        self.spec = sc.spec_mode != "off"
        kinds = model.cfg.layer_kinds()
        recurrent = [i for i, k in enumerate(kinds) if k in RECURRENT_KINDS]
        if self.spec:
            if not sc.paged:
                raise ValueError("spec_mode requires paged=True (rollback "
                                 "is block-table suffix truncation)")
            if sc.temperature > 0.0:
                raise ValueError(
                    f"spec_mode={sc.spec_mode!r} requires greedy decoding: "
                    f"verification accepts drafts by token identity with "
                    f"the argmax chain, which sampling at temperature="
                    f"{sc.temperature} breaks; set temperature=0.0")
            if sc.spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {sc.spec_k}")
            if set(kinds) - {"global"}:
                raise ValueError(
                    f"spec_mode supports attention-only decoder models "
                    f"(global attention); layer kinds {sorted(set(kinds))} "
                    f"include state that a batched verify cannot roll back")
        if sc.kv_dtype is not None and not sc.paged:
            raise ValueError("kv_dtype requires paged=True (only paged "
                             "pools are dtype-parametric)")
        if sc.preempt_policy not in PREEMPT_POLICIES:
            raise ValueError(f"preempt_policy must be one of "
                             f"{PREEMPT_POLICIES}, got {sc.preempt_policy!r}")
        if sc.on_overflow not in ("reject", "truncate"):
            raise ValueError(f"on_overflow must be 'reject' or 'truncate', "
                             f"got {sc.on_overflow!r}")
        if sc.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{sc.max_retries}")
        if sc.retry_backoff < 0:
            raise ValueError(f"retry_backoff must be >= 0, got "
                             f"{sc.retry_backoff}")
        if fault_plan is not None and not sc.paged:
            raise ValueError("fault injection requires paged=True "
                             "(kv_corrupt/alloc_fail target the page pool)")
        self.model, self.params, self.sc = model, params, sc
        self.cfg = cfg = model.cfg
        slots, dev = sc.slots, self.device

        self.paged = sc.paged
        self.kv_spec = None
        if self.paged:
            self.kv_spec = resolve_kv_spec(sc.kv_dtype, self.device)
            quantized = self.kv_spec is not None and self.kv_spec.quantized
            op = ("quant_paged_decode_attention" if quantized
                  else "paged_decode_attention")
            ps = sc.page_size or tuning.block_size(op, "page_size")
            self.page_size = max(1, min(int(ps), sc.cache_len))
            self.pages_per_slot = paging.pages_per_slot(sc.cache_len,
                                                        self.page_size)
            total = sc.total_pages or (1 + slots * self.pages_per_slot)
            self.allocator = paging.PageAllocator(total)
            self.block_tables = np.full((slots, self.pages_per_slot),
                                        paging.NULL_PAGE, np.int32)
            self._bt_dev = self._upload(self.block_tables)
            self._bt_dirty = False
            # pages ensured for each slot this step: the horizon the spec
            # step's rollback truncates back from
            self._ensured = np.zeros((slots,), np.int64)
            # the window group: local layers whose window is shorter
            # than the cache page through ring tables over their own
            # pool, O(window) pages per slot
            self.window = cfg.window
            self.windowed = bool("local" in kinds and cfg.window
                                 and cfg.window < sc.cache_len)
            window_layers, total_w = (), None
            if self.windowed:
                window_layers = [i for i, k in enumerate(kinds)
                                 if k == "local"]
                self.tw = paging.window_table_width(cfg.window,
                                                    self.page_size)
                total_w = sc.total_pages_window or (1 + slots * self.tw)
                self.allocator_w = paging.PageAllocator(total_w)
                self.block_tables_w = np.full((slots, self.tw),
                                              paging.NULL_PAGE, np.int32)
                self._btw_dev = self._upload(self.block_tables_w)
                self._btw_dirty = False
                # first live global page per slot: the mark free_prefix
                # advances from
                self.win_first = np.zeros((slots,), np.int64)
            heads, dk, dv = kv_dims(cfg)
            dt = dtype_of(cfg.dtype)
            self.caches = paging.init_paged_caches(
                cfg.num_layers, heads, dk, total, self.page_size, device=dev,
                dtype=dt, kv_spec=self.kv_spec, window_layers=window_layers,
                total_pages_window=total_w, v_head_dim=dv,
                recurrent={i: recurrent_cache(cfg, kinds[i], slots, dt, dev)
                           for i in recurrent})
        else:
            self.windowed = False
            self.caches = model.init_decode_caches(slots, sc.cache_len, dev)

        # device-resident scheduler state
        i32 = dict(dtype=torch.int32, device=dev)
        self.lengths = torch.zeros((slots,), **i32)
        self.cur_tok = torch.zeros((slots,), **i32)
        self.n_out = torch.zeros((slots,), **i32)
        self.active_mask = torch.zeros((slots,), dtype=torch.bool, device=dev)
        # each slot's decode budget, written by the admission's upload
        self.max_new = torch.full((slots,), sc.max_new_tokens, **i32)
        self.generator = torch.Generator(device=dev).manual_seed(sc.seed)
        if self.spec:
            # committed token history: position p holds the token whose
            # K/V sits in cache row p; column cache_len absorbs writes
            # clipped at the cache edge.  Only the proposer reads it.
            self.tok_hist = torch.zeros((slots, sc.cache_len + 1), **i32)
            self._rows = torch.arange(slots, device=dev)
            self._hist_idx = torch.arange(sc.cache_len + 1, **i32)[None, :]
            self._win_idx = torch.arange(sc.spec_k + 1, **i32)[None, :]
        # host mirrors (admission control / page allocation only)
        self._len_h = np.zeros((slots,), np.int64)
        self._active_h = np.zeros((slots,), bool)

        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        # preempted checkpoints, re-admitted ahead of the fresh queue
        self.requeue: collections.deque = collections.deque()
        self.metrics = MetricsRegistry()
        # the optional ServeTelemetry: every hook site costs one ``is
        # None`` check without it
        self.telemetry = telemetry
        self.metrics.counter("serve.preemptions")
        for p in PREEMPT_POLICIES:
            self.metrics.counter(f"serve.preemptions.{p}")
        self.metrics.gauge("serve.requeue_peak_depth")
        for name in ("spec_steps", "spec_emitted", "spec_rejections",
                     "window_prefix_frees", "failed_requests",
                     "watchdog_trips"):
            self.metrics.counter(f"serve.{name}")
        for k in FAULT_KINDS:
            self.metrics.counter(f"serve.recoveries.{k}")
        self._admit_seq = np.zeros((slots,), np.int64)   # lru stamps
        self._seq = 0
        # the step counter backoff stamps are quoted in: it ticks on idle
        # steps too, so a request backing off always comes back
        self.step_count = 0
        # fault recovery: the plan (None in production), the watchdog's
        # deadline, the sticky injected allocation failure, the (step,
        # wall time) of the last trip and recovery, the all-false NaN
        # mask kept on the device for steps that inject none, and the
        # per-slot drafting enable of the speculative step
        self.fault_plan = fault_plan
        self.watchdog_s = sc.watchdog_s
        self._alloc_deny = False
        self.last_watchdog_trip: Optional[Dict[str, Any]] = None
        self.last_recovery: Optional[Dict[str, Any]] = None
        self._nan_none = torch.zeros((slots,), dtype=torch.bool, device=dev)
        self._spec_ok_h = np.ones((slots,), bool)
        self._spec_ok_dev = self._upload(self._spec_ok_h)
        self._spec_ok_dirty = False

    @property
    def preemptions(self) -> int:
        return self.metrics.counter("serve.preemptions").value

    @property
    def spec_steps(self) -> int:
        return self.metrics.counter("serve.spec_steps").value

    @property
    def spec_emitted(self) -> int:
        return self.metrics.counter("serve.spec_emitted").value

    @property
    def spec_rejections(self) -> int:
        return self.metrics.counter("serve.spec_rejections").value

    @property
    def window_prefix_frees(self) -> int:
        return self.metrics.counter("serve.window_prefix_frees").value

    @property
    def recoveries(self) -> Dict[str, int]:
        return {k: self.metrics.counter(f"serve.recoveries.{k}").value
                for k in FAULT_KINDS}

    @property
    def failed_requests(self) -> int:
        return self.metrics.counter("serve.failed_requests").value

    @property
    def watchdog_trips(self) -> int:
        return self.metrics.counter("serve.watchdog_trips").value

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without waiting for the
        device: a pageable source is staged before the call returns, so
        the array may change afterwards (``_device_get`` is the step's
        only sync)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, non_blocking=True)

    # -- request lifecycle ------------------------------------------------
    def submit(self, req: Request) -> None:
        """Queue a request; a prompt that leaves no room for one decoded
        token is rejected (or tail-truncated) here."""
        limit = self.sc.cache_len - 1
        if self.paged:
            usable = self.allocator.usable
            if self.sc.on_overflow == "truncate":
                limit = min(limit, usable * self.page_size - 1)
            elif paging.pages_per_slot(len(req.tokens) + 1,
                                       self.page_size) > usable:
                # +1: the first decode step writes one more row
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.tokens)} tokens "
                    f"(+1 decode) needs more KV pages than the whole pool "
                    f"holds ({usable} x {self.page_size}); raise total_pages")
            elif self.windowed and len(paging.live_window_pages(
                    len(req.tokens) + 1, self.window,
                    self.page_size)) > self.allocator_w.usable:
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.tokens)} tokens "
                    f"needs more window KV pages than the window pool "
                    f"holds ({self.allocator_w.usable} x {self.page_size}); "
                    f"raise total_pages_window")
        if len(req.tokens) > limit:
            if self.sc.on_overflow == "truncate" and limit > 0:
                warnings.warn(
                    f"request {req.rid}: prompt of {len(req.tokens)} tokens "
                    f"exceeds the cache capacity of {limit}; keeping the "
                    f"last {limit}", stacklevel=2)
                req.tokens = list(req.tokens[-limit:])
                req.truncated = True
            else:
                raise ValueError(
                    f"request {req.rid}: prompt of {len(req.tokens)} tokens "
                    f"does not fit cache_len={self.sc.cache_len} (need <= "
                    f"cache_len-1; set ServeConfig.on_overflow='truncate' "
                    f"to clip instead)")
        if not req.tokens:
            raise ValueError(f"request {req.rid}: empty prompt")
        if req.max_new is not None and req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1, "
                             f"got {req.max_new}")
        self.queue.append(req)
        if self.telemetry is not None:
            self.telemetry.on_submit(req, self.step_count)

    def _req_max_new(self, req: Request) -> int:
        """The request's decode budget, capped by the engine's."""
        if req.max_new is None:
            return self.sc.max_new_tokens
        return min(req.max_new, self.sc.max_new_tokens)

    def _free_slots(self) -> List[int]:
        return [s for s in range(self.sc.slots) if self.active[s] is None]

    def _take_waiting(self, n: int) -> List[Request]:
        """Up to ``n`` waiting requests whose backoff has expired, the
        highest ``priority_class`` first; within a class, checkpoints
        ahead of fresh requests (the starvation guard), FIFO within
        each.  The others keep their order."""
        cand = [(-r.priority_class, 0, i) for i, r in enumerate(self.requeue)
                if r.not_before <= self.step_count]
        cand += [(-r.priority_class, 1, i) for i, r in enumerate(self.queue)
                 if r.not_before <= self.step_count]
        take = sorted(cand)[:max(n, 0)]
        pools = (self.requeue, self.queue)
        picked = [pools[pool][i] for _, pool, i in take]
        for _, pool, i in sorted(take, key=lambda t: t[2], reverse=True):
            del pools[pool][i]
        return picked

    def _requeue_front(self, reqs: List[Request]) -> None:
        for r in reversed(reqs):
            if r.preempts:
                self.requeue.appendleft(r)
            else:
                self.queue.insert(0, r)

    @torch.no_grad()
    def _admit(self) -> None:
        """Admit waiting requests into free slots: one batched prefill and
        one batched cache scatter per effective-prompt-length group;
        under "priority", evict for a waiting higher class first."""
        if self.paged and self.sc.preempt_policy == "priority":
            self._priority_admission_preempt()
        while self._free_slots() and (self.requeue or self.queue):
            batch = self._take_waiting(len(self._free_slots()))
            if not batch:
                # everything waiting backs off; idle steps tick
                # step_count, so the stamps expire
                return
            groups: Dict[int, List[Request]] = {}
            for r in batch:
                groups.setdefault(len(r.tokens) + len(r.out), []).append(r)
            admitted = sum(self._admit_group(reqs, plen)
                           for plen, reqs in groups.items())
            # a request finishing at admission frees its slot at once, so
            # loop to backfill; zero admissions means the pool is full
            if admitted == 0:
                return

    def _admit_group(self, reqs: List[Request], plen: int) -> int:
        sc = self.sc
        if self.paged:
            # +1: the first decode step writes at position plen; a
            # checkpoint at plen == cache_len finishes at admission
            need = paging.pages_per_slot(min(plen + 1, sc.cache_len),
                                         self.page_size)
            fit = self.allocator.available // max(need, 1)
            if self.windowed:
                need_w = len(paging.live_window_pages(
                    min(plen + 1, sc.cache_len), self.window,
                    self.page_size))
                fit = min(fit, self.allocator_w.available // max(need_w, 1))
            if fit < len(reqs):
                self._requeue_front(reqs[fit:])
                reqs = reqs[:fit]
            if not reqs:
                return 0
        slots = self._free_slots()[:len(reqs)]
        k = len(reqs)
        toks = self._upload(np.array([r.tokens + r.out for r in reqs],
                                     np.int64))
        logits, cache1 = self.model.prefill(self.params, toks, sc.cache_len)
        first = sample(logits, sc.temperature, self.generator)
        first_h = _device_get(first)                 # one copy per group

        page_rows = page_rows_w = None
        if self.paged:
            rows = np.full((k, self.pages_per_slot), paging.NULL_PAGE,
                           np.int32)
            n_pages = paging.pages_per_slot(plen, self.page_size)
            for i, slot in enumerate(slots):
                rows[i, :n_pages] = self.allocator.alloc_many(n_pages)
                self.block_tables[slot] = rows[i]
            page_rows = self._upload(rows)
            self._bt_dirty = True
            if self.windowed:
                # only the prompt's live window pages: rows_w is indexed
                # by global page for the scatter, the ring table keeps
                # the same pages at column g % T_w
                rows_w = np.full((k, self.pages_per_slot), paging.NULL_PAGE,
                                 np.int32)
                live = paging.live_window_pages(plen, self.window,
                                                self.page_size)
                for i, slot in enumerate(slots):
                    for g in live:
                        rows_w[i, g] = self.allocator_w.alloc()
                        self.block_tables_w[slot, g % self.tw] = rows_w[i, g]
                    self.win_first[slot] = live.start
                page_rows_w = self._upload(rows_w)
                self._btw_dirty = True

        admit_active = np.ones((k,), bool)
        for i, req in enumerate(reqs):
            req.out.append(int(first_h[i]))
            hit_eos = sc.eos_id is not None and first_h[i] == sc.eos_id
            # plen + 1 > cache_len: a checkpoint whose cache is full after
            # re-prefill; its sample is the final token of the run
            if (hit_eos or len(req.out) >= self._req_max_new(req)
                    or plen + 1 > sc.cache_len):
                admit_active[i] = False

        slot_idx = self._upload(np.array(slots, np.int64))
        if self.windowed:
            paging.scatter_prefill(
                self.caches, cache1, slot_idx, page_rows, page_rows_w,
                plens=self._upload(np.full((k,), plen, np.int64)),
                window=self.window)
        else:
            paging.scatter_prefill(self.caches, cache1, slot_idx, page_rows)
        if self.spec:
            # history rows for the proposer: the prompt and the tokens
            # so far, not the prefill sample (it is cur_tok, and the
            # spec step writes it at position plen itself)
            hist = np.zeros((k, sc.cache_len + 1), np.int32)
            for i, r in enumerate(reqs):
                hist[i, :plen] = r.tokens + r.out[:-1]
            self.tok_hist[slot_idx] = self._upload(hist)
        self.lengths.index_fill_(0, slot_idx, plen)
        self.cur_tok[slot_idx] = first
        self.active_mask[slot_idx] = self._upload(admit_active)
        # fresh admissions enter with n_out = 1 (the prefill sample);
        # re-admitted checkpoints resume their real count.  The budgets
        # ride the same upload.
        counts = self._upload(np.array(
            [[len(r.out) for r in reqs],
             [self._req_max_new(r) for r in reqs]], np.int32))
        self.n_out[slot_idx] = counts[0]
        self.max_new[slot_idx] = counts[1]

        tel = self.telemetry
        for i, (req, slot) in enumerate(zip(reqs, slots)):
            self._seq += 1
            self._admit_seq[slot] = self._seq
            if self.spec and self._spec_ok_h[slot] == req.spec_disabled:
                # the degrade rung: a request that faulted in speculative
                # steps too often decodes one token a step from now on
                self._spec_ok_h[slot] = not req.spec_disabled
                self._spec_ok_dirty = True
            if tel is not None:
                tel.on_admit(req, slot, self.step_count)
                # the prefill sample is the first generated token only
                # on a fresh admission; a checkpoint resumes its history
                if len(req.out) == 1:
                    tel.on_first_token(req, slot, self.step_count)
                tel.on_tokens(req, slot, self.step_count, 1)
            if admit_active[i]:
                self.active[slot] = req
                self._active_h[slot] = True
                self._len_h[slot] = plen
            else:
                req.done = True                      # finished at prefill
                if tel is not None:
                    tel.on_finish(req, slot, self.step_count)
                self._release(slot)
        return k

    def _release(self, slot: int) -> None:
        """Return a slot (and its pages) to the pool."""
        self.active[slot] = None
        self._active_h[slot] = False
        self._len_h[slot] = 0
        if self.paged:
            self.allocator.reclaim(self.block_tables[slot])
            self.block_tables[slot] = paging.NULL_PAGE
            self._bt_dirty = True
            if self.windowed:
                self.allocator_w.reclaim(self.block_tables_w[slot])
                self.block_tables_w[slot] = paging.NULL_PAGE
                self.win_first[slot] = 0
                self._btw_dirty = True

    # -- preempt/requeue scheduler ----------------------------------------
    def _select_victim(self, needy: int) -> Optional[int]:
        """The slot to preempt so ``needy`` can take a page; never the
        needy slot itself (so the grower makes progress), None when no
        other slot is active."""
        cands = [int(s) for s in np.nonzero(self._active_h)[0]
                 if int(s) != needy]
        if not cands:
            return None
        if self.sc.preempt_policy == "lru":
            return min(cands, key=lambda s: self._admit_seq[s])
        if self.sc.preempt_policy == "priority":
            # lowest class first, the lru rule within a class
            return min(cands, key=lambda s: (self.active[s].priority_class,
                                             self._admit_seq[s]))
        # "shortest": fewest generated tokens, oldest admission on ties
        return min(cands, key=lambda s: (len(self.active[s].out),
                                         self._admit_seq[s]))

    def _priority_admission_preempt(self) -> None:
        """Admission-time eviction ("priority"): while no slot is free
        and the best backoff-eligible waiting class strictly exceeds the
        lowest active slot's, checkpoint that slot.  Strict, so equal
        classes never churn; the checkpoint re-enters ahead of fresh
        requests of its class, so every class keeps draining."""
        while not self._free_slots():
            waiting = [r.priority_class
                       for pool in (self.requeue, self.queue)
                       for r in pool if r.not_before <= self.step_count]
            slots = [int(s) for s in np.nonzero(self._active_h)[0]]
            if not waiting or not slots:
                return
            victim = min(slots, key=lambda s: (
                self.active[s].priority_class, self._admit_seq[s]))
            if max(waiting) <= self.active[victim].priority_class:
                return
            self._preempt(victim)

    def _preempt(self, slot: int) -> None:
        """Checkpoint ``slot`` onto the requeue deque and reclaim its
        pages; its device rows are parked like a released slot's."""
        req = self.active[slot]
        eff = len(req.tokens) + len(req.out)
        usable = self.allocator.usable
        if paging.pages_per_slot(min(eff + 1, self.sc.cache_len),
                                 self.page_size) > usable:
            raise RuntimeError(
                f"request {req.rid}: checkpoint of {eff} tokens needs more "
                f"KV pages than the pool's usable capacity ({usable} x "
                f"{self.page_size}); raise ServeConfig.total_pages")
        req.preempts += 1
        self.metrics.counter("serve.preemptions").inc()
        self.metrics.counter(
            f"serve.preemptions.{self.sc.preempt_policy}").inc()
        self.requeue.append(req)
        self.metrics.gauge("serve.requeue_peak_depth").set_max(
            len(self.requeue))
        if self.telemetry is not None:
            self.telemetry.on_preempt(req, slot, self.step_count)
        # before the next decode, not after; a fill, not a copy of a host
        # scalar, which would wait on the card
        self.active_mask[slot].fill_(False)
        self._release(slot)

    def _ensure_pages(self, horizon: int = 1) -> None:
        """Allocate the pages the next ``horizon`` tokens of each active
        slot write into (plain decode: 1; the spec step: its whole
        window, capped at the cache), preempting a victim when the pool
        is dry (unless "fail").  An injected allocation failure denies
        the first slot that asks for a page: it goes down the recovery
        ladder instead (before any preemption, as the reference does)."""
        for slot in np.nonzero(self._active_h)[0]:
            slot = int(slot)
            if not self._active_h[slot]:       # preempted earlier in loop
                continue
            target = min(int(self._len_h[slot]) + horizon, self.sc.cache_len)
            if self.windowed:
                # eager reclaim first: the pages the window left behind
                # go back to the pool before anything allocates
                new_first = paging.first_live_page(target, self.window,
                                                   self.page_size)
                freed = paging.free_prefix(
                    self.allocator_w, self.block_tables_w[slot],
                    int(self.win_first[slot]), new_first)
                if freed:
                    self.metrics.counter("serve.window_prefix_frees").inc(
                        freed)
                    self._btw_dirty = True
                self.win_first[slot] = new_first
            needed = paging.pages_per_slot(target, self.page_size)
            faulted = False
            for j in range(needed):
                if self.block_tables[slot, j] != paging.NULL_PAGE:
                    continue
                if self._alloc_deny:
                    # sticky until it bites, one-shot once it has
                    self._alloc_deny = False
                    self._fault_requeue(slot, "alloc_fail")
                    faulted = True
                    break
                self._make_room(self.allocator, slot, "total_pages")
                self.block_tables[slot, j] = self.allocator.alloc()
                self._bt_dirty = True
            if faulted:
                continue
            self._ensured[slot] = needed
            if not self.windowed:
                continue
            # the column a fresh page lands in was vacated by free_prefix
            # (its old tenant is T_w pages behind, outside the window)
            for g in paging.live_window_pages(target, self.window,
                                              self.page_size):
                col = g % self.tw
                if self.block_tables_w[slot, col] != paging.NULL_PAGE:
                    continue
                self._make_room(self.allocator_w, slot, "total_pages_window")
                self.block_tables_w[slot, col] = self.allocator_w.alloc()
                self._btw_dirty = True

    def _make_room(self, allocator: paging.PageAllocator, slot: int,
                   knob: str) -> None:
        """Preempt victims until ``allocator`` has a page for ``slot``
        (unless the policy is "fail", when the alloc raises)."""
        if self.sc.preempt_policy == "fail":
            return
        while allocator.available == 0:
            victim = self._select_victim(slot)
            if victim is None:
                raise RuntimeError(
                    f"KV page pool exhausted: slot {slot} is the only "
                    f"active sequence and already holds all "
                    f"{allocator.usable} usable pages; raise "
                    f"ServeConfig.{knob} (or lower cache_len)")
            self._preempt(victim)

    # -- fault injection and the recovery ladder ----------------------------
    def _draw_faults(self):
        """Query the plan once for this step: kv_corrupt writes its NaN
        page now, alloc_fail arms the sticky deny; returns the
        nan_logits slots and the stall for the step to apply."""
        nan_slots: List[int] = []
        stall = 0.0
        if self.fault_plan is None:
            return nan_slots, stall
        active = [int(s) for s in np.nonzero(self._active_h)[0]]
        for kind, slot in self.fault_plan.faults_for(self.step_count,
                                                     active):
            if self.telemetry is not None:
                self.telemetry.on_fault_injected(
                    self.step_count, kind,
                    int(slot) if slot is not None else None)
            if kind == "alloc_fail":
                self._alloc_deny = True
            elif kind == "stall":
                stall = max(stall, self.fault_plan.stall_s)
            elif kind == "nan_logits":
                nan_slots.append(int(slot))
            elif kind == "kv_corrupt":
                # the slot's first page: inside its read prefix, since an
                # active slot holds position 0 there
                corrupt_page(self.caches, int(self.block_tables[slot, 0]))
        return nan_slots, stall

    def _inject_nan(self, logits: torch.Tensor,
                    nan_slots: List[int]) -> torch.Tensor:
        """nan_logits: NaN over the target slots' logits rows, before
        the sentinel, as a compute fault would leave them.  The all-false
        mask stays on the device; a step that injects uploads its own."""
        mask = self._nan_none
        targets = [s for s in nan_slots if self._active_h[s]]
        if targets:
            m = np.zeros((self.sc.slots,), bool)
            m[targets] = True
            mask = self._upload(m)
        shape = (-1,) + (1,) * (logits.dim() - 1)
        return torch.where(mask.view(shape), float("nan"), logits)

    def _watchdog_tripped(self, t0: float) -> bool:
        """The deadline check around one dispatch and its copy.  On a
        trip the step's results are dropped (nothing was committed) and
        every active slot goes down the ladder; the step's in-place
        writes belong to those slots, whose re-admission rewrites them."""
        # armed after the first step: its dispatch builds the kernels
        if self.watchdog_s is None or self.step_count == 1:
            return False
        if time.perf_counter() - t0 <= self.watchdog_s:
            return False
        self.metrics.counter("serve.watchdog_trips").inc()
        self.last_watchdog_trip = {"step": self.step_count,
                                   "wall_time_s": time.time()}
        if self.telemetry is not None:
            self.telemetry.on_watchdog_trip(self.step_count)
        for slot in np.nonzero(self._active_h)[0]:
            self._fault_requeue(int(slot), "stall")
        return True

    def _handle_bad_slot(self, slot: int) -> None:
        """The sentinel flagged ``slot``: scan its live pages (one copy,
        on the fault path only), quarantine the corrupted ones, which
        tells kv_corrupt from nan_logits, and requeue the request."""
        kind = "nan_logits"
        corrupt = []
        if self.paged:
            live = [int(p) for p in self.block_tables[slot]
                    if int(p) != paging.NULL_PAGE]
            corrupt = nonfinite_pages(self.caches, live, _device_get)
        if corrupt:
            kind = "kv_corrupt"
            # out of the allocated set, and out of the row before
            # _release reclaims it
            self.allocator.quarantine(corrupt)
            row = self.block_tables[slot]
            row[np.isin(row, corrupt)] = paging.NULL_PAGE
            self._bt_dirty = True
        self._fault_requeue(slot, kind)

    def _fault_requeue(self, slot: int, kind: str) -> None:
        """One rung down the ladder: park the slot as a preemption does,
        spend one retry, stamp the backoff and checkpoint the request
        onto the requeue deque; past the budget, or when the quarantined
        pool can no longer hold its checkpoint, it fails instead."""
        req = self.active[slot]
        self.active_mask[slot].fill_(False)
        req.retries += 1
        tel = self.telemetry
        if self.spec:
            req.spec_faults += 1
            if (req.spec_faults >= self.sc.spec_disable_after
                    and not req.spec_disabled):
                req.spec_disabled = True
                if tel is not None:
                    tel.on_spec_degraded(req, slot, self.step_count)
        eff = len(req.tokens) + len(req.out)
        if req.retries > self.sc.max_retries or (self.paged and (
                paging.pages_per_slot(min(eff + 1, self.sc.cache_len),
                                      self.page_size)
                > self.allocator.usable)):
            req.failed = True
            self.metrics.counter("serve.failed_requests").inc()
            if tel is not None:
                tel.on_fail(req, slot, self.step_count, kind)
            self._release(slot)
            return
        self.metrics.counter(f"serve.recoveries.{kind}").inc()
        self.last_recovery = {"step": self.step_count, "kind": kind,
                              "wall_time_s": time.time()}
        if tel is not None:
            tel.on_fault_requeue(req, slot, self.step_count, kind)
        req.not_before = (self.step_count
                          + self.sc.retry_backoff * 2 ** (req.retries - 1))
        self.requeue.append(req)
        self.metrics.gauge("serve.requeue_peak_depth").set_max(
            len(self.requeue))
        self._release(slot)

    def audit(self) -> List[str]:
        """paging.audit over the live scheduler state (dense: nothing)."""
        if not self.paged:
            return []
        probs = paging.audit(self.allocator, self.block_tables, self._len_h,
                             self._active_h, self.page_size)
        if self.windowed:
            probs += ["window: " + p for p in paging.audit(
                self.allocator_w, self.block_tables_w, self._len_h,
                self._active_h, self.page_size, window=self.window)]
        return probs

    def _table_dev(self):
        """The device block tables, re-uploaded only when they changed:
        the (B, T) table, or {"global", "window"} with a window group."""
        if self._bt_dirty:
            self._bt_dev = self._upload(self.block_tables)
            self._bt_dirty = False
        if not self.windowed:
            return self._bt_dev
        if self._btw_dirty:
            self._btw_dev = self._upload(self.block_tables_w)
            self._btw_dirty = False
        return {"global": self._bt_dev, "window": self._btw_dev}

    # -- main loop ---------------------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:
        """One decode step for all active slots; returns busy-ness.

        The step's results stay in locals until its one copy has come
        back inside the watchdog's deadline; a slot the sentinel flags
        commits nothing and goes down the recovery ladder instead."""
        self.step_count += 1
        self._admit()
        if not self._active_h.any():
            return False
        nan_slots, stall = self._draw_faults()
        if self.spec:
            return self._spec_step(nan_slots, stall)
        bt = None
        if self.paged:
            self._ensure_pages()
            if not self._active_h.any():   # alloc_fail took the last slot
                return True
            bt = self._table_dev()
        sc, active = self.sc, self.active_mask
        t0 = time.perf_counter()
        # writes this step's K/V rows (and recurrent state) in place
        logits = self.model.decode_step(self.params, self.caches,
                                        self.cur_tok, self.lengths,
                                        block_tables=bt)
        if self.fault_plan is not None:
            logits = self._inject_nan(logits, nan_slots)
        # the NaN/Inf sentinel: a flagged slot's token is garbage
        bad = active & ~torch.isfinite(logits).all(dim=-1)
        next_tok = sample(logits, sc.temperature, self.generator)
        adv = active.to(torch.int32)
        new_lengths = self.lengths + adv
        new_n_out = self.n_out + adv
        eos = -1 if sc.eos_id is None else sc.eos_id
        # finish: budget spent, EOS sampled, or no cache row left for the
        # next token (the final row at cache_len - 1 is usable); a
        # flagged slot never finishes here
        done = active & ~bad & ((new_n_out >= self.max_new)
                                | (next_tok == eos)
                                | (new_lengths + 1 > sc.cache_len))
        if stall:
            time.sleep(stall)                      # injected device stall
        # THE one device-to-host copy of the step, the sentinel's lane
        # beside the tokens and done
        nt, dn, bh = _device_get(torch.stack(
            [next_tok, done.to(torch.int32), bad.to(torch.int32)]))
        if self._watchdog_tripped(t0):
            return True            # discarded; the active slots requeued
        self.lengths, self.n_out, self.cur_tok = new_lengths, new_n_out, next_tok
        self.active_mask = active & ~done
        tel = self.telemetry
        emitted = n_bad = 0
        for slot in np.nonzero(self._active_h)[0]:
            slot = int(slot)
            if bh[slot]:
                n_bad += 1
                self._handle_bad_slot(slot)
                continue
            req = self.active[slot]
            req.out.append(int(nt[slot]))
            self._len_h[slot] += 1
            emitted += 1
            if tel is not None:
                tel.on_tokens(req, slot, self.step_count, 1)
            if dn[slot]:
                req.done = True
                if tel is not None:
                    tel.on_finish(req, slot, self.step_count)
                self._release(slot)
        if tel is not None:
            tel.on_step(self.step_count, emitted=emitted, bad_slots=n_bad,
                        pools=self._pool_brief() if self.paged else None)
        return True

    def _pool_brief(self) -> Dict[str, Dict[str, int]]:
        """Pages in use and quarantined per pool group (host state)."""
        groups = {"global": self.allocator.brief()}
        if self.windowed:
            groups["window"] = self.allocator_w.brief()
        return groups

    def _propose(self, hist: torch.Tensor) -> torch.Tensor:
        """N-gram prompt lookup (``repro`` engine.py:507): draft the
        spec_k tokens that followed the latest earlier occurrence of
        ``cur_tok`` in the slot's history, preferring occurrences whose
        predecessor also matches (bigram over unigram, latest breaks
        ties); none found -> repeat ``cur_tok``.  ``hist`` already holds
        ``cur_tok`` at ``lengths``.  Device ops only."""
        w, k = self.sc.cache_len + 1, self.sc.spec_k
        cur, idx = self.cur_tok, self._hist_idx
        big = self.lengths[:, None]                # match below L only
        match = (idx < big) & (hist == cur[:, None])
        prev = torch.cat([torch.zeros_like(hist[:, :1]), hist[:, :-1]], 1)
        ctx = hist.gather(1, (big - 1).clamp(min=0).long())
        bigram = (idx >= 1) & (big >= 1) & (prev == ctx)
        score = torch.where(match, 1 + bigram.to(torch.int32),
                            torch.zeros_like(hist))
        rank = torch.where(score > 0, score * w + idx,
                           torch.full_like(hist, -1))
        j = rank.argmax(dim=1).to(torch.int32)
        found = rank.amax(dim=1) >= 0
        di = j[:, None] + 1 + self._win_idx[:, :k]
        d = hist.gather(1, di.clamp(max=w - 1).long())
        return torch.where(found[:, None] & (di <= big), d, cur[:, None])

    def _spec_step(self, nan_slots: List[int], stall: float) -> bool:
        """One speculative verify step for all active slots: ensure the
        window's pages, write ``cur_tok`` into the history, draft,
        verify the K1 window in one model call, accept the longest
        prefix that agrees with the argmax chain, then commit and roll
        the rejected tail's pages back (``repro`` engine.py:1300).  One
        device-to-host copy, of (tokens, accepted count, done, bad).
        After every step in_use == sum over active slots of
        pages_per_slot(length).  The plain step's sentinel, watchdog and
        ladder apply; a flagged slot skips commit and rollback, and its
        release reclaims the whole ensured row."""
        sc = self.sc
        k1 = sc.spec_k + 1
        self._ensure_pages(horizon=k1)
        if not self._active_h.any():       # alloc_fail took the last slot
            return True
        bt = self._table_dev()
        if self._spec_ok_dirty:
            self._spec_ok_dev = self._upload(self._spec_ok_h)
            self._spec_ok_dirty = False
        t0 = time.perf_counter()
        active, lengths, rows = self.active_mask, self.lengths, self._rows
        hist = self.tok_hist
        # commit cur_tok at its cache position L before proposing, so
        # drafts that read up to L see it (in place, like the K/V rows
        # the model call writes: a discarded or flagged step's rows
        # belong to slots that requeue, whose re-admission rewrites them)
        p0 = lengths.clamp(max=sc.cache_len).long()
        hist[rows, p0] = torch.where(active, self.cur_tok, hist[rows, p0])
        window = torch.cat([self.cur_tok[:, None], self._propose(hist)], 1)
        # draft positions L+1..L+k: accepted ones hold committed tokens;
        # rejected ones sit past the new length, where the proposer
        # never reads
        pt = (lengths[:, None] + self._win_idx[:, 1:]).clamp(
            max=sc.cache_len).long()
        hist[rows[:, None], pt] = torch.where(active[:, None], window[:, 1:],
                                              hist[rows[:, None], pt])
        logits = self.model.spec_decode_step(self.params, self.caches,
                                             window, lengths, bt)
        if self.fault_plan is not None:
            logits = self._inject_nan(logits, nan_slots)
        # the sentinel over the whole verify window
        bad = active & ~torch.isfinite(logits).all(dim=2).all(dim=1)
        y = torch.argmax(logits, dim=-1).to(torch.int32)      # (B, K1)
        # accept-longest-prefix: row t is emitted iff every earlier row
        # was, did not finish, and its draft equals the argmax chain;
        # spec_ok off (a degraded request) accepts row 0 only, the plain
        # step's token
        t_idx = self._win_idx
        eos = -1 if sc.eos_id is None else sc.eos_id
        done_t = active[:, None] & (
            (self.n_out[:, None] + t_idx + 1 >= self.max_new[:, None])
            | (y == eos) | (lengths[:, None] + t_idx + 2 > sc.cache_len))
        cont = ((window[:, 1:] == y[:, :-1]) & ~done_t[:, :-1]
                & self._spec_ok_dev[:, None])
        prefix = torch.cat(
            [active[:, None],
             active[:, None] & torch.cumprod(cont.to(torch.int32), 1).bool()],
            1)
        n_emit = prefix.sum(dim=1, dtype=torch.int32)
        done = (prefix & done_t).any(dim=1) & ~bad
        last = y.gather(1, (n_emit - 1).clamp(min=0).long()[:, None])[:, 0]
        if stall:
            time.sleep(stall)                      # injected device stall
        # THE one device-to-host copy of the step
        out = _device_get(torch.cat(
            [y, n_emit[:, None], done[:, None].to(torch.int32),
             bad[:, None].to(torch.int32)], 1))
        if self._watchdog_tripped(t0):
            return True            # discarded; the active slots requeued
        self.lengths = lengths + n_emit
        self.n_out = self.n_out + n_emit
        self.cur_tok = torch.where(active, last, self.cur_tok)
        self.active_mask = active & ~done
        self.metrics.counter("serve.spec_steps").inc()
        tel = self.telemetry
        accepted = n_bad = 0
        for slot in np.nonzero(self._active_h)[0]:
            slot = int(slot)
            if out[slot, k1 + 2]:
                n_bad += 1
                self._handle_bad_slot(slot)   # release reclaims the row
                continue
            req, m = self.active[slot], int(out[slot, k1])
            req.out.extend(int(t) for t in out[slot, :m])
            self._len_h[slot] += m
            self.metrics.counter("serve.spec_emitted").inc(m)
            accepted += m
            if tel is not None and m > 0:
                tel.on_tokens(req, slot, self.step_count, m)
            if out[slot, k1 + 1]:
                req.done = True
                if tel is not None:
                    tel.on_finish(req, slot, self.step_count)
                self._release(slot)        # reclaims the whole row
                continue
            if m < k1:
                self.metrics.counter("serve.spec_rejections").inc()
            # rollback: free the rejected tail's pages; rejected rows in
            # kept pages sit past the new length, masked by every read
            keep = paging.pages_per_slot(int(self._len_h[slot]),
                                         self.page_size)
            if paging.truncate_suffix(self.allocator,
                                      self.block_tables[slot], keep,
                                      int(self._ensured[slot])):
                self._bt_dirty = True
        if tel is not None:
            # the accepted counts rode the step's one copy
            tel.on_step(self.step_count, emitted=accepted, bad_slots=n_bad,
                        accepted=accepted, pools=self._pool_brief())
        return True

    def run_to_completion(self, requests: List[Request],
                          max_steps: int = 10_000) -> List[Request]:
        for r in requests:
            self.submit(r)
        for _ in range(max_steps):
            if not self.step() and not self.queue and not self.requeue:
                break
        return requests

    def stats(self) -> Dict[str, Any]:
        """Scheduler, allocator and recovery counters (host-side; no
        device sync)."""
        m = self.metrics
        d = {"preemptions": self.preemptions,
             "preemptions_by_policy": {
                 p: m.counter(f"serve.preemptions.{p}").value
                 for p in PREEMPT_POLICIES},
             "requeued_waiting": len(self.requeue),
             "requeue_depth": len(self.requeue),
             "requeue_peak_depth": int(
                 m.gauge("serve.requeue_peak_depth").value),
             "queued_waiting": len(self.queue),
             "steps": self.step_count,
             "recoveries": self.recoveries,
             "recoveries_total": sum(self.recoveries.values()),
             "failed_requests": self.failed_requests,
             "watchdog_trips": self.watchdog_trips,
             "last_watchdog_trip": self.last_watchdog_trip,
             "last_recovery": self.last_recovery}
        if self.fault_plan is not None:
            d["faults_injected"] = dict(self.fault_plan.injected)
        if self.paged:
            # top-level pressure keys stay the global group's
            d.update(self.allocator.pressure())
            d["kv_dtype"] = (self.kv_spec.dtype if self.kv_spec is not None
                             else None)
            d["pool_groups"] = {"global": self.allocator.pressure()}
            if self.windowed:
                d["pool_groups"]["window"] = self.allocator_w.pressure()
                d["window_prefix_frees"] = self.window_prefix_frees
        if self.spec:
            d.update({"spec_steps": self.spec_steps,
                      "spec_emitted": self.spec_emitted,
                      "spec_rejections": self.spec_rejections})
        return d
