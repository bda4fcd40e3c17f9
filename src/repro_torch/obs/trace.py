"""Bounded ring-buffer event log of per-request lifecycles, exportable
as Chrome trace-event JSON (open in Perfetto: ui.perfetto.dev -> "Open
trace file", or chrome://tracing); ``repro.obs.trace`` ported.

The trace is the raw record: every lifecycle transition the serve
engine makes (submitted -> admitted -> first_token -> preempted /
requeued -> spec_degraded -> finished / failed) plus a per-step
engine and allocator sample, stamped with ``time.perf_counter`` on the
host commit path, after the step's one device-to-host copy.  Derived
latencies (TTFT, ITL, queue wait, ...) live in
:mod:`repro_torch.serve.telemetry`, which feeds a
:class:`~repro_torch.obs.metrics.MetricsRegistry` as it records here.

The buffer is a ``collections.deque(maxlen=capacity)``: recording is
O(1), memory is bounded, and when the ring wraps the oldest events drop
first (``dropped`` counts them, and ``validate()`` skips the lifecycle
checks of requests whose head fell off the ring).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["EVENT_KINDS", "TraceEvent", "Trace"]

# Lifecycle kinds carry a rid; "step"/"watchdog_trip" are engine-scoped.
EVENT_KINDS = (
    "submitted",      # request entered the admission queue
    "admitted",       # prefilled into a slot (fresh or re-admission)
    "first_token",    # first generated token (sampled at prefill)
    "tokens",         # n tokens committed for a slot this step
    "preempted",      # victim-selected out of its slot, checkpointed
    "requeued",       # fault recovery requeued the request (meta: fault)
    "fault",          # a fault-plan injection resolved (meta: kind)
    "spec_degraded",  # speculation disabled for this request
    "finished",       # request completed
    "failed",         # request exhausted retries
    "watchdog_trip",  # host watchdog declared the step stuck
    "step",           # per-step engine sample (meta: emitted, pools, …)
)

_REQUEST_KINDS = frozenset(EVENT_KINDS) - {"step", "watchdog_trip", "fault"}
_KIND_SET = frozenset(EVENT_KINDS)  # O(1) membership on the record path


@dataclasses.dataclass(slots=True)
class TraceEvent:
    # slots=True: events are allocated on every lifecycle transition
    # and every step; no per-instance __dict__ keeps the record path
    # cheap
    ts: float                      # monotonic seconds (time.perf_counter)
    kind: str
    rid: Optional[int] = None
    slot: Optional[int] = None
    step: Optional[int] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


class Trace:
    """Bounded event ring with Chrome-trace export and schema checks."""

    def __init__(self, capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        if capacity < 1:
            raise ValueError(f"trace capacity must be >= 1, got {capacity}")
        self.events: "collections.deque[TraceEvent]" = \
            collections.deque(maxlen=capacity)
        self.dropped = 0
        self.clock = clock

    def record(self, kind: str, *, rid: Optional[int] = None,
               slot: Optional[int] = None, step: Optional[int] = None,
               **meta: Any) -> TraceEvent:
        if kind not in _KIND_SET:
            raise ValueError(f"unknown trace event kind {kind!r}; "
                             f"valid: {EVENT_KINDS}")
        if len(self.events) == self.events.maxlen:
            self.dropped += 1
        ev = TraceEvent(self.clock(), kind, rid, slot, step, meta)
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def lifecycle(self, rid: int) -> List[TraceEvent]:
        return [e for e in self.events if e.rid == rid]

    # ---------------------------------------------------- validation ----

    def validate(self) -> List[str]:
        """Schema + lifecycle-ordering checks; returns problem strings
        (empty == well-formed)."""
        problems: List[str] = []
        prev_ts = None
        by_rid: Dict[int, List[TraceEvent]] = {}
        for i, e in enumerate(self.events):
            if not isinstance(e.ts, float):
                problems.append(f"event {i}: non-float ts {e.ts!r}")
            if prev_ts is not None and e.ts < prev_ts:
                problems.append(f"event {i} ({e.kind}): ts went backwards "
                                f"({e.ts} < {prev_ts})")
            prev_ts = e.ts
            if e.kind in _REQUEST_KINDS and e.rid is None:
                problems.append(f"event {i}: {e.kind} without rid")
            if e.kind in ("admitted", "first_token", "tokens", "preempted",
                          "finished") and e.slot is None:
                problems.append(f"event {i}: {e.kind} without slot")
            if e.step is None and e.kind != "submitted":
                problems.append(f"event {i}: {e.kind} without step")
            if e.rid is not None:
                by_rid.setdefault(e.rid, []).append(e)

        for rid, evs in sorted(by_rid.items()):
            kinds = [e.kind for e in evs]
            if "submitted" not in kinds:
                # Head of this lifecycle fell off the ring; ordering
                # checks below would be vacuous — skip them.
                if self.dropped == 0:
                    problems.append(f"rid {rid}: no 'submitted' event "
                                    f"and nothing was dropped")
                continue
            if kinds.count("submitted") != 1:
                problems.append(f"rid {rid}: {kinds.count('submitted')} "
                                f"'submitted' events")
            terminal = [k for k in kinds if k in ("finished", "failed")]
            if len(terminal) > 1:
                problems.append(f"rid {rid}: multiple terminal events "
                                f"{terminal}")
            if terminal and kinds[-1] not in ("finished", "failed"):
                problems.append(f"rid {rid}: events after terminal "
                                f"{terminal[0]!r}: {kinds}")
            if terminal:
                if "admitted" not in kinds:
                    problems.append(f"rid {rid}: terminal without "
                                    f"'admitted'")
                elif kinds.index("admitted") < kinds.index("submitted"):
                    problems.append(f"rid {rid}: admitted before submitted")
                if terminal[0] == "finished" and "first_token" not in kinds:
                    problems.append(f"rid {rid}: finished without "
                                    f"'first_token'")
                if ("first_token" in kinds and
                        kinds.index("first_token") < kinds.index("admitted")):
                    problems.append(f"rid {rid}: first_token before "
                                    f"admitted")
                # every eviction must be followed by a re-admission
                # before the terminal event (failed requests exempt)
                if terminal[0] == "finished":
                    for j, k in enumerate(kinds):
                        if k in ("preempted", "requeued"):
                            if "admitted" not in kinds[j + 1:]:
                                problems.append(
                                    f"rid {rid}: {k} at index {j} never "
                                    f"re-admitted before finish")
        return problems

    # -------------------------------------------------------- export ----

    def export(self, path: str) -> Dict[str, Any]:
        """Write Chrome trace-event JSON: one track (tid) per slot,
        plus engine and allocator tracks.  Lifecycle transitions are
        instant events on the owning slot's track; slot residency
        (admitted → released) renders as duration ("X") spans; per-step
        pool pressure renders as counter ("C") series.  Returns the
        document (also written to ``path``)."""
        ENGINE_TID = 10_000
        ALLOC_TID = 10_001
        evs = list(self.events)
        t0 = evs[0].ts if evs else 0.0
        us = lambda ts: round((ts - t0) * 1e6, 3)

        out: List[Dict[str, Any]] = [
            {"ph": "M", "pid": 0, "tid": 0, "name": "process_name",
             "args": {"name": "repro-serve"}},
            {"ph": "M", "pid": 0, "tid": ENGINE_TID, "name": "thread_name",
             "args": {"name": "engine"}},
            {"ph": "M", "pid": 0, "tid": ALLOC_TID, "name": "thread_name",
             "args": {"name": "allocator"}},
        ]
        slots = sorted({e.slot for e in evs if e.slot is not None})
        for s in slots:
            out.append({"ph": "M", "pid": 0, "tid": s,
                        "name": "thread_name",
                        "args": {"name": f"slot {s}"}})

        # residency spans: admitted → next preempted/requeued/finished/
        # failed for the same rid
        open_span: Dict[int, TraceEvent] = {}
        for e in evs:
            if e.kind == "admitted":
                open_span[e.rid] = e
            elif e.kind in ("preempted", "requeued", "finished", "failed"):
                start = open_span.pop(e.rid, None)
                if start is not None and start.slot is not None:
                    out.append({"ph": "X", "pid": 0, "tid": start.slot,
                                "name": f"rid {e.rid}",
                                "ts": us(start.ts),
                                "dur": max(us(e.ts) - us(start.ts), 0.001),
                                "args": {"rid": e.rid, "end": e.kind}})
        for rid, start in open_span.items():  # still resident at export
            if start.slot is not None and evs:
                out.append({"ph": "X", "pid": 0, "tid": start.slot,
                            "name": f"rid {rid}",
                            "ts": us(start.ts),
                            "dur": max(us(evs[-1].ts) - us(start.ts), 0.001),
                            "args": {"rid": rid, "end": "open"}})

        for e in evs:
            if e.kind == "step":
                pools = e.meta.get("pools") or {}
                for group, p in pools.items():
                    out.append({"ph": "C", "pid": 0, "tid": ALLOC_TID,
                                "name": f"pages.{group}", "ts": us(e.ts),
                                "args": {k: v for k, v in p.items()}})
                out.append({"ph": "C", "pid": 0, "tid": ENGINE_TID,
                            "name": "emitted_tokens", "ts": us(e.ts),
                            "args": {"tokens": e.meta.get("emitted", 0)}})
                continue
            tid = e.slot if e.slot is not None else ENGINE_TID
            args: Dict[str, Any] = {"step": e.step}
            if e.rid is not None:
                args["rid"] = e.rid
            args.update(e.meta)
            out.append({"ph": "i", "pid": 0, "tid": tid, "s": "t",
                        "name": e.kind, "ts": us(e.ts), "args": args})

        doc = {"traceEvents": out, "displayTimeUnit": "ms",
               "otherData": {"dropped_events": self.dropped,
                             "recorded_events": len(evs)}}
        with open(path, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        return doc
