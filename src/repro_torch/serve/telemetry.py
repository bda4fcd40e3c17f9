"""Serve-plane telemetry (``repro.serve.telemetry`` ported): the glue
between the engine's lifecycle hooks, the bounded
:class:`~repro_torch.obs.trace.Trace` ring, and a
:class:`~repro_torch.obs.metrics.MetricsRegistry` of latency histograms.

A :class:`ServeTelemetry` is optional and attachable
(``Engine(..., telemetry=...)`` or ``eng.telemetry = ...`` between
runs): without one the engine pays one ``is None`` check per hook site.
Every hook runs on the host after the step's one device-to-host copy
(``engine._device_get``) and reads only host state the engine already
holds, so it adds no copy, no sync and no launch.

Per-request derived latencies:

* ``ttft_s``          submitted -> first generated token
* ``queue_wait_s``    submitted -> first admission (prefill)
* ``itl_s``           inter-token gaps; a step that commits ``n``
                      tokens (speculation) contributes ``n`` samples of
                      ``gap / n``
* ``preempt_stall_s`` total time parked between preemption and
                      re-admission
* ``recovery_s``      total time parked between a fault requeue and
                      re-admission
* ``e2e_s``           submitted -> finished

Each is kept exactly (host floats, per request) and observed into the
registry's fixed-bucket histograms; the exact samples feed the summary
percentiles, the histograms merging and comparing.

SLO classes: every record carries the request's ``priority_class`` and
``traffic_class``; :meth:`samples` filters by class label and
:meth:`summary_by_class` reports the same percentile block per class.

``clock`` is injectable: two telemetries given the same counting fake
clock record identical traces for identical decisions.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Trace

__all__ = ["ServeTelemetry", "LATENCY_METRICS"]

LATENCY_METRICS = ("ttft_s", "queue_wait_s", "itl_s", "preempt_stall_s",
                   "recovery_s", "e2e_s")


def _percentiles(samples: List[float], qs=(50, 99)) -> Optional[Dict[str, float]]:
    if not samples:
        return None
    arr = np.asarray(samples, dtype=np.float64)
    out = {f"p{q}": float(np.percentile(arr, q)) for q in qs}
    out["count"] = len(samples)
    out["mean"] = float(arr.mean())
    return out


class ServeTelemetry:
    """Lifecycle trace + latency metrics for one engine run."""

    def __init__(self, *, registry: Optional[MetricsRegistry] = None,
                 trace: Optional[Trace] = None,
                 trace_capacity: int = 65536,
                 clock: Callable[[], float] = time.perf_counter):
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = trace if trace is not None else Trace(
            capacity=trace_capacity, clock=clock)
        self.clock = clock
        # rid -> lifecycle record; kept after finish for summaries
        self.requests: Dict[int, Dict[str, Any]] = {}
        # Pre-resolved metric objects for the per-token / per-step hot
        # path: a registry lookup is a dict probe plus an f-string
        self._h_itl = self._hist("itl_s")
        self._c_steps = self.registry.counter("serve.steps")
        self._c_emitted = self.registry.counter("serve.emitted_tokens")
        self._c_accepted = self.registry.counter(
            "serve.accepted_spec_tokens")
        self._gauges: Dict[str, Any] = {}

    # ------------------------------------------------------- helpers ----

    def _rec(self, rid: int) -> Dict[str, Any]:
        rec = self.requests.get(rid)
        if rec is None:
            rec = {"rid": rid, "status": "queued",
                   "priority_class": 0, "traffic_class": None,
                   "submitted_ts": None, "admitted_ts": None,
                   "first_token_ts": None, "last_token_ts": None,
                   "finished_ts": None, "tokens": 0,
                   "ttft_s": None, "queue_wait_s": None, "e2e_s": None,
                   "itl_s": [], "preempt_stall_s": 0.0, "recovery_s": 0.0,
                   "preempts": 0, "fault_requeues": 0,
                   "_parked": None}  # (ts, "preempt" | "fault")
            self.requests[rid] = rec
        return rec

    @staticmethod
    def _class_label(rec: Dict[str, Any]) -> str:
        """Reporting label: the workload name when the trace stamped
        one, else the numeric priority class."""
        tc = rec.get("traffic_class")
        return tc if tc else str(rec.get("priority_class", 0))

    def _hist(self, name: str):
        # latency histograms: 10µs .. 1000s at ~25% relative resolution
        return self.registry.histogram(f"serve.{name}", lo=1e-5, hi=1e3)

    # ------------------------------------------------ lifecycle hooks ----

    def on_submit(self, req, step: int) -> None:
        rec = self._rec(req.rid)
        rec["submitted_ts"] = self.clock()
        rec["priority_class"] = getattr(req, "priority_class", 0)
        rec["traffic_class"] = getattr(req, "traffic_class", None)
        self.trace.record("submitted", rid=req.rid, step=step,
                          priority=rec["priority_class"])
        self.registry.counter("serve.submitted").inc()

    def on_admit(self, req, slot: int, step: int) -> None:
        ts = self.clock()
        self.trace.record("admitted", rid=req.rid, slot=slot, step=step)
        rec = self._rec(req.rid)
        rec["status"] = "active"
        if rec["admitted_ts"] is None:
            rec["admitted_ts"] = ts
            if rec["submitted_ts"] is not None:
                qw = ts - rec["submitted_ts"]
                rec["queue_wait_s"] = qw
                self._hist("queue_wait_s").observe(qw)
        elif rec["_parked"] is not None:
            parked_ts, why = rec["_parked"]
            gap = ts - parked_ts
            if why == "preempt":
                rec["preempt_stall_s"] += gap
                self._hist("preempt_stall_s").observe(gap)
            else:
                rec["recovery_s"] += gap
                self._hist("fault_recovery_s").observe(gap)
            rec["_parked"] = None

    def on_first_token(self, req, slot: int, step: int) -> None:
        ts = self.clock()
        self.trace.record("first_token", rid=req.rid, slot=slot, step=step)
        rec = self._rec(req.rid)
        rec["first_token_ts"] = ts
        if rec["submitted_ts"] is not None:
            ttft = ts - rec["submitted_ts"]
            rec["ttft_s"] = ttft
            self._hist("ttft_s").observe(ttft)

    def on_tokens(self, req, slot: int, step: int, n: int) -> None:
        # hottest hook (once per committed token): reuse the trace
        # event's timestamp instead of reading the clock twice
        ts = self.trace.record("tokens", rid=req.rid, slot=slot,
                               step=step, n=n).ts
        rec = self._rec(req.rid)
        rec["tokens"] += n
        if rec["last_token_ts"] is not None and n > 0:
            itl = (ts - rec["last_token_ts"]) / n
            rec["itl_s"].extend([itl] * n)
            h = self._h_itl
            for _ in range(n):
                h.observe(itl)
        rec["last_token_ts"] = ts

    def on_preempt(self, req, slot: int, step: int) -> None:
        self.trace.record("preempted", rid=req.rid, slot=slot, step=step)
        rec = self._rec(req.rid)
        rec["status"] = "preempted"
        rec["preempts"] += 1
        rec["_parked"] = (self.clock(), "preempt")

    def on_fault_injected(self, step: int, kind: str,
                          slot: Optional[int]) -> None:
        self.trace.record("fault", slot=slot, step=step, fault=kind)

    def on_fault_requeue(self, req, slot: Optional[int], step: int,
                         kind: str) -> None:
        self.trace.record("requeued", rid=req.rid, slot=slot, step=step,
                          fault=kind)
        rec = self._rec(req.rid)
        rec["status"] = "requeued"
        rec["fault_requeues"] += 1
        rec["_parked"] = (self.clock(), "fault")

    def on_spec_degraded(self, req, slot: Optional[int], step: int) -> None:
        self.trace.record("spec_degraded", rid=req.rid, slot=slot, step=step)
        self.registry.counter("serve.spec_degraded").inc()

    def on_finish(self, req, slot: int, step: int) -> None:
        ts = self.clock()
        self.trace.record("finished", rid=req.rid, slot=slot, step=step)
        rec = self._rec(req.rid)
        rec["status"] = "finished"
        rec["finished_ts"] = ts
        if rec["submitted_ts"] is not None:
            e2e = ts - rec["submitted_ts"]
            rec["e2e_s"] = e2e
            self._hist("e2e_s").observe(e2e)
        self.registry.counter("serve.finished").inc()

    def on_fail(self, req, slot: Optional[int], step: int,
                kind: str) -> None:
        self.trace.record("failed", rid=req.rid, slot=slot, step=step,
                          fault=kind)
        rec = self._rec(req.rid)
        rec["status"] = "failed"
        rec["finished_ts"] = self.clock()
        self.registry.counter("serve.failed").inc()

    def on_watchdog_trip(self, step: int) -> None:
        self.trace.record("watchdog_trip", step=step)
        self.registry.counter("serve.watchdog_trips").inc()

    def on_step(self, step: int, *, emitted: int, bad_slots: int = 0,
                accepted: Optional[int] = None,
                pools: Optional[Dict[str, Dict[str, int]]] = None) -> None:
        """Per-step sample.  ``emitted``/``accepted`` come from the
        host mirrors the step's one copy filled; ``pools`` is host
        allocator state: no extra syncs."""
        meta: Dict[str, Any] = {"emitted": emitted}
        if bad_slots:
            meta["bad_slots"] = bad_slots
        if accepted is not None:
            meta["accepted"] = accepted
        if pools:
            meta["pools"] = pools
        self.trace.record("step", step=step, **meta)
        self._c_steps.inc()
        self._c_emitted.inc(int(emitted))
        if accepted is not None:
            self._c_accepted.inc(int(accepted))
        if pools:
            for group, p in pools.items():
                for key in ("in_use", "quarantined"):
                    if key in p:
                        name = f"serve.pages.{group}.{key}"
                        g = self._gauges.get(name)
                        if g is None:
                            g = self._gauges[name] = self.registry.gauge(name)
                        g.set(p[key])

    # ----------------------------------------------------- summaries ----

    def request_metrics(self) -> List[Dict[str, Any]]:
        """One row per request: exact derived latencies (None where the
        lifecycle never reached that point)."""
        rows = []
        for rid in sorted(self.requests):
            rec = self.requests[rid]
            itl = rec["itl_s"]
            rows.append({
                "rid": rid, "status": rec["status"],
                "priority_class": rec["priority_class"],
                "traffic_class": rec["traffic_class"],
                "tokens": rec["tokens"],
                "ttft_s": rec["ttft_s"],
                "queue_wait_s": rec["queue_wait_s"],
                "itl_p50_s": (float(np.percentile(itl, 50)) if itl else None),
                "itl_mean_s": (sum(itl) / len(itl) if itl else None),
                "e2e_s": rec["e2e_s"],
                "preempt_stall_s": rec["preempt_stall_s"],
                "recovery_s": rec["recovery_s"],
                "preempts": rec["preempts"],
                "fault_requeues": rec["fault_requeues"],
            })
        return rows

    def samples(self, metric: str,
                cls: Optional[str] = None) -> List[float]:
        """All per-request samples for one of LATENCY_METRICS;
        ``cls`` restricts to one class label (see _class_label)."""
        if metric not in LATENCY_METRICS:
            raise ValueError(f"unknown latency metric {metric!r}; "
                             f"valid: {LATENCY_METRICS}")
        out: List[float] = []
        for rec in self.requests.values():
            if cls is not None and self._class_label(rec) != cls:
                continue
            v = rec[metric]
            if metric == "itl_s":
                out.extend(v)
            elif metric in ("preempt_stall_s", "recovery_s"):
                if rec["preempts" if metric == "preempt_stall_s"
                       else "fault_requeues"]:
                    out.append(v)
            elif v is not None:
                out.append(v)
        return out

    def summary(self, qs=(50, 99)) -> Dict[str, Any]:
        """Cross-request percentile summary (numpy-exact, from the
        per-request sample lists — the histograms are the bucketed
        twin for merging)."""
        out: Dict[str, Any] = {"requests": len(self.requests)}
        for m in LATENCY_METRICS:
            out[m] = _percentiles(self.samples(m), qs)
        return out

    def class_labels(self) -> List[str]:
        """Distinct class labels seen, highest priority first (the
        order the SLO report prints)."""
        by_label: Dict[str, int] = {}
        for rec in self.requests.values():
            lbl = self._class_label(rec)
            pc = int(rec.get("priority_class", 0))
            by_label[lbl] = max(by_label.get(lbl, pc), pc)
        return sorted(by_label, key=lambda l: (-by_label[l], l))

    def summary_by_class(self, qs=(50, 99)) -> Dict[str, Any]:
        """The :meth:`summary` percentile block computed per class
        label (the per-priority-class SLO report): TTFT / ITL /
        queue-wait percentiles for each traffic class, plus its request
        count, completion rate, priority, and preemption total."""
        out: Dict[str, Any] = {}
        for lbl in self.class_labels():
            recs = [r for r in self.requests.values()
                    if self._class_label(r) == lbl]
            blk: Dict[str, Any] = {
                "requests": len(recs),
                "priority_class": max(
                    int(r.get("priority_class", 0)) for r in recs),
                "completed": sum(1 for r in recs
                                 if r["status"] == "finished"),
                "preempts": sum(r["preempts"] for r in recs),
            }
            blk["completion_rate"] = (blk["completed"] / blk["requests"]
                                      if blk["requests"] else None)
            for m in LATENCY_METRICS:
                blk[m] = _percentiles(self.samples(m, cls=lbl), qs)
            out[lbl] = blk
        return out
