"""The port's observability plane (``repro_torch.obs`` and
``repro_torch.serve.telemetry``) against ``repro``'s, mirrored on
tests/test_obs.py: the metrics primitives against numpy and against the
reference's, the trace's schema, lifecycle checks and export, the
zero-extra-copy contract with telemetry attached (plain and
speculative), the derived latencies, the watchdog and recovery records,
and the ``REPRO_PROFILE`` hooks; then both engines' trace events and
summaries, under one counting fake clock, for the same requests: lru
and priority over an oversubscribed pool, and under fault plans for the
fault hooks.

The reference runs under ``target("generic")`` (ROADMAP.md queue C,
note 0); the port on the CPU, where every kernel wrapper takes its plain
version.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models.registry import build_model
from repro.obs.metrics import Histogram as JHistogram
from repro.obs.metrics import MetricsRegistry as JMetricsRegistry
from repro.obs.trace import Trace as JTrace
from repro.serve import Engine as JEngine
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeTelemetry as JServeTelemetry
from repro.serve import workload as jworkload
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.core.build import CudaKernel
from repro_torch.core.context import current_context, target
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.obs import profile
from repro_torch.obs.metrics import Histogram, MetricsRegistry
from repro_torch.obs.trace import EVENT_KINDS, Trace
from repro_torch.serve import engine as engine_mod
from repro_torch.serve import workload
from repro_torch.serve.engine import Engine, Request, ServeConfig
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.telemetry import LATENCY_METRICS, ServeTelemetry

import torch


@pytest.fixture(scope="module")
def models():
    """(jax model, jax params, port model, port params): granite smoke,
    one layer, float32."""
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=1),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(
        port_smoke_config("granite-8b", num_layers=1), dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (model, params, port_build_model(pcfg),
            from_jax_params(tree, pcfg, device="cpu"))


def _engine(models, telemetry=None, plan=None, **kw):
    _, _, pmodel, pparams = models
    base = dict(slots=2, cache_len=32, max_new_tokens=4, paged=True,
                page_size=4)
    base.update(kw)
    return Engine(pmodel, pparams, ServeConfig(**base), device="cpu",
                  fault_plan=plan, telemetry=telemetry)


def _reqs(n=4, cls=Request):
    return [cls(rid=i, tokens=[3 + i, 5, 7, 11][:3 + (i % 2)])
            for i in range(n)]


def _drive(eng, reqs, arm_watchdog_s=None, max_steps=500):
    """Submit and step to drain, auditing every step; ``arm_watchdog_s``
    arms the reference engine's watchdog after its first step, as its
    launcher does (the port's arms ServeConfig.watchdog_s itself)."""
    for r in reqs:
        eng.submit(r)
    for i in range(max_steps):
        busy = eng.step()
        if i == 0 and arm_watchdog_s is not None:
            eng.watchdog_s = arm_watchdog_s
        assert eng.audit() == [], eng.audit()
        if not busy and not eng.queue and not eng.requeue:
            return reqs
    raise AssertionError(f"engine did not drain: {eng.stats()}")


def _fake_clock():
    t = [0.0]

    def clock():
        t[0] += 0.001
        return t[0]

    return clock


# ------------------------------------------------------- histograms ----

def test_histogram_percentiles_within_bucket_factor():
    """Bucketed percentile estimates land within one geometric bucket
    factor of the exact numpy sample percentile, and equal the
    reference histogram's for the same samples."""
    rng = np.random.default_rng(0)
    samples = rng.lognormal(mean=-4.0, sigma=1.5, size=2000)
    h = Histogram("t", lo=1e-5, hi=1e3, factor=1.25)
    jh = JHistogram("t", lo=1e-5, hi=1e3, factor=1.25)
    for v in samples:
        h.observe(float(v))
        jh.observe(float(v))
    for q in (50, 90, 99):
        exact = float(np.percentile(samples, q))
        est = h.percentile(q)
        assert exact / h.factor <= est <= exact * h.factor, \
            (q, est, exact)
    assert h.bounds == jh.bounds and h.counts == jh.counts
    assert h.snapshot() == jh.snapshot()


def test_histogram_exact_moments_ride_alongside():
    h = Histogram("t", lo=1e-3, hi=1e2)
    vals = [0.5, 0.002, 7.0, 0.1]
    for v in vals:
        h.observe(v)
    assert h.count == len(vals)
    assert h.sum == pytest.approx(sum(vals))
    assert h.min == min(vals) and h.max == max(vals)
    assert h.mean == pytest.approx(sum(vals) / len(vals))


def test_histogram_underflow_overflow_return_tracked_extremes():
    h = Histogram("t", lo=1e-2, hi=1.0)
    h.observe(1e-6)   # underflow bucket
    h.observe(50.0)   # overflow bucket
    assert h.percentile(1) == 1e-6
    assert h.percentile(100) == 50.0
    assert sum(h.counts) == h.count == 2
    assert h.percentile(50) is not None
    assert Histogram("empty").percentile(50) is None
    with pytest.raises(ValueError, match="percentile q"):
        h.percentile(101)
    with pytest.raises(ValueError, match="need 0 < lo < hi"):
        Histogram("bad", lo=1.0, hi=0.5)


def test_registry_get_or_create_and_type_conflicts(tmp_path):
    reg = MetricsRegistry()
    c = reg.counter("serve.steps")
    assert reg.counter("serve.steps") is c
    c.inc(3)
    with pytest.raises(ValueError, match="monotonic"):
        c.inc(-1)
    g = reg.gauge("pool.pages")
    g.set_max(4.0)
    g.set_max(2.0)
    assert g.value == 4.0
    g.set(1.0)
    assert g.value == 1.0
    with pytest.raises(TypeError, match="already registered"):
        reg.histogram("serve.steps")
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("serve.steps")
    reg.histogram("lat").observe(0.01)
    assert reg.names() == ["lat", "pool.pages", "serve.steps"]
    # the same operations on the reference's registry export the same
    # document (the launcher's --metrics-out path)
    jreg = JMetricsRegistry()
    jreg.counter("serve.steps").inc(3)
    jreg.gauge("pool.pages").set_max(4.0)
    jreg.gauge("pool.pages").set(1.0)
    jreg.histogram("lat").observe(0.01)
    reg.export(str(tmp_path / "port.json"))
    jreg.export(str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    json.dumps(reg.snapshot())


# ------------------------------------------------------------ trace ----

def _record_lifecycle(tr, rid, slot=0):
    tr.record("submitted", rid=rid)
    tr.record("admitted", rid=rid, slot=slot, step=1)
    tr.record("first_token", rid=rid, slot=slot, step=1)
    tr.record("tokens", rid=rid, slot=slot, step=2, n=1)
    tr.record("finished", rid=rid, slot=slot, step=3)


def test_trace_valid_lifecycle_passes_validation():
    tr = Trace(capacity=64, clock=_fake_clock())
    _record_lifecycle(tr, rid=0)
    tr.record("step", step=3, emitted=1)
    assert tr.validate() == []
    assert [e.kind for e in tr.lifecycle(0)] == \
        ["submitted", "admitted", "first_token", "tokens", "finished"]
    assert "requeued" in EVENT_KINDS and "watchdog_trip" in EVENT_KINDS


def test_trace_rejects_unknown_kind():
    tr = Trace(capacity=4)
    with pytest.raises(ValueError, match="unknown trace event kind"):
        tr.record("teleported", rid=0)
    with pytest.raises(ValueError, match="capacity"):
        Trace(capacity=0)


def _violations(trace_cls):
    """Malformed lifecycles recorded into a ``trace_cls``; returns the
    problems each trace's validate() reports."""
    out = []
    tr = trace_cls(capacity=64, clock=_fake_clock())
    tr.record("submitted", rid=0)
    tr.record("admitted", rid=0, slot=0, step=1)
    tr.record("finished", rid=0, slot=0, step=2)        # no first_token
    out.append(tr.validate())
    tr = trace_cls(capacity=64, clock=_fake_clock())
    _record_lifecycle(tr, rid=1)
    tr.record("tokens", rid=1, slot=0, step=4, n=1)      # after terminal
    out.append(tr.validate())
    tr = trace_cls(capacity=64, clock=_fake_clock())
    tr.record("submitted", rid=2)
    tr.record("admitted", rid=2, slot=None, step=1)      # no slot
    tr.record("first_token", rid=2, slot=0, step=1)
    tr.record("preempted", rid=2, slot=0, step=2)        # never readmitted
    tr.record("finished", rid=2, slot=0, step=3)
    tr.record("tokens", rid=3, slot=1, step=3, n=1)      # no submitted
    tr.record("step")                                    # no step
    tr.record("failed", step=4)                          # no rid
    out.append(tr.validate())
    return out


def test_trace_validation_catches_lifecycle_violations():
    problems = _violations(Trace)
    assert any("without 'first_token'" in p for p in problems[0]), problems
    assert any("after terminal" in p for p in problems[1])
    assert len(problems[2]) >= 5, problems[2]
    # the reference's rules and messages, word for word
    assert problems == _violations(JTrace)


def test_trace_ring_is_bounded_and_counts_drops():
    tr = Trace(capacity=4, clock=_fake_clock())
    _record_lifecycle(tr, rid=0)  # 5 events into a 4-ring
    assert len(tr) == 4
    assert tr.dropped == 1
    # head fell off the ring: validate() must not flag the truncated
    # lifecycle as malformed
    assert tr.validate() == []


def test_trace_export_schema(tmp_path):
    docs = []
    for cls in (Trace, JTrace):
        tr = cls(capacity=64, clock=_fake_clock())
        _record_lifecycle(tr, rid=0)
        tr.record("admitted", rid=1, slot=1, step=2)     # still resident
        tr.record("step", step=3, emitted=1,
                  pools={"global": {"in_use": 2, "quarantined": 0}})
        p = tmp_path / f"{cls.__module__}.json"
        doc = tr.export(str(p))
        with open(p) as f:
            assert json.load(f) == doc
        docs.append(doc)
    doc = docs[0]
    evs = doc["traceEvents"]
    phases = {e["ph"] for e in evs}
    assert {"M", "i", "X", "C"} <= phases  # metadata, instants,
    # residency spans, counter series
    for e in evs:
        assert {"ph", "pid", "tid"} <= set(e)
        if e["ph"] != "M":
            assert "ts" in e
    spans = [e for e in evs if e["ph"] == "X"]
    assert spans and all(e["dur"] > 0 for e in spans)
    assert doc["otherData"]["recorded_events"] == 7
    assert docs[0] == docs[1]               # the reference's schema


# ---------------------------------------- zero-extra-copy regression ----

@pytest.mark.parametrize("spec_mode", ["off", "ngram"])
def test_telemetry_adds_no_device_syncs(models, monkeypatch, spec_mode):
    """The one-copy-per-step contract with telemetry attached: the same
    ``_device_get`` count and the same tokens as a bare engine, on the
    plain and the speculative step."""
    results = {}
    for with_tel in (False, True):
        calls = [0]
        real = engine_mod._device_get

        def counting(x, _real=real, _calls=calls):
            _calls[0] += 1
            return _real(x)

        monkeypatch.setattr(engine_mod, "_device_get", counting)
        tel = ServeTelemetry() if with_tel else None
        eng = _engine(models, telemetry=tel, spec_mode=spec_mode, spec_k=3)
        reqs = _drive(eng, _reqs())
        monkeypatch.setattr(engine_mod, "_device_get", real)
        assert all(r.done for r in reqs)
        results[with_tel] = (calls[0], [r.out for r in reqs])
        if tel is not None:
            assert tel.trace.validate() == []
    assert results[True][0] == results[False][0], \
        f"telemetry changed the device_get count: {results}"
    assert results[True][1] == results[False][1]


# ------------------------------------------- derived latency metrics ----

def test_telemetry_derives_request_latencies_and_summary(models):
    tel = ServeTelemetry()
    reqs = _drive(_engine(models, telemetry=tel), _reqs(5))  # 2 slots:
    assert all(r.done for r in reqs)                          # some queue
    rows = tel.request_metrics()
    assert len(rows) == 5
    for r in rows:
        assert r["status"] == "finished"
        assert r["ttft_s"] > 0 and r["queue_wait_s"] >= 0
        assert r["e2e_s"] >= r["ttft_s"]
        assert r["itl_p50_s"] is not None and r["tokens"] == 4
    # summary percentiles are numpy-exact over the per-request samples
    s = tel.summary(qs=(50, 99))
    assert s["requests"] == 5
    ttft = tel.samples("ttft_s")
    assert s["ttft_s"]["p50"] == pytest.approx(
        float(np.percentile(ttft, 50)))
    assert s["ttft_s"]["p99"] == pytest.approx(
        float(np.percentile(ttft, 99)))
    assert s["ttft_s"]["count"] == 5
    assert set(s) == {"requests", *LATENCY_METRICS}
    with pytest.raises(ValueError, match="unknown latency metric"):
        tel.samples("nope")
    # the registry's bucketed twin saw the same observations
    assert tel.registry.histogram("serve.ttft_s", lo=1e-5, hi=1e3).count \
        == 5
    assert tel.trace.validate() == []


# ----------------------------- watchdog / recovery (step, wall-time) ----

def test_stats_exposes_last_watchdog_trip_and_recovery_records(models):
    """Trips and recoveries carry (step, wall-time) records in stats(),
    and the lifecycle trace sees the same events."""
    st = _engine(models).stats()
    assert st["last_watchdog_trip"] is None
    assert st["last_recovery"] is None

    tel = ServeTelemetry()
    eng = _engine(models, telemetry=tel, max_new_tokens=8, max_retries=6,
                  retry_backoff=1, watchdog_s=0.25,
                  plan=FaultPlan(stall_s=0.5).at(4, "stall"))
    reqs = _drive(eng, _reqs())
    assert all(r.done for r in reqs)
    st = eng.stats()
    assert st["watchdog_trips"] == 1
    trip = st["last_watchdog_trip"]
    assert set(trip) == {"step", "wall_time_s"}
    assert trip["step"] >= 1 and trip["wall_time_s"] > 0
    rec = st["last_recovery"]
    assert set(rec) == {"step", "kind", "wall_time_s"}
    assert rec["kind"] == "stall"
    assert rec["wall_time_s"] >= trip["wall_time_s"]
    kinds = {e.kind for e in tel.trace.events}
    assert {"watchdog_trip", "requeued", "fault"} <= kinds
    assert tel.registry.counter("serve.watchdog_trips").value == 1
    assert tel.trace.validate() == []


def test_fault_plan_keeps_injection_log(models):
    plan = FaultPlan().at(2, "kv_corrupt")
    eng = _engine(models, plan=plan, max_new_tokens=8, max_retries=6,
                  retry_backoff=1)
    reqs = _drive(eng, _reqs())
    assert all(r.done for r in reqs)
    assert any(kind == "kv_corrupt" and step == 2
               for step, kind, _slot in plan.injection_log)


# --------------------------------------------- REPRO_PROFILE hooks ----

def test_profile_hooks_aggregate_device_op_timings():
    """REPRO_PROFILE times every op wrapper (``device_op.<name>``) into
    one registry, on the CPU path too; off, a dispatch records nothing."""
    x = torch.randn(4, 32, generator=torch.Generator().manual_seed(0))
    w = torch.ones(32)
    profile.reset()
    was = profile.enabled()
    try:
        profile.enable(False)
        rms_ops.rmsnorm(x, w)
        assert profile.summary() == {"counters": {}, "gauges": {},
                                     "histograms": {}}
        profile.enable(True)
        rms_ops.rmsnorm(x, w)
        rms_ops.rmsnorm(x, w)
    finally:
        profile.enable(was)
    snap = profile.summary()
    assert snap["counters"]["device_op.rmsnorm.calls"] == 2
    hist = snap["histograms"]["device_op.rmsnorm.s"]
    assert hist["count"] == 2 and hist["p50"] > 0
    assert rms_ops.rmsnorm.__name__ == "rmsnorm"
    profile.reset()
    assert profile.summary()["counters"] == {}


def test_profile_times_the_serving_path_and_kernel_calls(models):
    """With profiling on, a served run records every op the path
    dispatched (norms, prefill attention, paged decode), and
    ``CudaKernel.launch`` records ``kernel_call.<name>`` (a stand-in
    entry point: no card here)."""
    profile.reset()
    was = profile.enabled()
    kern = object.__new__(CudaKernel)        # not registered in KERNELS
    kern.name, kern.launches = "stand_in", 0
    try:
        profile.enable(True)
        _drive(_engine(models), _reqs(2))
        with target("generic"):              # no card: no default target
            kern._entries = {current_context(): (None, lambda *args: 0)}
            kern.launch()
    finally:
        profile.enable(was)
    calls = profile.summary()["counters"]
    for op in ("rmsnorm", "flash_attention", "paged_decode_attention"):
        assert calls[f"device_op.{op}.calls"] > 0, calls
    assert calls["kernel_call.stand_in.calls"] == 1
    assert kern.launches == 1
    profile.reset()


# --------------------------------------- both engines, one fake clock ----

def _events(tel):
    return [(e.ts, e.kind, e.rid, e.slot, e.step, e.meta)
            for e in tel.trace.events]


def _tel_pair(models, reqs_of, plan_of=None, watchdog_s=None, **sc):
    """Both engines over the same requests (``reqs_of(request class)``)
    and plan (``plan_of(plan class)``), each with a ServeTelemetry on
    its own counting fake clock; returns (ref telemetry, ref engine,
    port telemetry, port engine)."""
    model, params, pmodel, pparams = models
    jtel, ptel = (JServeTelemetry(clock=_fake_clock()),
                  ServeTelemetry(clock=_fake_clock()))
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**sc),
                       fault_plan=plan_of and plan_of(JFaultPlan),
                       telemetry=jtel)
        _drive(jeng, reqs_of(JRequest), arm_watchdog_s=watchdog_s)
    peng = Engine(pmodel, pparams, ServeConfig(**sc, watchdog_s=watchdog_s),
                  device="cpu", fault_plan=plan_of and plan_of(FaultPlan),
                  telemetry=ptel)
    _drive(peng, reqs_of(Request))
    return jtel, jeng, ptel, peng


def _same_telemetry(jtel, ptel):
    assert _events(ptel) == _events(jtel)
    assert ptel.summary() == jtel.summary()
    assert ptel.summary_by_class() == jtel.summary_by_class()
    assert ptel.request_metrics() == jtel.request_metrics()
    assert ptel.registry.snapshot() == jtel.registry.snapshot()
    assert ptel.trace.validate() == [] == jtel.trace.validate()


@pytest.mark.parametrize("policy", ["lru", "priority"])
def test_trace_and_summaries_equal_reference_under_oversubscription(
        models, policy):
    """A bursty trace of three classes replayed on the step clock over
    an oversubscribed pool (8 usable pages for a 32-page working set):
    every trace event (time, kind, request, slot, step, meta), the
    summaries, per class too, and the registry equal the reference's."""
    spec = workload.WorkloadSpec(
        arrival=workload.ArrivalProcess("gamma", rate=0.8, burstiness=4.0),
        seed=0)
    jspec = jworkload.WorkloadSpec.from_json(spec.to_json())
    model, params, pmodel, pparams = models
    sc = dict(slots=4, cache_len=64, max_new_tokens=16, paged=True,
              page_size=8, total_pages=1 + 8, preempt_policy=policy)
    jtel, ptel = (JServeTelemetry(clock=_fake_clock()),
                  ServeTelemetry(clock=_fake_clock()))
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**sc), telemetry=jtel)
        jworkload.replay(jeng, jworkload.generate_trace(jspec, 12),
                         audit=True)
    peng = Engine(pmodel, pparams, ServeConfig(**sc), device="cpu",
                  telemetry=ptel)
    workload.replay(peng, workload.generate_trace(spec, 12), audit=True)
    assert peng.preemptions == jeng.preemptions > 0
    assert len(ptel.class_labels()) == 3
    _same_telemetry(jtel, ptel)


@pytest.mark.parametrize("case", [
    dict(schedule=[(3, "kv_corrupt", None), (5, "nan_logits", None),
                   (7, "alloc_fail", None)], kinds={"fault", "requeued"}),
    dict(schedule=[(s, "nan_logits", 0) for s in range(2, 14)],
         sc=dict(max_retries=2), kinds={"failed"}),
    dict(schedule=[(2, "nan_logits", 0), (3, "nan_logits", 0)], n=2,
         sc=dict(spec_mode="ngram", spec_k=3, spec_disable_after=2),
         kinds={"spec_degraded"}),
    dict(schedule=[(4, "stall", None)], plan_kw=dict(stall_s=1.0),
         watchdog_s=0.5, kinds={"watchdog_trip", "requeued"})],
    ids=["recover", "fail", "spec-degrade", "watchdog"])
def test_fault_hooks_equal_reference(models, case):
    """The fault hooks (fault, requeued, failed, spec_degraded,
    watchdog_trip) at the reference's sites: the same events and
    summaries under the same plan."""
    sc = dict(dict(slots=2, cache_len=32, max_new_tokens=8, paged=True,
                   page_size=4, max_retries=6, retry_backoff=1),
              **case.get("sc", {}))

    def plan_of(cls):
        plan = cls(**case.get("plan_kw", {}))
        for step, kind, slot in case["schedule"]:
            plan.at(step, kind, slot)
        return plan

    jtel, _, ptel, _ = _tel_pair(
        models, lambda cls: _reqs(case.get("n", 4), cls), plan_of,
        watchdog_s=case.get("watchdog_s"), **sc)
    _same_telemetry(jtel, ptel)
    assert case["kinds"] <= {e.kind for e in ptel.trace.events}
