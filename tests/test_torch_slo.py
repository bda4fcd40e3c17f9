"""The engine's remaining knobs against ``repro.serve``: sampling at
temperature > 0 (seeded determinism, the Gumbel-max law, the decisions
of a sampled run), the "priority" policy (victim order, class-first
admission, admission-time eviction), per-request decode budgets, the
``stats()`` keys and values, and the launcher's trace replay with its
trace and metrics files, mirrored on tests/test_serve.py.

The reference runs under ``target("generic")`` (ROADMAP.md queue C,
note 0); the port on the CPU, where every kernel wrapper takes its plain
version.  Sampled tokens differ between the packages (a torch generator
is not JAX's threefry stream), but with ``eos_id`` unset no scheduling
decision reads a token value.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest
import torch

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models.registry import build_model
from repro.serve import Engine as JEngine
from repro.serve import FaultPlan as JFaultPlan
from repro.serve import Request as JRequest
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeTelemetry as JServeTelemetry
from repro.serve import workload as jworkload
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.launch import serve as launch_serve
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import workload
from repro_torch.serve.engine import Engine, Request, ServeConfig, sample
from repro_torch.serve.faults import FaultPlan
from repro_torch.serve.telemetry import ServeTelemetry

TRACE_PATH = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
              / "traces" / "bursty_smoke.jsonl")


def _pair_models(arch, num_layers):
    cfg = dataclasses.replace(smoke_config(arch, num_layers=num_layers),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(port_smoke_config(arch, num_layers=num_layers),
                               dtype="float32")
    tree = jax.tree_util.tree_map(np.asarray, params)
    return (model, params, port_build_model(pcfg),
            from_jax_params(tree, pcfg, device="cpu"))


@pytest.fixture(scope="module")
def models():
    """granite smoke, one layer, float32, in both packages."""
    return _pair_models("granite-8b", 1)


def _engine(models, **kw):
    return Engine(models[2], models[3], ServeConfig(**kw), device="cpu")


def _run(models, reqs, **kw):
    eng = _engine(models, **kw)
    eng.run_to_completion(reqs)
    return eng, reqs


# ------------------------------------------------------------- sampling ----

def test_temperature_sampling_deterministic_under_seed(models):
    def run(seed):
        _, reqs = _run(models, [Request(rid=i, tokens=[2 + i, 9, 4])
                                for i in range(4)],
                       slots=2, cache_len=32, max_new_tokens=6,
                       temperature=0.8, seed=seed)
        assert all(r.done and len(r.out) == 6 for r in reqs)
        return [r.out for r in reqs]

    assert run(7) == run(7)                 # same seed -> same stream
    assert run(7) != run(123)               # different seed -> diverges

    def greedy(seed):                       # greedy ignores the seed
        _, (req,) = _run(models, [Request(rid=0, tokens=[2, 9, 4])],
                         slots=2, cache_len=32, max_new_tokens=6, seed=seed)
        return req.out

    assert greedy(7) == greedy(123)


def test_gumbel_max_frequencies_follow_softmax():
    """Gumbel-max draws from one fixed 32-way row at T = 0.8: each
    class's frequency within 5 standard errors of softmax(logits / T)."""
    rng = np.random.default_rng(0)
    row = torch.from_numpy(rng.standard_normal(32).astype(np.float32) * 2)
    n = 1 << 16
    gen = torch.Generator().manual_seed(0)
    got = sample(row.expand(n, 32), 0.8, gen)
    assert got.dtype == torch.int32 and got.shape == (n,)
    freq = torch.bincount(got.long(), minlength=32).double() / n
    p = torch.softmax(row.double() / 0.8, dim=0)
    se = torch.sqrt(p * (1 - p) / n)
    assert bool(((freq - p).abs() <= 5 * se + 1e-12).all()), \
        float(((freq - p).abs() / se).max())
    # temperature 0 is the argmax, and draws nothing
    state = gen.get_state()
    assert sample(row[None], 0.0, gen).item() == int(row.argmax())
    assert torch.equal(gen.get_state(), state)


def _slo_pair(models, temperature=0.0):
    """A bursty three-class trace of 12 requests replayed through both
    engines on an oversubscribed pool (8 usable pages for a 32-page
    working set), priority policy; returns (ref telemetry, ref
    requests, port telemetry, port requests)."""
    model, params, pmodel, pparams = models
    spec = workload.WorkloadSpec(
        arrival=workload.ArrivalProcess("gamma", rate=0.8, burstiness=4.0),
        seed=0)
    jspec = jworkload.WorkloadSpec.from_json(spec.to_json())
    sc = dict(slots=4, cache_len=64, max_new_tokens=16, paged=True,
              page_size=8, total_pages=1 + 8, preempt_policy="priority",
              temperature=temperature)
    jtel, ptel = JServeTelemetry(), ServeTelemetry()
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**sc), telemetry=jtel)
        jreqs = jworkload.replay(jeng, jworkload.generate_trace(jspec, 12),
                                 audit=True)
    peng = Engine(pmodel, pparams, ServeConfig(**sc), device="cpu",
                  telemetry=ptel)
    preqs = workload.replay(peng, workload.generate_trace(spec, 12),
                            audit=True)
    return jtel, jreqs, ptel, preqs


def _decisions(tel):
    return [(e.kind, e.rid, e.slot, e.step) for e in tel.trace.events]


def test_sampled_run_makes_the_reference_decisions(models):
    """At temperature 0.8: tokens differ by the generator, every
    decision (kind, request, slot, step) equals the reference's."""
    jtel, jreqs, ptel, preqs = _slo_pair(models, temperature=0.8)
    assert all(r.done for r in preqs)
    assert _decisions(ptel) == _decisions(jtel)
    assert any(e.kind == "preempted" for e in ptel.trace.events)
    assert [len(r.out) for r in preqs] == [len(r.out) for r in jreqs]
    assert [r.out for r in preqs] != [r.out for r in jreqs]


# -------------------------------------------------------- priority ----

def test_priority_victim_selection(models):
    """The "priority" policy evicts the lowest priority_class first,
    oldest admit stamp breaking ties within a class; the needy slot is
    never a victim."""
    engine = _engine(models, slots=3, cache_len=32, max_new_tokens=4,
                     paged=True, page_size=8, preempt_policy="priority")
    for s, (seq, pc) in enumerate([(5, 2), (2, 0), (9, 0)]):
        engine.active[s] = Request(rid=s, tokens=[1], priority_class=pc)
        engine._active_h[s] = True
        engine._admit_seq[s] = seq
    assert engine._select_victim(0) == 1   # lowest class, oldest stamp
    assert engine._select_victim(1) == 2   # never the needy slot
    engine.active[2].priority_class = 1
    assert engine._select_victim(0) == 1   # class outranks admit stamp
    engine._active_h[1] = False
    assert engine._select_victim(0) == 2


def test_priority_admission_ordering(models):
    """Admission takes classes first (checkpoints still ahead of fresh
    arrivals within a class), and is the old FIFO when classes are
    uniform; a request backing off is skipped with its order kept."""
    engine = _engine(models, slots=2, cache_len=32, max_new_tokens=4,
                     paged=True, page_size=8, preempt_policy="priority")
    engine.queue.extend([
        Request(rid=0, tokens=[1], priority_class=0),
        Request(rid=1, tokens=[1], priority_class=2),
        Request(rid=2, tokens=[1], priority_class=1),
    ])
    engine.requeue.append(Request(rid=3, tokens=[1], priority_class=1))
    got = [r.rid for r in engine._take_waiting(4)]
    assert got == [1, 3, 2, 0]
    assert not engine.queue and not engine.requeue

    engine.requeue.extend([Request(rid=10, tokens=[1]),
                           Request(rid=11, tokens=[1])])
    engine.queue.extend([Request(rid=12, tokens=[1]),
                         Request(rid=13, tokens=[1])])
    assert [r.rid for r in engine._take_waiting(3)] == [10, 11, 12]
    assert [r.rid for r in engine._take_waiting(3)] == [13]

    held = Request(rid=20, tokens=[1], priority_class=5)
    held.not_before = engine.step_count + 10
    engine.queue.append(held)
    engine.queue.append(Request(rid=21, tokens=[1]))
    assert [r.rid for r in engine._take_waiting(2)] == [21]
    assert [r.rid for r in engine.queue] == [20]
    assert engine._take_waiting(0) == []


@pytest.mark.parametrize("waiting_class,evicts", [(2, True), (1, False)])
def test_priority_admission_time_eviction(models, waiting_class, evicts):
    """A waiting request of a strictly higher class evicts the lowest
    active slot at admission, the same step as the reference's; an
    equal class waits."""
    model, params, pmodel, pparams = models
    sc = dict(slots=2, cache_len=32, max_new_tokens=8, paged=True,
              page_size=8, preempt_policy="priority")
    runs = {}
    for name in ("ref", "port"):
        req_cls = JRequest if name == "ref" else Request
        reqs = [req_cls(rid=0, tokens=[3, 1, 4], priority_class=1),
                req_cls(rid=1, tokens=[2, 7], priority_class=1),
                req_cls(rid=2, tokens=[5, 5, 5, 5],
                        priority_class=waiting_class)]
        with ctx.target("generic"):
            eng = (JEngine(model, params, JServeConfig(**sc))
                   if name == "ref" else
                   Engine(pmodel, pparams, ServeConfig(**sc), device="cpu"))
            for r in reqs[:2]:
                eng.submit(r)
            eng.step()
            eng.step()
            eng.submit(reqs[2])
            eng.step()
            admitted = [r.rid for r in eng.active if r is not None]
            eng.run_to_completion([])
        runs[name] = (admitted, [r.out for r in reqs],
                      [r.preempts for r in reqs], eng.preemptions)
    admitted, outs, preempts, n = runs["port"]
    assert (2 in admitted) == evicts
    assert (n > 0) == evicts
    assert runs["port"] == runs["ref"]


def test_per_request_max_new_budget(models):
    """Request.max_new caps that request's decode, itself capped by
    max_new_tokens; a slot is reused at the next request's budget; the
    same tokens as the reference's."""
    model, params, _, _ = models
    mk = [dict(tokens=[3, 1, 4], max_new=2), dict(tokens=[3, 1, 4]),
          dict(tokens=[3, 1, 4], max_new=50), dict(tokens=[2, 7], max_new=1),
          dict(tokens=[9, 9, 9], max_new=3)]
    sc = dict(slots=2, cache_len=32, max_new_tokens=6, paged=True,
              page_size=8)
    eng, reqs = _run(models, [Request(rid=i, **m) for i, m in enumerate(mk)],
                     **sc)
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [2, 6, 6, 1, 3]
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**sc))
        jreqs = jeng.run_to_completion(
            [JRequest(rid=i, **m) for i, m in enumerate(mk)])
    assert [r.out for r in reqs] == [r.out for r in jreqs]
    assert eng.step_count == jeng.step_count
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(Request(rid=9, tokens=[1], max_new=0))


# ---------------------------------------------------------- stats() ----

def _strip_wall(v):
    if isinstance(v, dict):
        return {k: _strip_wall(x) for k, x in v.items() if k != "wall_time_s"}
    return v


@pytest.mark.parametrize("mode", ["paged", "dense", "windowed", "spec",
                                  "faulted"])
def test_stats_keys_and_values_equal_reference(models, mode):
    """After the same requests, the port's stats() holds every key of
    the reference's with the reference's value (wall times aside); its
    extra kv_dtype may stay."""
    if mode == "windowed":
        model, params, pmodel, pparams = _pair_models("gemma2-2b", 2)
    else:
        model, params, pmodel, pparams = models
    sc = dict(slots=2, cache_len=32, max_new_tokens=6, paged=mode != "dense",
              page_size=4, total_pages=None if mode == "dense" else 8,
              retry_backoff=1)
    if mode == "spec":
        sc.update(spec_mode="ngram", spec_k=3)
    plans = ((JFaultPlan().at(3, "kv_corrupt").at(6, "nan_logits"),
              FaultPlan().at(3, "kv_corrupt").at(6, "nan_logits"))
             if mode == "faulted" else (None, None))
    prompts = [[1 + i] * (5 + 3 * i) for i in range(4)]
    with ctx.target("generic"):
        jeng = JEngine(model, params, JServeConfig(**sc), fault_plan=plans[0])
        jeng.run_to_completion([JRequest(rid=i, tokens=p)
                                for i, p in enumerate(prompts)])
    peng = Engine(pmodel, pparams, ServeConfig(**sc), device="cpu",
                  fault_plan=plans[1])
    peng.run_to_completion([Request(rid=i, tokens=p)
                            for i, p in enumerate(prompts)])
    js, ps = jeng.stats(), peng.stats()
    assert set(js) <= set(ps), set(js) - set(ps)
    assert set(ps) - set(js) <= {"kv_dtype"}
    for key in js:
        assert _strip_wall(ps[key]) == _strip_wall(js[key]), key
    if mode != "dense":
        assert "pool_groups" in ps
    if mode == "faulted":
        assert ps["recoveries_total"] >= 1
    if mode == "paged":
        assert ps["preemptions"] > 0 and "requeued_waiting" in ps


# --------------------------------------------------------- launcher ----

def test_launcher_replays_a_trace_with_priority(capsys, tmp_path):
    """``python -m repro_torch.launch.serve`` replaying the committed
    trace under the priority policy on an oversubscribed pool, with the
    lifecycle trace and the registries written out."""
    trace_out, metrics_out = tmp_path / "trace.json", tmp_path / "m.json"
    reqs = launch_serve.main([
        "--arch", "granite-8b", "--smoke", "--device", "cpu", "--paged",
        "--page-size", "8", "--total-pages", "16", "--slots", "4",
        "--max-new", "16", "--preempt-policy", "priority",
        "--trace-file", str(TRACE_PATH), "--trace-out", str(trace_out),
        "--metrics-out", str(metrics_out)])
    trace = workload.load_trace(str(TRACE_PATH))
    assert all(r.done for r in reqs)
    assert [len(r.out) for r in reqs] == [min(e.max_new, 16)
                                          for e in trace.entries]
    out = json.loads(capsys.readouterr().out)
    assert out["all_done"] and out["preemptions"] > 0
    assert set(out["latency_by_class"]) == {"chat", "longdoc", "batch"}
    assert out["latency"]["ttft_s"]["count"] == len(trace.entries)
    assert len(out["per_request"]) == len(trace.entries)
    doc = json.loads(trace_out.read_text())
    assert doc["otherData"]["recorded_events"] > 0
    metrics = json.loads(metrics_out.read_text())
    assert metrics["engine"]["counters"]["serve.preemptions.priority"] == \
        out["preemptions"]
    assert metrics["telemetry"]["counters"]["serve.finished"] == len(reqs)


def test_launcher_refuses_a_class_with_a_trace():
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "granite-8b", "--smoke", "--device",
                           "cpu", "--paged", "--trace-file",
                           str(TRACE_PATH), "--priority-class", "2"])


def test_launcher_samples_at_temperature(capsys):
    reqs = launch_serve.main(["--arch", "granite-8b", "--smoke", "--device",
                              "cpu", "--prompts", "2", "--prompt-len", "5",
                              "--max-new", "4", "--temperature", "0.8",
                              "--priority-class", "1"])
    assert all(r.done and len(r.out) == 4 for r in reqs)
    out = json.loads(capsys.readouterr().out)
    assert set(out["latency_by_class"]) == {"1"}
