"""The port's workload module (``repro_torch.serve.workload``) against
``repro.serve.workload``, mirrored on tests/test_workload.py: the
arrival processes' and length distributions' shapes, freeze and thaw,
generation determinism; then the same specs drawn in both packages, the
committed trace regenerated byte for byte, and the committed trace
replayed through both engines on the reference's SLO pool with the same
tokens and decisions.

The reference engine runs under ``target("generic")`` (ROADMAP.md queue
C, note 0); the port on the CPU, through the plain versions.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import jax
import numpy as np
import pytest

from repro.configs.smoke import smoke_config
from repro.core import context as ctx
from repro.models.registry import build_model
from repro.serve import Engine as JEngine
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeTelemetry as JServeTelemetry
from repro.serve import workload as jworkload
from repro_torch.configs.smoke import smoke_config as port_smoke_config
from repro_torch.convert import from_jax_params
from repro_torch.models.registry import build_model as port_build_model
from repro_torch.serve import workload
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.telemetry import ServeTelemetry
from repro_torch.serve.workload import (ARRIVAL_KINDS, DEFAULT_CLASSES,
                                        TRACE_SCHEMA_VERSION, ArrivalProcess,
                                        TrafficClass, WorkloadSpec,
                                        generate_trace, load_trace)

TRACE_PATH = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
              / "traces" / "bursty_smoke.jsonl")

#: the reference's SLO pool (benchmarks/serve_bench.py SLO_POOL): 4
#: slots of 8 pages of 8 rows, 15 usable pages, priority policy
SLO_POOL = dict(slots=4, cache_len=64, max_new_tokens=16, paged=True,
                page_size=8, total_pages=1 + 15, preempt_policy="priority")


# ------------------------------------------------- distribution shape ----

@pytest.mark.parametrize("kind", ARRIVAL_KINDS)
def test_arrival_process_hits_mean_rate(kind):
    """Seeded draws hit the configured mean rate within tolerance for
    both kinds (gamma's burstiness reshapes variance, not the mean)."""
    proc = ArrivalProcess(kind=kind, rate=0.5, burstiness=4.0)
    rng = np.random.default_rng(7)
    gaps = proc.interarrivals(rng, 20_000)
    assert (gaps >= 0).all()
    # mean inter-arrival = 1/rate = 2.0 steps
    assert np.mean(gaps) == pytest.approx(2.0, rel=0.1)


def test_gamma_is_burstier_than_poisson():
    """Same mean, heavier clumping: the gamma process's squared
    coefficient of variation ~ burstiness, the poisson baseline's ~ 1."""
    rng_p = np.random.default_rng(3)
    rng_g = np.random.default_rng(3)
    p = ArrivalProcess("poisson", rate=0.5).interarrivals(rng_p, 20_000)
    g = ArrivalProcess("gamma", rate=0.5,
                       burstiness=4.0).interarrivals(rng_g, 20_000)
    scv = lambda x: np.var(x) / np.mean(x) ** 2  # noqa: E731
    assert scv(p) == pytest.approx(1.0, rel=0.15)
    assert scv(g) == pytest.approx(4.0, rel=0.25)


def test_arrival_process_validation():
    with pytest.raises(ValueError, match="kind"):
        ArrivalProcess(kind="uniform")
    with pytest.raises(ValueError, match="rate"):
        ArrivalProcess(rate=0.0)
    with pytest.raises(ValueError, match="burstiness"):
        ArrivalProcess(kind="gamma", burstiness=-1.0)


def test_lognormal_lengths_mean_and_caps():
    """Sampled lengths target the configured mean (mu includes the
    -sigma^2/2 correction) and never escape the [lo, hi] caps."""
    cls = TrafficClass("t", priority=0, mix=1.0,
                       prompt_mean=8.0, prompt_sigma=0.6, prompt_lo=2,
                       prompt_hi=64, out_mean=6.0, out_sigma=0.5,
                       out_lo=2, out_hi=64)
    rng = np.random.default_rng(11)
    plens, olens = cls.sample_lengths(rng, 20_000)
    assert np.mean(plens) == pytest.approx(8.0, rel=0.1)
    assert np.mean(olens) == pytest.approx(6.0, rel=0.1)
    tight = dataclasses.replace(cls, prompt_lo=4, prompt_hi=10,
                                out_lo=2, out_hi=5)
    plens, olens = tight.sample_lengths(rng, 5_000)
    assert plens.min() >= 4 and plens.max() <= 10
    assert olens.min() >= 2 and olens.max() <= 5


# ------------------------------------------------ generation + freeze ----

def _spec(**kw):
    kw.setdefault("arrival", ArrivalProcess("gamma", rate=0.8,
                                            burstiness=4.0))
    return WorkloadSpec(**kw)


def test_generate_trace_shape_and_mix():
    trace = generate_trace(_spec(seed=0), 200)
    assert len(trace.entries) == 200
    assert [e.rid for e in trace.entries] == list(range(200))
    steps = [e.arrival_step for e in trace.entries]
    assert steps == sorted(steps)
    by_name = {c.name: c for c in DEFAULT_CLASSES}
    assert trace.classes_present() == sorted(by_name)
    for e in trace.entries:
        c = by_name[e.cls]
        assert e.priority == c.priority
        assert c.prompt_lo <= len(e.tokens) <= c.prompt_hi
        assert c.out_lo <= e.max_new <= c.out_hi
        assert all(0 <= t < 256 for t in e.tokens)
    r = trace.entries[0].to_request()
    assert (r.priority_class, r.traffic_class, r.max_new) == \
        (trace.entries[0].priority, trace.entries[0].cls,
         trace.entries[0].max_new)


def test_generate_trace_is_deterministic():
    a = generate_trace(_spec(seed=5), 50)
    b = generate_trace(_spec(seed=5), 50)
    assert a.entries == b.entries
    c = generate_trace(_spec(seed=6), 50)
    assert c.entries != a.entries


def test_trace_round_trip(tmp_path):
    """generate -> save -> load reproduces the spec and every entry."""
    trace = generate_trace(_spec(seed=9), 40)
    path = tmp_path / "t.jsonl"
    trace.save(str(path))
    loaded = load_trace(str(path))
    assert loaded.spec == trace.spec
    assert loaded.entries == trace.entries
    regen = generate_trace(loaded.spec, len(loaded.entries))
    assert regen.entries == loaded.entries


def test_load_trace_rejects_bad_files(tmp_path):
    trace = generate_trace(_spec(seed=1), 5)
    good = tmp_path / "good.jsonl"
    trace.save(str(good))
    lines = good.read_text().splitlines()

    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    with pytest.raises(ValueError, match="empty"):
        load_trace(str(empty))

    notrace = tmp_path / "notrace.jsonl"
    notrace.write_text(json.dumps({"kind": "other"}) + "\n")
    with pytest.raises(ValueError, match="not a workload trace"):
        load_trace(str(notrace))

    futur = tmp_path / "future.jsonl"
    hdr = json.loads(lines[0])
    hdr["schema_version"] = TRACE_SCHEMA_VERSION + 1
    futur.write_text("\n".join([json.dumps(hdr)] + lines[1:]) + "\n")
    with pytest.raises(ValueError, match="schema version"):
        load_trace(str(futur))

    trunc = tmp_path / "trunc.jsonl"
    trunc.write_text("\n".join(lines[:-1]) + "\n")
    with pytest.raises(ValueError, match="truncated"):
        load_trace(str(trunc))

    unordered = tmp_path / "unordered.jsonl"
    body = [json.loads(ln) for ln in lines[1:]]
    body[0]["arrival_step"] = body[-1]["arrival_step"] + 1
    unordered.write_text("\n".join([lines[0]] + [json.dumps(d)
                                                 for d in body]) + "\n")
    with pytest.raises(ValueError, match="arrival-ordered"):
        load_trace(str(unordered))


def test_generate_trace_validation():
    with pytest.raises(ValueError, match="n_requests"):
        generate_trace(_spec(), 0)
    with pytest.raises(ValueError, match="classes"):
        generate_trace(WorkloadSpec(classes=()), 4)
    bad_mix = (dataclasses.replace(DEFAULT_CLASSES[0], mix=0.0),)
    with pytest.raises(ValueError, match="mix"):
        generate_trace(WorkloadSpec(classes=bad_mix), 4)


def test_committed_trace_matches_its_embedded_spec(tmp_path):
    """The committed trace regenerates from the spec frozen in its own
    header: the same entries, and the same bytes when saved."""
    committed = load_trace(str(TRACE_PATH))
    regen = generate_trace(committed.spec, len(committed.entries))
    assert regen.entries == committed.entries
    out = tmp_path / "regen.jsonl"
    regen.save(str(out))
    assert out.read_bytes() == TRACE_PATH.read_bytes()


# ------------------------------------------------- against repro ----

@pytest.mark.parametrize("kind,seed,n", [("gamma", 0, 60),
                                         ("poisson", 4, 25),
                                         ("gamma", 11, 7)])
def test_same_spec_same_trace_as_reference(tmp_path, kind, seed, n):
    """numpy's default_rng in the reference's draw order: the same spec
    and seed give the same entries, and the same file, in both
    packages."""
    spec = WorkloadSpec(arrival=ArrivalProcess(kind, rate=0.6,
                                               burstiness=3.0),
                        vocab_size=1000, seed=seed)
    jspec = jworkload.WorkloadSpec.from_json(spec.to_json())
    ours, theirs = generate_trace(spec, n), jworkload.generate_trace(jspec, n)
    assert [dataclasses.astuple(e) for e in ours.entries] == \
        [dataclasses.astuple(e) for e in theirs.entries]
    ours.save(str(tmp_path / "port.jsonl"))
    theirs.save(str(tmp_path / "ref.jsonl"))
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


def test_freeze_command_writes_the_reference_file(tmp_path, capsys):
    """``python -m repro_torch.serve.workload`` freezes what the
    reference's command freezes."""
    args = ["--n", "12", "--kind", "poisson", "--rate", "0.5", "--seed",
            "2"]
    workload._main(["--out", str(tmp_path / "port.jsonl"), *args])
    jworkload._main(["--out", str(tmp_path / "ref.jsonl"), *args])
    assert "froze 12 requests" in capsys.readouterr().out
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


@pytest.fixture(scope="module")
def replays():
    """The committed trace replayed (audit after every step) through
    repro's engine and twice through the port's, on the reference's SLO
    pool with the float32 one-layer granite smoke model; returns each
    run's (requests, telemetry, engine)."""
    cfg = dataclasses.replace(smoke_config("granite-8b", num_layers=1),
                              dtype="float32")
    model = build_model(cfg)
    params = model.init(jax.random.PRNGKey(0))
    pcfg = dataclasses.replace(
        port_smoke_config("granite-8b", num_layers=1), dtype="float32")
    pmodel = port_build_model(pcfg)
    pparams = from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                              pcfg, device="cpu")
    with ctx.target("generic"):
        jtel = JServeTelemetry()
        jeng = JEngine(model, params, JServeConfig(**SLO_POOL),
                       telemetry=jtel)
        jreqs = jworkload.replay(jeng, jworkload.load_trace(str(TRACE_PATH)),
                                 audit=True)
    runs = {"ref": (jreqs, jtel, jeng)}
    for name in ("port", "port2"):
        tel = ServeTelemetry()
        eng = Engine(pmodel, pparams, ServeConfig(**SLO_POOL), device="cpu",
                     telemetry=tel)
        runs[name] = (workload.replay(eng, load_trace(str(TRACE_PATH)),
                                      audit=True), tel, eng)
    return runs


def _contract(reqs, tel):
    """The reference's workload-smoke contract: tokens per request,
    admission order, preemption order, per-class counts."""
    outs = {r.rid: list(r.out) for r in reqs}
    admits = [e.rid for e in tel.trace.events if e.kind == "admitted"]
    preempts = [e.rid for e in tel.trace.events if e.kind == "preempted"]
    by_cls = {c: {k: blk[k] for k in ("requests", "completed", "preempts")}
              for c, blk in tel.summary_by_class().items()}
    return outs, admits, preempts, by_cls


def test_replay_of_committed_trace_equals_reference(replays):
    jreqs, jtel, jeng = replays["ref"]
    preqs, ptel, peng = replays["port"]
    assert all(r.done for r in preqs)
    want = _contract(jreqs, jtel)
    assert _contract(preqs, ptel) == want
    assert want[2], "the oversubscribed replay saw no preemption"
    assert len(want[3]) >= 2
    assert [len(r.out) for r in preqs] == [min(r.max_new, 16)
                                           for r in preqs]
    assert peng.step_count == jeng.step_count
    assert ptel.trace.validate() == []
    # every decision (kind, request, slot, step), not only the contract's
    assert [(e.kind, e.rid, e.slot, e.step) for e in ptel.trace.events] \
        == [(e.kind, e.rid, e.slot, e.step) for e in jtel.trace.events]


def test_replay_is_deterministic(replays):
    assert _contract(*replays["port"][:2]) == \
        _contract(*replays["port2"][:2])


def test_replay_refuses_a_trace_that_never_drains(replays):
    served = replays["port"][2]
    eng = Engine(served.model, served.params, ServeConfig(**SLO_POOL),
                 device="cpu")
    trace = load_trace(str(TRACE_PATH))
    with pytest.raises(AssertionError, match="did not drain"):
        workload.replay(eng, trace, max_steps=3)
