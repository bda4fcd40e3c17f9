"""Trace-driven workloads (``repro.serve.workload`` ported): arrival
processes and heavy-tailed per-class length distributions, frozen to a
JSONL trace and replayed through the serve engine on its own step
clock.

Traffic is bursty (arrival clumps an admission queue has to absorb),
heavy-tailed (a few long-document prefills among many short chat turns)
and mixed (an interactive chat turn and an offline batch job have
different latency contracts).  This module models all three:

* :class:`TrafficClass`: a priority level (the
  ``Request.priority_class`` the "priority" policy reads), a mix share,
  and lognormal prompt/output length distributions clipped to caps so a
  sampled length never overflows the serving cache.  Three built-ins:
  ``chat`` (short, highest priority), ``longdoc`` (long prefill, mid
  priority), ``batch`` (offline, lowest priority, longest decodes).
* :class:`ArrivalProcess`: ``"poisson"`` (exponential inter-arrivals)
  or ``"gamma"`` (shape ``1/burstiness``: the same mean rate in clumps
  with long gaps).
* :func:`generate_trace`: sample a :class:`WorkloadTrace`: per request
  an integer ``arrival_step`` on the engine's step clock, a class, a
  prompt of concrete tokens and a ``max_new`` decode budget.  The draws
  come from numpy's ``default_rng`` in the reference's order, so the
  same spec gives the same trace in both packages, byte for byte when
  saved.
* :meth:`WorkloadTrace.save` / :func:`load_trace`: freeze to and thaw
  from JSONL, one header line with the schema version and the spec,
  one line per request.
* :func:`replay`: submit each request when the engine's step counter
  reaches its ``arrival_step``, so queue wait and TTFT measure
  admission under load rather than a pre-filled queue.

Freeze a trace with ``python -m repro_torch.serve.workload --out PATH``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.serve.engine import Request

__all__ = [
    "TrafficClass", "ArrivalProcess", "WorkloadSpec", "TraceEntry",
    "WorkloadTrace", "DEFAULT_CLASSES", "TRACE_SCHEMA_VERSION",
    "generate_trace", "load_trace", "replay",
]

#: Bumped on any change to the JSONL trace layout; load_trace refuses
#: newer-versioned files instead of misreading them.
TRACE_SCHEMA_VERSION = 1

#: Valid ArrivalProcess.kind values.
ARRIVAL_KINDS = ("poisson", "gamma")


@dataclasses.dataclass(frozen=True)
class TrafficClass:
    """One traffic class: priority + mix share + length distributions.

    Lengths are lognormal — the standard heavy-tailed shape for both
    prompt and output lengths in production serving traces — clipped
    to ``[lo, hi]`` caps so a sampled request always fits the serving
    cache it is destined for.
    """
    name: str
    priority: int            # higher = more latency-sensitive
    mix: float               # share of arrivals (normalized across classes)
    prompt_mean: float       # target mean prompt tokens (pre-clip)
    prompt_sigma: float      # lognormal sigma: tail heaviness
    prompt_lo: int
    prompt_hi: int
    out_mean: float          # target mean decode budget (pre-clip)
    out_sigma: float
    out_lo: int
    out_hi: int

    def sample_lengths(self, rng: np.random.Generator,
                       n: int) -> Tuple[np.ndarray, np.ndarray]:
        return (_lognormal_lengths(rng, self.prompt_mean, self.prompt_sigma,
                                   self.prompt_lo, self.prompt_hi, n),
                _lognormal_lengths(rng, self.out_mean, self.out_sigma,
                                   self.out_lo, self.out_hi, n))


def _lognormal_lengths(rng: np.random.Generator, mean: float, sigma: float,
                       lo: int, hi: int, n: int) -> np.ndarray:
    # parameterize by the *distribution* mean: mu = ln(mean) - sigma^2/2
    mu = math.log(mean) - 0.5 * sigma * sigma
    raw = rng.lognormal(mu, sigma, size=n)
    return np.clip(np.rint(raw), lo, hi).astype(np.int64)


#: The built-in production-shaped mix (smoke scale: lengths sized for
#: the cache_len=64 smoke engines).
DEFAULT_CLASSES: Tuple[TrafficClass, ...] = (
    TrafficClass("chat", priority=2, mix=0.5,
                 prompt_mean=8.0, prompt_sigma=0.6, prompt_lo=2,
                 prompt_hi=20, out_mean=6.0, out_sigma=0.5, out_lo=2,
                 out_hi=12),
    TrafficClass("longdoc", priority=1, mix=0.2,
                 prompt_mean=28.0, prompt_sigma=0.5, prompt_lo=12,
                 prompt_hi=48, out_mean=4.0, out_sigma=0.4, out_lo=2,
                 out_hi=8),
    TrafficClass("batch", priority=0, mix=0.3,
                 prompt_mean=12.0, prompt_sigma=0.7, prompt_lo=4,
                 prompt_hi=24, out_mean=10.0, out_sigma=0.5, out_lo=4,
                 out_hi=16),
)


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """Arrival-time generator over the engine's step clock.

    ``rate`` is mean arrivals per engine step for both kinds.
    ``"gamma"`` keeps that mean but draws inter-arrivals from a
    Gamma(shape=1/burstiness) — burstiness > 1 yields clumped arrivals
    with long gaps (squared coefficient of variation ≈ burstiness),
    the load shape that actually stresses admission ordering.
    """
    kind: str = "poisson"
    rate: float = 0.5
    burstiness: float = 4.0

    def __post_init__(self):
        if self.kind not in ARRIVAL_KINDS:
            raise ValueError(f"arrival kind must be one of {ARRIVAL_KINDS}, "
                             f"got {self.kind!r}")
        if self.rate <= 0:
            raise ValueError(f"arrival rate must be > 0, got {self.rate}")
        if self.kind == "gamma" and self.burstiness <= 0:
            raise ValueError(f"burstiness must be > 0, "
                             f"got {self.burstiness}")

    def interarrivals(self, rng: np.random.Generator,
                      n: int) -> np.ndarray:
        if self.kind == "poisson":
            return rng.exponential(1.0 / self.rate, size=n)
        shape = 1.0 / self.burstiness
        scale = 1.0 / (self.rate * shape)   # mean = shape*scale = 1/rate
        return rng.gamma(shape, scale, size=n)


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Everything generate_trace needs: classes, arrivals, vocab, seed."""
    classes: Tuple[TrafficClass, ...] = DEFAULT_CLASSES
    arrival: ArrivalProcess = ArrivalProcess()
    vocab_size: int = 256
    seed: int = 0

    def to_json(self) -> Dict[str, Any]:
        return {"classes": [dataclasses.asdict(c) for c in self.classes],
                "arrival": dataclasses.asdict(self.arrival),
                "vocab_size": self.vocab_size, "seed": self.seed}

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "WorkloadSpec":
        return WorkloadSpec(
            classes=tuple(TrafficClass(**c) for c in d["classes"]),
            arrival=ArrivalProcess(**d["arrival"]),
            vocab_size=d["vocab_size"], seed=d["seed"])


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    """One frozen request: concrete tokens, stepped arrival, budget."""
    rid: int
    arrival_step: int
    cls: str
    priority: int
    tokens: Tuple[int, ...]
    max_new: int

    def to_request(self) -> Request:
        return Request(rid=self.rid, tokens=list(self.tokens),
                       priority_class=self.priority,
                       traffic_class=self.cls, max_new=self.max_new)


@dataclasses.dataclass
class WorkloadTrace:
    """A frozen, replayable request stream (entries arrival-ordered)."""
    spec: WorkloadSpec
    entries: List[TraceEntry]

    def requests(self) -> List[Request]:
        return [e.to_request() for e in self.entries]

    def classes_present(self) -> List[str]:
        return sorted({e.cls for e in self.entries})

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps(
                {"schema_version": TRACE_SCHEMA_VERSION,
                 "kind": "workload_trace",
                 "n_requests": len(self.entries),
                 "spec": self.spec.to_json()}, sort_keys=True) + "\n")
            for e in self.entries:
                f.write(json.dumps(
                    {"rid": e.rid, "arrival_step": e.arrival_step,
                     "cls": e.cls, "priority": e.priority,
                     "tokens": list(e.tokens), "max_new": e.max_new},
                    sort_keys=True) + "\n")


def load_trace(path: str) -> WorkloadTrace:
    with open(path) as f:
        lines = [ln for ln in (l.strip() for l in f) if ln]
    if not lines:
        raise ValueError(f"{path}: empty trace file")
    header = json.loads(lines[0])
    if header.get("kind") != "workload_trace":
        raise ValueError(f"{path}: not a workload trace (header {header})")
    ver = header.get("schema_version")
    if ver != TRACE_SCHEMA_VERSION:
        raise ValueError(f"{path}: trace schema version {ver} != supported "
                         f"{TRACE_SCHEMA_VERSION}")
    entries = []
    for i, ln in enumerate(lines[1:]):
        d = json.loads(ln)
        entries.append(TraceEntry(
            rid=d["rid"], arrival_step=d["arrival_step"], cls=d["cls"],
            priority=d["priority"], tokens=tuple(d["tokens"]),
            max_new=d["max_new"]))
    if len(entries) != header.get("n_requests"):
        raise ValueError(f"{path}: header promises "
                         f"{header.get('n_requests')} requests, file "
                         f"carries {len(entries)} (truncated?)")
    if any(b.arrival_step < a.arrival_step
           for a, b in zip(entries, entries[1:])):
        raise ValueError(f"{path}: entries not arrival-ordered")
    return WorkloadTrace(spec=WorkloadSpec.from_json(header["spec"]),
                         entries=entries)


def generate_trace(spec: WorkloadSpec, n_requests: int) -> WorkloadTrace:
    """Sample a frozen trace: class per arrival by mix share, stepped
    arrival times from the configured process, lengths per class.  The
    whole draw comes from one seeded Generator, so a spec + n_requests
    pair always yields the identical trace."""
    if n_requests < 1:
        raise ValueError(f"n_requests must be >= 1, got {n_requests}")
    if not spec.classes:
        raise ValueError("spec has no traffic classes")
    rng = np.random.default_rng(spec.seed)
    mix = np.asarray([c.mix for c in spec.classes], np.float64)
    if (mix <= 0).any():
        raise ValueError(f"every class mix share must be > 0, got "
                         f"{[c.mix for c in spec.classes]}")
    mix = mix / mix.sum()
    cls_idx = rng.choice(len(spec.classes), size=n_requests, p=mix)
    steps = np.floor(np.cumsum(
        spec.arrival.interarrivals(rng, n_requests))).astype(np.int64)
    # per-class length draws, scattered back into arrival order (one
    # vectorized draw per class keeps the stream reproducible even if
    # numpy's per-sample lognormal path ever changes stride)
    plens = np.zeros(n_requests, np.int64)
    olens = np.zeros(n_requests, np.int64)
    for ci, c in enumerate(spec.classes):
        sel = np.nonzero(cls_idx == ci)[0]
        if sel.size:
            p, o = c.sample_lengths(rng, sel.size)
            plens[sel], olens[sel] = p, o
    entries = []
    for rid in range(n_requests):
        c = spec.classes[int(cls_idx[rid])]
        toks = rng.integers(0, spec.vocab_size,
                            size=int(plens[rid])).tolist()
        entries.append(TraceEntry(
            rid=rid, arrival_step=int(steps[rid]), cls=c.name,
            priority=c.priority, tokens=tuple(int(t) for t in toks),
            max_new=int(olens[rid])))
    return WorkloadTrace(spec=spec, entries=entries)


def replay(engine, trace: WorkloadTrace, *, audit: bool = False,
           max_steps: int = 20_000) -> List[Request]:
    """Feed ``trace`` through ``engine`` on stepped arrival times.

    Each entry is submitted exactly when the engine's step counter
    reaches its ``arrival_step`` — never earlier — so queue-wait and
    TTFT measure real admission behavior instead of a pre-filled
    queue's artifacts.  The engine keeps stepping (idle steps tick the
    clock, which is also what drains retry backoffs) until every entry
    has arrived and drained.  Returns the materialized requests in rid
    order.  ``audit=True`` checks ``engine.audit()`` after every step
    and raises on a violation.
    """
    reqs = trace.requests()
    i = 0
    for _ in range(max_steps):
        while i < len(reqs) and \
                trace.entries[i].arrival_step <= engine.step_count:
            engine.submit(reqs[i])
            i += 1
        busy = engine.step()
        if audit:
            errs = engine.audit()
            if errs:
                raise AssertionError(f"paging.audit() violations at step "
                                     f"{engine.step_count}: {errs}")
        if i >= len(reqs) and not busy and not engine.queue \
                and not engine.requeue:
            return reqs
    raise AssertionError(
        f"trace replay did not drain within {max_steps} steps "
        f"({i}/{len(reqs)} submitted): "
        f"{engine.stats() if hasattr(engine, 'stats') else ''}")


def _main(argv: Optional[Iterable[str]] = None) -> None:
    """Freeze a trace:  python -m repro_torch.serve.workload \
         --out build/bursty.jsonl --n 36 \
         --kind gamma --rate 0.8 --burstiness 4 --seed 0"""
    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--out", required=True, help="JSONL trace path")
    ap.add_argument("--n", type=int, default=36, help="requests to sample")
    ap.add_argument("--kind", default="gamma", choices=list(ARRIVAL_KINDS))
    ap.add_argument("--rate", type=float, default=0.8,
                    help="mean arrivals per engine step")
    ap.add_argument("--burstiness", type=float, default=4.0,
                    help="gamma squared-CV (>1 = clumpy; poisson ignores)")
    ap.add_argument("--vocab-size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(list(argv) if argv is not None else None)
    spec = WorkloadSpec(
        arrival=ArrivalProcess(kind=args.kind, rate=args.rate,
                               burstiness=args.burstiness),
        vocab_size=args.vocab_size, seed=args.seed)
    trace = generate_trace(spec, args.n)
    trace.save(args.out)
    by_cls = {c: sum(1 for e in trace.entries if e.cls == c)
              for c in trace.classes_present()}
    span = trace.entries[-1].arrival_step if trace.entries else 0
    print(f"froze {len(trace.entries)} requests over {span} steps "
          f"({args.kind} rate={args.rate}) to {args.out}: {by_cls}")


if __name__ == "__main__":
    _main()
