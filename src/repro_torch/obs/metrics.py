"""Host-side metrics: counters, gauges, fixed-bucket log-spaced
histograms, and the :class:`MetricsRegistry` that names them (a stdlib
copy of ``repro.obs.metrics``).

* **Pure host state.**  Observing a value never touches a device
  tensor: a float compare and a bisect into a precomputed bucket table,
  so metrics sit on the serve loop's commit path without adding a sync
  to the engine's one device-to-host copy per step.
* **No clock reads.**  Callers pass values in, so every metric is a
  pure function of the observed sequence and a replayed run reproduces
  the same registry snapshot.
* **Fixed log-spaced buckets.**  Latencies span five orders of
  magnitude; geometric buckets give constant relative resolution with a
  small fixed table, and fixed bounds let two runs' histograms compare
  bucket by bucket.  A percentile estimate is the geometric midpoint of
  the covering bucket, within one ``factor`` of the exact sample
  percentile.
"""
from __future__ import annotations

import bisect
import json
import math
from typing import Any, Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """A monotonically increasing count."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r}: inc by {n} < 0 "
                             f"(counters are monotonic; use a Gauge)")
        self.value += n

    def snapshot(self) -> int:
        return self.value


class Gauge:
    """A point-in-time value (pool pressure, queue depth, peaks)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_max(self, v: float) -> None:
        """High-water-mark update (peak queue depth, peak pages)."""
        self.value = max(self.value, float(v))

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed log-spaced-bucket histogram with percentile estimation.

    Buckets cover ``[lo, hi)`` with geometric boundaries
    ``lo * factor**i`` plus one underflow and one overflow bucket;
    exact ``count``/``sum``/``min``/``max`` ride alongside so the mean
    is exact even though per-sample values are bucketed.
    """

    __slots__ = ("name", "lo", "hi", "factor", "bounds", "counts",
                 "count", "sum", "min", "max")

    def __init__(self, name: str, lo: float = 1e-6, hi: float = 1e3,
                 factor: float = 1.25):
        if not (lo > 0 and hi > lo and factor > 1.0):
            raise ValueError(f"histogram {name!r}: need 0 < lo < hi and "
                             f"factor > 1, got lo={lo} hi={hi} "
                             f"factor={factor}")
        self.name = name
        self.lo, self.hi, self.factor = float(lo), float(hi), float(factor)
        n = int(math.ceil(math.log(hi / lo) / math.log(factor)))
        self.bounds = [lo * factor ** i for i in range(n + 1)]
        # counts[0] = underflow (< lo); counts[i] = [bounds[i-1],
        # bounds[i]); counts[-1] = overflow (>= bounds[-1])
        self.counts = [0] * (n + 2)
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if v < self.bounds[0]:
            idx = 0
        elif v >= self.bounds[-1]:
            idx = len(self.counts) - 1
        else:
            idx = bisect.bisect_right(self.bounds, v)
        self.counts[idx] += 1

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-th percentile (0..100) from the buckets.

        Returns the geometric midpoint of the bucket holding the
        rank-``ceil(q/100 * count)`` sample — within one bucket
        ``factor`` of the exact sample percentile.  Underflow/overflow
        buckets return the exactly-tracked min/max.  ``None`` when
        empty.
        """
        if self.count == 0:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        target = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, n in enumerate(self.counts):
            seen += n
            if seen >= target:
                if i == 0:
                    return self.min
                if i == len(self.counts) - 1:
                    return self.max
                return math.sqrt(self.bounds[i - 1] * self.bounds[i])
        return self.max  # unreachable; defensive

    @property
    def mean(self) -> Optional[float]:
        return self.sum / self.count if self.count else None

    def snapshot(self) -> Dict[str, Any]:
        return {"count": self.count, "sum": self.sum,
                "min": self.min, "max": self.max, "mean": self.mean,
                "p50": self.percentile(50), "p90": self.percentile(90),
                "p99": self.percentile(99)}


class MetricsRegistry:
    """Named counters/gauges/histograms with get-or-create semantics.

    The serve engine's :meth:`~repro_torch.serve.engine.Engine.stats`
    reads from one of these; the profiling hooks
    (:mod:`repro_torch.obs.profile`) aggregate into another.  A name maps to
    exactly one metric type — re-requesting it with a different type
    raises instead of silently shadowing.
    """

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls, *args, **kwargs):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, *args, **kwargs)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested "
                            f"{cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = 1e-6, hi: float = 1e3,
                  factor: float = 1.25) -> Histogram:
        return self._get(name, Histogram, lo, hi, factor)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict dump: {"counters": {...}, "gauges": {...},
        "histograms": {...}} — JSON-serializable as-is."""
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {},
                                          "histograms": {}}
        for name in self.names():
            m = self._metrics[name]
            kind = {Counter: "counters", Gauge: "gauges",
                    Histogram: "histograms"}[type(m)]
            out[kind][name] = m.snapshot()
        return out

    def export(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
            f.write("\n")
