"""Host-side counters and gauges named by a :class:`MetricsRegistry`
(a stdlib copy of the parts of ``repro.obs.metrics`` the engine uses;
histograms arrive with the telemetry slice).

Pure host state: observing a value never touches a device tensor, so
metrics can sit on the serve loop's commit path without adding a sync.
"""
from __future__ import annotations

from typing import Any, Dict

__all__ = ["Counter", "Gauge", "MetricsRegistry"]


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
    """A point-in-time value (queue depth, peaks)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set_max(self, v: float) -> None:
        """High-water-mark update."""
        self.value = max(self.value, float(v))

    def snapshot(self) -> float:
        return self.value


class MetricsRegistry:
    """Named counters/gauges with get-or-create semantics; a name maps
    to exactly one metric type."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get(self, name: str, cls):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def snapshot(self) -> Dict[str, Any]:
        """{"counters": {...}, "gauges": {...}}, JSON-serializable."""
        out: Dict[str, Dict[str, Any]] = {"counters": {}, "gauges": {}}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            kind = "counters" if isinstance(m, Counter) else "gauges"
            out[kind][name] = m.snapshot()
        return out
