"""Observability shared by the serve plane and the kernel layer:
metrics (counters, gauges, log-bucket histograms), the bounded
lifecycle trace ring, and opt-in ``REPRO_PROFILE=1`` dispatch timers."""
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import EVENT_KINDS, Trace, TraceEvent
from repro_torch.obs import profile

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "EVENT_KINDS", "Trace", "TraceEvent", "profile"]
