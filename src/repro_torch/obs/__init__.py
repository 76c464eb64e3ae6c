"""Observability for the port's counting stack: tracing, percentiles, export.

Three pieces, each usable alone:

* :mod:`repro_torch.obs.trace` — ring-buffered request tracing with a free
  no-op default (:data:`NULL_TRACER`) and the ``REPRO_TRACE`` env knob;
* :mod:`repro_torch.obs.hist` — fixed-bucket log-scale latency histograms
  whose merge is exactly associative (p50/p95/p99 + max);
* :mod:`repro_torch.obs.registry` — Prometheus-text / JSON rendering of
  snapshots, plus :mod:`repro_torch.obs.slowlog` (top-K slow queries) and
  :mod:`repro_torch.obs.profile` (the process-wide tracer a discovery
  records into while a ``torch.profiler`` session records).

This package imports nothing from :mod:`repro_torch.core` or
:mod:`repro_torch.serve`, so every layer of the stack can depend on it.
"""

from .hist import CountHistogram, LatencyHistogram, N_BUCKETS
from .profile import profiled_tracer
from .registry import MetricsRegistry, prometheus_lines
from .slowlog import SlowQuery, SlowQueryLog
from .trace import (NULL_TRACER, NullTracer, Span, SpanContext, SpanRecord,
                    Tracer, build_trees, default_tracer)

__all__ = [
    "CountHistogram", "LatencyHistogram", "N_BUCKETS",
    "profiled_tracer",
    "MetricsRegistry", "prometheus_lines",
    "SlowQuery", "SlowQueryLog",
    "NULL_TRACER", "NullTracer", "Span", "SpanContext", "SpanRecord",
    "Tracer", "build_trees", "default_tracer",
]
