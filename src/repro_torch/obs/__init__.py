"""Observability for the port's counting stack.

* :mod:`repro_torch.obs.hist` — fixed-bucket log-scale latency histograms
  (p50/p95/p99 + max);
* :mod:`repro_torch.obs.trace` — the no-op :data:`NULL_TRACER` the core is
  wired against;
* :mod:`repro_torch.obs.profile` — :func:`annotate`, named regions on the
  ``torch.profiler`` timeline.

This package imports nothing from :mod:`repro_torch.core`, so every layer
of the stack can depend on it.
"""

from .hist import LatencyHistogram, N_BUCKETS
from .profile import annotate
from .trace import NULL_TRACER, NullTracer

__all__ = ["LatencyHistogram", "N_BUCKETS", "annotate",
           "NULL_TRACER", "NullTracer"]
