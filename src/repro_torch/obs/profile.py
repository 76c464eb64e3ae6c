"""Spans while ``torch.profiler`` records: one process-wide tracer.

A profiled run's trace holds the card's kernels and copies and the host's
CUDA runtime calls, but not which of the program's steps was running
while the card sat idle.  While a ``torch.profiler`` session records, a
discovery (:func:`~repro_torch.core.search.discover_model`) therefore
records its spans into :func:`profiled_tracer`, one ring for the whole
process, stamped on the trace's own clock (:mod:`repro_torch.obs.trace`),
so the two line up by time: the spans name the host's work, the trace
gives the device's.  With no session recording a discovery takes
:data:`~repro_torch.obs.trace.NULL_TRACER` and pays one flag check.

Read the spans after the profiled window::

    with torch.profiler.profile(activities=[ProfilerActivity.CUDA]):
        discover_model(db, strategy)
    spans = profiled_tracer().records()     # discover.run, exec.hop, ...

The spans and what each covers are listed in ``README.md``'s observability
section; ``perfbench/spans.py`` reads their self times and which span was
innermost while the card was idle.
"""

from __future__ import annotations

import gc
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

from .trace import NullTracer, Tracer

__all__ = ["PROFILED_CAPACITY", "profiling", "profiled_tracer", "gc_spans"]

#: Ring of the profiled tracer, in spans: four times what the benchmark's
#: 51 s window records at IMDb's scale (about 140 discoveries of 455
#: spans on an H100; VisualGenome's about 18 of 1,296).
PROFILED_CAPACITY = 1 << 18

_PROFILED: Optional[Tracer] = None
_LOCK = threading.Lock()


def profiling() -> bool:
    """Is a ``torch.profiler`` session recording (its active step)?"""
    from torch.autograd import profiler
    return profiler._is_profiler_enabled


def profiled_tracer() -> Tracer:
    """The process-wide tracer that profiled discoveries record into,
    made on first use, with a ring of :data:`PROFILED_CAPACITY` spans."""
    global _PROFILED
    if _PROFILED is None:
        with _LOCK:
            if _PROFILED is None:
                _PROFILED = Tracer(capacity=PROFILED_CAPACITY,
                                   slow_threshold_s=None)
    return _PROFILED


_gc_open = 0                       # open gc_spans blocks
_gc_started: dict = {}             # thread id -> the collection's start


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: each collection a ``host.gc`` span."""
    key = threading.get_ident()
    if phase == "start":
        _gc_started[key] = time.perf_counter()
    else:
        t0 = _gc_started.pop(key, None)
        if t0 is not None and _PROFILED is not None:
            _PROFILED.record("host.gc", t0, time.perf_counter(),
                             generation=info.get("generation"))


@contextmanager
def _gc_recorded():
    global _gc_open
    with _LOCK:
        if _gc_open == 0:
            gc.callbacks.append(_on_gc)
        _gc_open += 1
    try:
        yield
    finally:
        with _LOCK:
            _gc_open -= 1
            if _gc_open == 0:
                gc.callbacks.remove(_on_gc)


def gc_spans(tracer: NullTracer):
    """``with gc_spans(tracer):`` records each garbage collection inside
    as a ``host.gc`` span (``generation``) of :func:`profiled_tracer`, so
    that idle time which is a collection carries a name; a no-op unless
    ``tracer`` is that tracer."""
    if tracer is None or tracer is not _PROFILED:
        return nullcontext()
    return _gc_recorded()
