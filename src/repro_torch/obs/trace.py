"""Request tracing: ring-buffered spans threaded through the counting stack.

The serve layer's counters (:mod:`repro_torch.serve.metrics`) answer "how
much"; they cannot answer "where did *this* query's 40 ms go".  A
:class:`Tracer` records **spans** — named intervals with monotonic
``(t0, t1)`` timestamps, a trace id shared by everything one request
touched, and a parent link — into a fixed-capacity ring buffer
(:class:`collections.deque`), so a traced flood reconstructs, per query,
the full path service queue → bucket execution → executor dispatch →
cache install, and a discovery run its search rounds.

Spans are host-clock intervals, stamped on the clock of a
``torch.profiler`` trace: seconds since the epoch (the trace's events
carry nanoseconds since the epoch), read as ``time.perf_counter()`` plus
one offset anchored when the tracer starts, so a span's interval holds
the trace's events of the work inside it.  On the CUDA card a launch
returns before its kernel ends, so a span around launches times their
enqueueing unless the code inside it synchronises; the counting service
ends each batch with a synchronisation, so its ``service.exec`` spans
hold the card's time.  A span never synchronises: the device's time comes
from the profiler's trace.

Design constraints, in order:

* **Off is free.**  The default tracer is :data:`NULL_TRACER`; its
  ``span()`` hands back one shared no-op context manager and its
  ``event()``/``record()`` return immediately.  Hot paths that would pay
  even for building the ``attrs`` dict guard with ``tracer.enabled``.
* **On is cheap.**  Recording a span is one ``deque.append`` of a slotted
  record (appends are atomic under CPython, so the hot path takes no
  lock); the ring bounds memory and old spans simply fall off.
* **Cross-thread by value.**  A span's :class:`SpanContext` is a plain
  ``(trace_id, span_id)`` pair; code that hands work to another thread
  (the service queue) stores the context on the work item and the
  executing side parents its spans on it explicitly.
  Same-thread nesting is implicit via a thread-local span stack.
* **Retroactive spans.**  Queue residency is only known when the entry is
  drained; :meth:`Tracer.record` writes a span from ``time.perf_counter()``
  readings captured earlier (moved onto the trace's clock as it records
  them), so no span object needs to live across threads.

Enable per service via the ``tracer=`` knob (or
``CountingService.set_tracer``), or
process-wide with the ``REPRO_TRACE`` environment variable (any value
other than ``"" / "0"``; an integer sets the ring capacity), which
:func:`default_tracer` resolves at construction time.  A discovery
records into :func:`repro_torch.obs.profile.profiled_tracer` while a
``torch.profiler`` session records (:mod:`repro_torch.obs.profile`).

Usage::

    tracer = Tracer(capacity=65536)
    with tracer.span("client.submit", mode="batch") as sp:
        ctx = sp.context                     # hand to another thread
    tracer.record("service.queue", t0, t1, parent=ctx)
    trees = tracer.trees()                   # per-trace nested span trees
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Dict, List, NamedTuple, Optional, Sequence

from .slowlog import SlowQueryLog

__all__ = ["SpanContext", "SpanRecord", "Span", "Tracer", "NullTracer",
           "NULL_TRACER", "default_tracer", "build_trees"]

_ids = itertools.count(1)          # span ids; next() is atomic in CPython
_trace_ids = itertools.count(1)


class SpanContext(NamedTuple):
    """The by-value identity of a span — what crosses thread boundaries."""
    trace_id: int
    span_id: int


class SpanRecord:
    """One finished span in the ring (slotted: a traced flood records
    thousands of these)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "t0", "t1",
                 "attrs", "thread")

    def __init__(self, trace_id: int, span_id: int, parent_id: Optional[int],
                 name: str, t0: float, t1: float, attrs: Optional[dict],
                 thread: str):
        self.trace_id, self.span_id, self.parent_id = (trace_id, span_id,
                                                       parent_id)
        self.name, self.t0, self.t1 = name, t0, t1
        self.attrs, self.thread = attrs, thread

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def as_dict(self) -> dict:
        return dict(trace_id=self.trace_id, span_id=self.span_id,
                    parent_id=self.parent_id, name=self.name,
                    t0=round(self.t0, 6), t1=round(self.t1, 6),
                    duration_s=round(self.duration_s, 6),
                    thread=self.thread,
                    attrs={k: (v if isinstance(v, (int, float, bool,
                                                   type(None))) else str(v))
                           for k, v in (self.attrs or {}).items()})

    def __repr__(self) -> str:       # pragma: no cover - debugging aid
        return (f"SpanRecord({self.name!r}, trace={self.trace_id}, "
                f"span={self.span_id}, parent={self.parent_id}, "
                f"dur={self.duration_s * 1e3:.3f}ms)")


class _NullSpan:
    """Shared no-op span: the entire cost of disabled tracing at a call
    site is one method call returning this singleton."""

    __slots__ = ()
    context = None

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """A live span (context manager).  Created by :meth:`Tracer.span`;
    the record is appended to the ring on ``__exit__`` — which the
    ``with`` statement guarantees, so every started span closes."""

    __slots__ = ("_tracer", "name", "attrs", "trace_id", "span_id",
                 "parent_id", "t0", "t1", "_pushed")

    def __init__(self, tracer: "Tracer", name: str,
                 parent: Optional[SpanContext], attrs: dict):
        self._tracer = tracer
        self.name, self.attrs = name, attrs
        self.span_id = next(_ids)
        if parent is not None:
            self.trace_id, self.parent_id = parent.trace_id, parent.span_id
        else:
            top = tracer._current()
            if top is not None:
                self.trace_id, self.parent_id = top.trace_id, top.span_id
            else:
                self.trace_id, self.parent_id = next(_trace_ids), None
        self.t0 = self.t1 = 0.0
        self._pushed = False

    @property
    def context(self) -> SpanContext:
        return SpanContext(self.trace_id, self.span_id)

    def set(self, **attrs) -> None:
        """Attach attributes after the fact (e.g. a batch's size is only
        known once the queue drained)."""
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        self._tracer._push(self)
        self._pushed = True
        self.t0 = time.perf_counter() + self._tracer.offset
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter() + self._tracer.offset
        if self._pushed:
            self._tracer._pop(self)
        self._tracer._append(SpanRecord(
            self.trace_id, self.span_id, self.parent_id, self.name,
            self.t0, self.t1, self.attrs or None,
            threading.current_thread().name))
        return False


class NullTracer:
    """The off switch: every operation is a no-op returning a shared
    object.  ``enabled`` lets the hottest call sites (cache gets) skip
    even the argument packing."""

    enabled = False
    slow: Optional[SlowQueryLog] = None

    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attrs) -> _NullSpan:
        return NULL_SPAN

    def event(self, name: str, parent: Optional[SpanContext] = None,
              **attrs) -> None:
        return None

    def record(self, name: str, t0: float, t1: float,
               parent: Optional[SpanContext] = None,
               **attrs) -> Optional[SpanContext]:
        return None

    def current(self) -> _NullSpan:
        return NULL_SPAN

    def records(self) -> List[SpanRecord]:
        return []

    def traces(self) -> Dict[int, List[SpanRecord]]:
        return {}

    def trees(self) -> List[dict]:
        return []

    def clear(self) -> None:
        return None

    def snapshot(self) -> dict:
        return dict(enabled=False, recorded=0, resident=0, dropped=0)


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Ring-buffered span recorder.

    Args:
        capacity: ring size in spans; the oldest fall off (``dropped``
            counts them).
        slow_threshold_s: end-to-end latency above which a query lands in
            the slow-query log (``None`` keeps the log but disables
            automatic offers from the serve layer's e2e observation
            points).
        slow_k: slow-query log size (top-K by duration).

    Usage::

        tracer = Tracer()
        with tracer.span("work", queries=8):
            ...
        assert tracer.records()[-1].name == "work"
    """

    enabled = True

    def __init__(self, capacity: int = 65536,
                 slow_threshold_s: Optional[float] = 0.05,
                 slow_k: int = 32):
        self.capacity = capacity
        self._ring: "deque[SpanRecord]" = deque(maxlen=capacity)
        self._local = threading.local()
        self.recorded = 0              # total appends (ring may have fewer)
        self.slow = SlowQueryLog(threshold_s=slow_threshold_s, top_k=slow_k)
        self._anchor()

    def _anchor(self) -> None:
        """Tie ``time.perf_counter()`` to the trace's clock (seconds since
        the epoch) by one pair of readings: ``offset`` is added to every
        stamp."""
        pc, epoch = time.perf_counter_ns(), time.time_ns()
        self.offset = (epoch - pc) / 1e9

    # -- recording ----------------------------------------------------------
    def span(self, name: str, parent: Optional[SpanContext] = None,
             **attrs) -> Span:
        """A live span context manager.  ``parent=None`` nests under the
        current thread's innermost open span (or starts a new trace);
        pass an explicit :class:`SpanContext` to link across threads."""
        return Span(self, name, parent, attrs)

    def event(self, name: str, parent: Optional[SpanContext] = None,
              **attrs) -> None:
        """A zero-duration span — cache hits/misses/evictions, flush
        triggers: things that happen *at* a time rather than *over* one."""
        now = time.perf_counter()
        self.record(name, now, now, parent=parent, **attrs)

    def record(self, name: str, t0: float, t1: float,
               parent: Optional[SpanContext] = None,
               **attrs) -> SpanContext:
        """Retroactive span from ``time.perf_counter()`` readings captured
        earlier (queue residency is only known at drain time), recorded on
        the trace's clock.  Returns the new span's context so children can
        parent on it."""
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            top = self._current()
            if top is not None:
                trace_id, parent_id = top.trace_id, top.span_id
            else:
                trace_id, parent_id = next(_trace_ids), None
        span_id = next(_ids)
        self._append(SpanRecord(trace_id, span_id, parent_id, name,
                                t0 + self.offset, t1 + self.offset,
                                attrs or None,
                                threading.current_thread().name))
        return SpanContext(trace_id, span_id)

    def _append(self, rec: SpanRecord) -> None:
        self._ring.append(rec)         # deque append: atomic, no lock
        self.recorded += 1

    # -- implicit same-thread nesting ---------------------------------------
    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _current(self) -> Optional[Span]:
        st = getattr(self._local, "stack", None)
        return st[-1] if st else None

    def current(self):
        """This thread's innermost open span (:data:`NULL_SPAN` if none),
        so a callee can ``set`` on its caller's span what only it learns."""
        top = self._current()
        return top if top is not None else NULL_SPAN

    def _push(self, span: Span) -> None:
        self._stack().append(span)

    def _pop(self, span: Span) -> None:
        st = self._stack()
        if st and st[-1] is span:
            st.pop()
        elif span in st:               # tolerate exotic exit orders
            st.remove(span)

    # -- analysis -----------------------------------------------------------
    def records(self) -> List[SpanRecord]:
        """Snapshot of the resident spans, oldest first."""
        return list(self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self.recorded = 0
        self.slow.clear()
        self._anchor()

    def traces(self) -> Dict[int, List[SpanRecord]]:
        """Resident spans grouped by trace id (each list sorted by t0)."""
        out: Dict[int, List[SpanRecord]] = {}
        for rec in self.records():
            out.setdefault(rec.trace_id, []).append(rec)
        for recs in out.values():
            recs.sort(key=lambda r: (r.t0, r.span_id))
        return out

    def trees(self) -> List[dict]:
        """Per-trace nested span trees (see :func:`build_trees`)."""
        return build_trees(self.records())

    def snapshot(self) -> dict:
        """JSON-able tracer health: ring occupancy + slow-query log."""
        resident = len(self._ring)
        return dict(enabled=True, capacity=self.capacity,
                    recorded=self.recorded, resident=resident,
                    dropped=self.recorded - resident,
                    traces=len({r.trace_id for r in self._ring}),
                    slow_queries=self.slow.as_dicts())


def build_trees(records: Sequence[SpanRecord]) -> List[dict]:
    """Nest span records into per-trace trees.

    Args:
        records: any iterable of :class:`SpanRecord` (ring snapshot).

    Returns:
        One dict per trace — ``{"trace_id", "spans", "roots": [...]}``
        where each node is the span's :meth:`~SpanRecord.as_dict` plus a
        ``children`` list (sorted by ``t0``).  A span whose parent fell
        off the ring is promoted to a root (the tree stays complete).

    Usage::

        trees = build_trees(tracer.records())
    """
    by_trace: Dict[int, List[SpanRecord]] = {}
    for rec in records:
        by_trace.setdefault(rec.trace_id, []).append(rec)
    out: List[dict] = []
    for trace_id in sorted(by_trace):
        recs = by_trace[trace_id]
        nodes = {r.span_id: dict(r.as_dict(), children=[]) for r in recs}
        roots: List[dict] = []
        for r in sorted(recs, key=lambda r: (r.t0, r.span_id)):
            node = nodes[r.span_id]
            parent = nodes.get(r.parent_id) if r.parent_id else None
            (parent["children"] if parent is not None else roots).append(node)
        out.append(dict(trace_id=trace_id, spans=len(recs), roots=roots))
    return out


def default_tracer() -> NullTracer:
    """The process-default tracer, resolved from ``REPRO_TRACE``:

    * unset / ``""`` / ``"0"`` → :data:`NULL_TRACER` (free);
    * an integer > 1 → a :class:`Tracer` with that ring capacity;
    * anything else truthy → a :class:`Tracer` with the default capacity.

    ``REPRO_TRACE_SLOW_MS`` sets the slow-query threshold (default 50).

    Usage::

        svc = CountingService(engine)          # tracer=default_tracer()
    """
    raw = os.environ.get("REPRO_TRACE", "").strip()
    if raw in ("", "0"):
        return NULL_TRACER
    slow_ms = float(os.environ.get("REPRO_TRACE_SLOW_MS", "50") or 50)
    capacity = int(raw) if raw.isdigit() and int(raw) > 1 else 65536
    return Tracer(capacity=capacity, slow_threshold_s=slow_ms / 1e3)
