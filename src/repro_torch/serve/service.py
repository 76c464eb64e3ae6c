"""CountingService: a query-serving front-end for the counting engine.

FACTORBASE answers instantiation counts as database *queries*; this module
treats them the same way at scale.  A :class:`CountingService` accepts many
concurrent positive-count queries — from one structure search, several
searches sharing a database, or external clients on their own threads —
and executes them in **signature-bucketed micro-batches** against one
shared byte-budgeted :class:`~repro_torch.core.cache.CtCache`:

* ``submit(point, keep)`` returns a :class:`CountTicket` immediately.
  Queries already resident in the cache short-circuit without queueing;
  identical in-flight queries are coalesced onto one pending entry.
* ``submit_complete(point, keep)`` queues a **complete-CT** query
  (positive + Möbius negative phase, ``keep`` may include relationship
  indicator axes).  Complete queries ride the same scheduler; dispatch
  batches their positive sub-queries in signature buckets AND their
  negative-phase butterfly transforms in same-shape groups
  (:func:`~repro_torch.serve.batching.execute_complete_bucketed`).
* Pending queries are bucketed by
  :meth:`~repro_torch.core.plan.ContractionPlan.shape_signature`.  A bucket is
  dispatched when it reaches ``max_batch_size``, when the oldest pending
  query exceeds ``max_wait_s``, when backpressure demands it, or when a
  caller blocks on a ticket — whichever comes first.
* Dispatch goes through :func:`~repro_torch.serve.batching.execute_bucketed`,
  which stacks structurally identical plans into one flattened
  evaluation each (:meth:`~repro_torch.core.executors.Executor.positive_batch`:
  one K1/K2 launch per hop step of a stack group on the card).
* **Backpressure**: the queue is bounded by ``max_in_flight`` queries and
  by the estimated bytes of pending results (default: the cache budget);
  exceeding either limit drains the queue instead of growing it.
* **Dispatcher thread** (:meth:`CountingService.start`, or
  ``dispatcher=True``): a dedicated scheduler thread that fires the
  ``max_wait_s`` deadline *without* requiring a subsequent submit — the
  asynchronous front-end a real service needs.  :meth:`CountingService
  .shutdown` stops it and either drains the queue or fails every pending
  waiter with :class:`ServiceShutdown` (no ticket is ever left hanging).

Locking: the queue lock only guards scheduler state — triggered batches
execute *after* it is released, so submits keep flowing while a batch
runs; one execution lock serialises engine/cache mutation across client
threads (the cache itself is also lock-guarded for its other users).

On the CUDA card every batch runs on the engine's device and its current
(default) stream, whichever thread executes it, and ends with a
synchronisation: a settled ticket's table is computed, so a client thread
reads it with no event of its own, and every latency the service records
(queue wait, bucket execution, end to end) is the card's, not the time it
took to enqueue launches.

Results land in the engine's cache under the same keys the on-demand
positive policy uses, so a structure search sharing the engine is served
directly from the warmed cache; :meth:`CountingService.prefetch` runs the
same machinery for an explicit policy (see
:meth:`repro_torch.core.strategies.Strategy.family_ct_many`).
"""

from __future__ import annotations

import asyncio
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.cache import DEFAULT_TENANT
from ..core.ct import CtTable
from ..core.device import synchronize
from ..core.engine import CountingEngine, DeltaReport, OnDemandPositives
from ..core.plan import ContractionPlan
from ..core.variables import CtVar, LatticePoint
from ..obs.trace import NullTracer, SpanContext, default_tracer
from .batching import execute_bucketed, execute_complete_bucketed
from .metrics import ServiceMetrics

Sink = Callable[[LatticePoint, Tuple[CtVar, ...], CtTable], None]


class ServiceShutdown(RuntimeError):
    """The service was shut down: raised by new submits after
    :meth:`CountingService.shutdown`, and propagated to every waiter whose
    query was still pending when a non-draining shutdown ran."""


class TenantAdmissionError(RuntimeError):
    """A submit was rejected by per-tenant admission control: the tenant
    already has ``admission_max`` queries pending and its policy is
    ``"shed"``.  The client should back off and retry; other tenants'
    services are unaffected."""


class _TokenBucket:
    """Per-tenant token bucket: ``capacity`` tokens, refilled continuously
    at ``capacity / window_s`` tokens per second.  One token buys one
    *admitted* query (cache hits and coalesces are free — they cost the
    pool nothing).  Thread-safe; the clock is injectable for tests."""

    def __init__(self, capacity: int, window_s: float,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 1:
            raise ValueError("rate_limit capacity must be >= 1")
        if window_s <= 0:
            raise ValueError("rate_limit window must be > 0 seconds")
        self.capacity = float(capacity)
        self.rate = capacity / float(window_s)
        self.clock = clock
        self._tokens = float(capacity)
        self._stamp = clock()
        self._lock = threading.Lock()

    def acquire(self) -> float:
        """Take one token if available.

        Returns:
            ``0.0`` on success, else the seconds until a token will have
            accrued (no token is consumed on failure).
        """
        with self._lock:
            now = self.clock()
            self._tokens = min(self.capacity, self._tokens
                               + (now - self._stamp) * self.rate)
            self._stamp = now
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return 0.0
            return (1.0 - self._tokens) / self.rate


class _Pending:
    """One in-flight query: a compiled plan plus everyone waiting on it."""

    __slots__ = ("point", "keep", "plan", "sig", "complete", "sinks",
                 "cache_result", "enqueued_at", "event", "result", "error",
                 "callbacks", "trace_ctx")

    def __init__(self, point: LatticePoint, keep: Tuple[CtVar, ...],
                 plan: ContractionPlan, complete: bool = False):
        self.point, self.keep, self.plan = point, keep, plan
        self.complete = complete
        # complete-CT buckets never mix with positive buckets, even when
        # the output shapes coincide: the execution semantics differ
        self.sig = ("complete" if complete else "pos",
                    plan.shape_signature())
        self.sinks: List[Sink] = []
        self.cache_result = False      # a sink-less client wants it cached
        self.enqueued_at = time.perf_counter()
        self.event = threading.Event()
        self.result: Optional[CtTable] = None
        self.error: Optional[BaseException] = None
        # parent span for this query's service-side spans: set from the
        # submitter's trace context (e.g. a client's request span), then
        # re-pointed at the queue-residency span once drained
        self.trace_ctx: Optional[SpanContext] = None
        # fired (once each) after the event is set: the asyncio bridge —
        # waiters that cannot block a thread park a loop.call_soon_threadsafe
        # hook here instead (callbacks must be idempotent: the
        # append-then-check handshake in settle/on_settled may run one twice)
        self.callbacks: List[Callable[[], None]] = []

    def settle(self) -> None:
        """Mark done and wake every waiter — threads via the event,
        asyncio waiters via their callbacks."""
        self.event.set()
        for cb in list(self.callbacks):
            try:
                cb()
            except Exception:          # noqa: BLE001 — a dead event loop
                pass                   # must not break sibling waiters

    def on_settled(self, cb: Callable[[], None]) -> None:
        """Register an idempotent done-callback; fires immediately if the
        entry already settled (append-then-check closes the race with a
        concurrent :meth:`settle`)."""
        self.callbacks.append(cb)
        if self.event.is_set():
            cb()


class CountTicket:
    """Handle for a submitted query; ``result()`` blocks (flushing the
    service if needed) until the count table is available.

    Usage::

        ticket = service.submit(point)
        tab = ticket.result(timeout=30.0)
    """

    def __init__(self, service: "CountingService",
                 entry: Optional[_Pending] = None,
                 result: Optional[CtTable] = None):
        self._service = service
        self._entry = entry
        self._result = result

    @property
    def done(self) -> bool:
        return self._result is not None or (
            self._entry is not None and self._entry.event.is_set())

    def result(self, timeout: Optional[float] = None) -> CtTable:
        """The count table for this query.

        Args:
            timeout: seconds to wait after flushing (None = forever).

        Returns:
            The positive :class:`~repro_torch.core.ct.CtTable` over the query's
            ``keep`` axes.

        Raises:
            TimeoutError: the query did not complete within ``timeout``.
            BaseException: whatever the executing batch raised — every
                waiter of a failed batch sees the same exception.
        """
        if self._result is not None:
            return self._result
        assert self._entry is not None
        if not self._entry.event.is_set():
            self._service.flush()          # our entry may ride this drain …
            if not self._entry.event.wait(timeout):   # … or a concurrent one
                raise TimeoutError("count query did not complete in time")
        if self._entry.error is not None:  # execution failed: every waiter
            raise self._entry.error        # sees the batch's exception
        self._result = self._entry.result
        return self._result

    async def aresult(self) -> CtTable:
        """Asyncio-native :meth:`result`: awaits the count table without
        blocking the event loop.

        With the dispatcher thread running, completion is event-driven —
        a done-callback wakes the awaiting task via
        ``loop.call_soon_threadsafe``, so thousands of concurrent awaiters
        cost no threads.  Without a dispatcher, the blocking ``result()``
        (which flushes the queue) runs in the loop's default thread-pool
        executor instead.

        Usage::

            tab = await service.submit(point).aresult()
        """
        if self._result is not None:
            return self._result
        entry = self._entry
        assert entry is not None
        loop = asyncio.get_running_loop()
        if not (self._service.running
                and self._service.max_wait_s is not None):
            # nothing will fire the batch on its own: drive the blocking
            # flush+wait path off-loop instead of parking forever
            return await loop.run_in_executor(None, self.result)
        fut: "asyncio.Future[CtTable]" = loop.create_future()

        def settle() -> None:          # runs on the loop
            if fut.done():
                return
            if entry.error is not None:
                fut.set_exception(entry.error)
            else:
                fut.set_result(entry.result)

        entry.on_settled(lambda: loop.call_soon_threadsafe(settle))
        self._result = await fut
        return self._result


class CountingService:
    """Signature-bucketed micro-batching scheduler over a
    :class:`~repro_torch.core.engine.CountingEngine`.

    Args:
        engine: the planner/executor/cache stack to execute against.
        max_batch_size: dispatch a signature bucket at this many queries.
        max_wait_s: dispatch everything once the oldest pending query is
            this stale.  Checked on submit; with the dispatcher thread
            running (:meth:`start` / ``dispatcher=True``) the deadline
            fires on its own, no submit needed.  ``None`` disables the
            trigger.
        max_in_flight: backpressure — force a full drain beyond this many
            pending queries.
        max_pending_bytes: backpressure — force a full drain beyond this
            many estimated result bytes pending (defaults to the engine's
            cache budget).
        dispatcher: start the dispatcher thread immediately (equivalent
            to calling :meth:`start` after construction).
        use_butterfly: Möbius evaluation order for complete-CT queries
            (see :func:`~repro_torch.core.mobius.complete_ct`).
        metrics: counters sink; defaults to a fresh
            :class:`~repro_torch.serve.metrics.ServiceMetrics`.
        tracer: request tracer wired through the service, its engine,
            executor, and cache (see :mod:`repro_torch.obs.trace`); defaults to
            :func:`~repro_torch.obs.trace.default_tracer` — the free no-op
            tracer unless the ``REPRO_TRACE`` env var enables one.
        tenant: the logical database this service fronts (stamped on
            stats snapshots and trace spans; the default keeps single-DB
            deployments tenant-blind).
        admission_max: per-tenant admission bound — the most queries this
            tenant may have pending at once, ON TOP of the pool-level
            ``max_in_flight``/byte backpressure (``None`` disables the
            gate).
        admission_policy: what a submit over the bound does — ``"queue"``
            drains the tenant's own queue inline on the flooding thread
            (bounded depth, no rejection), ``"shed"`` raises
            :class:`TenantAdmissionError` (load shedding).
        rate_limit: per-tenant sustained-rate bound as ``(n, window_s)`` —
            a token bucket admitting at most ``n`` NEW queries per
            ``window_s`` seconds with bursts up to ``n`` (``None``
            disables it).  Cache hits and coalesces are free.  Over-rate
            submits follow ``admission_policy``: ``"shed"`` raises
            :class:`TenantAdmissionError`, ``"queue"`` sleeps the
            flooding thread (off-lock) until a token accrues.

    Raises:
        ValueError: ``max_batch_size < 1``, an unknown
            ``admission_policy``, or a non-positive ``rate_limit``.

    Usage::

        svc = CountingService(CountingEngine(db, "sparse"), max_batch_size=32)
        tab = svc.count(point)
    """

    def __init__(self, engine: CountingEngine,
                 max_batch_size: int = 64,
                 max_wait_s: Optional[float] = None,
                 max_in_flight: int = 1024,
                 max_pending_bytes: Optional[int] = None,
                 dispatcher: bool = False,
                 use_butterfly: bool = True,
                 metrics: Optional[ServiceMetrics] = None,
                 tracer: Optional[NullTracer] = None,
                 tenant: str = DEFAULT_TENANT,
                 admission_max: Optional[int] = None,
                 admission_policy: str = "queue",
                 rate_limit: Optional[Tuple[int, float]] = None):
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if admission_policy not in ("queue", "shed"):
            raise ValueError(f"unknown admission_policy "
                             f"{admission_policy!r} (queue|shed)")
        self.engine = engine
        self.tenant = tenant
        self.admission_max = admission_max
        self.admission_policy = admission_policy
        self.rate_limit = rate_limit
        self._rate_bucket = (_TokenBucket(*rate_limit)
                             if rate_limit is not None else None)
        self.max_batch_size = max_batch_size
        self.max_wait_s = max_wait_s
        self.max_in_flight = max_in_flight
        self.max_pending_bytes = (max_pending_bytes if max_pending_bytes
                                  is not None else engine.cache.budget_bytes)
        self.use_butterfly = use_butterfly
        self.metrics = metrics if metrics is not None else ServiceMetrics()
        self.set_tracer(tracer if tracer is not None else default_tracer())
        self._lock = threading.RLock()         # queue state
        # execution + cache writes; re-entrant so a caller already holding
        # the fence() can invoke apply_delta without deadlocking on itself
        self._exec_lock = threading.RLock()
        self._wake = threading.Condition(self._lock)  # dispatcher wake-ups
        self._pending: Dict[Tuple, _Pending] = {}
        self._by_sig: Dict[Tuple, List[Tuple]] = {}   # sig -> [req_key]
        self._pending_bytes = 0
        self._policy: Optional[OnDemandPositives] = None  # complete-CT path
        self._dispatcher_thread: Optional[threading.Thread] = None
        self._shut_down = False
        # > 0 suspends the size/deadline triggers while a caller queues a
        # whole flood it flushes itself (defer_drains: the router, the
        # tenant registry)
        self._defer_depth = 0
        self._discovery = None         # lazily built DiscoveryService
        if dispatcher:
            self.start()

    def set_tracer(self, tracer: NullTracer) -> "CountingService":
        """Wire one tracer through the whole stack this service fronts:
        the service itself, its engine (``apply_delta`` spans), the
        engine's executor (dispatch spans), and the shared cache
        (hit/miss/evict events).  Pass :data:`~repro_torch.obs.trace
        .NULL_TRACER` to turn tracing back off.

        Usage::

            svc.set_tracer(Tracer())
        """
        self.tracer = tracer
        eng = self.engine
        eng.tracer = tracer
        eng.executor.tracer = tracer
        eng.cache.tracer = tracer
        return self

    # -- client API ---------------------------------------------------------
    def submit(self, point: LatticePoint,
               keep: Optional[Sequence[CtVar]] = None,
               sink: Optional[Sink] = None,
               trace_ctx: Optional[SpanContext] = None) -> CountTicket:
        """Enqueue one positive-count query; returns immediately.

        With no ``sink`` the result is cached under the engine's on-demand
        positive key (and cache-resident queries short-circuit here); a
        ``sink(point, keep, tab)`` callback routes the result elsewhere
        (e.g. a strategy policy's absorb hook).

        Args:
            point: lattice point to count (>= 1 relationship atom).
            keep: ct-table axes; defaults to every entity/edge attribute
                of the point.
            sink: optional result callback, called during batch execution.
            trace_ctx: parent span context for this query's service-side
                spans — pass the submitter's span to keep the whole
                request in one trace.

        Returns:
            A :class:`CountTicket` (already ``done`` on a cache hit).

        Usage::

            ticket = svc.submit(point, keep)
        """
        plan = self.engine.plan(point, keep)
        return self._enqueue(point, plan.keep, plan, sink, complete=False,
                             trace_ctx=trace_ctx)

    def submit_complete(self, point: LatticePoint,
                        keep: Optional[Sequence[CtVar]] = None,
                        sink: Optional[Sink] = None,
                        trace_ctx: Optional[SpanContext] = None
                        ) -> CountTicket:
        """Enqueue one complete-CT query (positive + Möbius negative
        phase); returns immediately.

        ``keep`` may contain entity-attr axes AND relationship indicator
        axes of the point (edge-attr axes are legal too; they fall back
        to the blockwise Möbius join per query).  The result is cached
        under the same ``"fam"`` key the strategies' :meth:`~repro_torch.core
        .strategies.Strategy.family_ct` uses, so a structure search
        sharing the engine is served from the warmed cache.

        Args:
            point: lattice point to count (>= 1 relationship atom).
            keep: ct-table axes; defaults to every entity/edge attribute
                plus every relationship indicator of the point.
            sink: optional result callback, called during batch execution.

        Returns:
            A :class:`CountTicket` (already ``done`` on a cache hit).

        Usage::

            tab = svc.submit_complete(point, keep).result()
        """
        if keep is None:
            keep = point.all_ct_vars(self.engine.db.schema,
                                     include_rind=True)
        keep_t = tuple(keep)
        plan = self.engine.plan(point, keep_t)   # signature + byte estimate
        return self._enqueue(point, keep_t, plan, sink, complete=True,
                             trace_ctx=trace_ctx)

    def _enqueue(self, point: LatticePoint, keep_t: Tuple[CtVar, ...],
                 plan: ContractionPlan, sink: Optional[Sink],
                 complete: bool,
                 trace_ctx: Optional[SpanContext] = None) -> CountTicket:
        to_execute: List[_Pending] = []
        tr = self.tracer
        counted = False          # the requests counter moves once, not per
        while True:              # rate-limit retry
            retry_in = 0.0
            with self._lock:
                if self._shut_down:
                    raise ServiceShutdown("submit on a shut-down service")
                if not counted:
                    self.metrics.inc(requests=1,
                                     complete_requests=int(complete))
                    counted = True
                if sink is None:
                    cache_key = (self._complete_key(point, keep_t) if complete
                                 else self._cache_key(point, keep_t))
                    hit = self.engine.cache.get(cache_key)
                    if hit is not None:
                        self.metrics.inc(cache_hits=1)
                        return CountTicket(self, result=hit)
                req_key = ("complete" if complete else "pos",
                           point.atoms, keep_t)
                entry = self._pending.get(req_key)
                if entry is not None:
                    if sink is not None:
                        entry.sinks.append(sink)
                    else:
                        entry.cache_result = True
                    self.metrics.inc(coalesced=1)
                    if tr.enabled:
                        tr.event("service.coalesced", parent=trace_ctx,
                                 atoms=point.atoms, tenant=self.tenant)
                    return CountTicket(self, entry=entry)
                # per-tenant rate gate: the token bucket bounds this
                # tenant's SUSTAINED admission rate, on top of the depth
                # bound below.  A failed acquire consumes nothing; the
                # over-rate submit sheds or sleeps per admission_policy.
                if self._rate_bucket is not None:
                    retry_in = self._rate_bucket.acquire()
                    if retry_in > 0.0:
                        self.metrics.inc(rate_limited=1)
                        if self.admission_policy == "shed":
                            self.metrics.inc(shed=1)
                            if tr.enabled:
                                tr.event("service.shed", parent=trace_ctx,
                                         atoms=point.atoms,
                                         tenant=self.tenant,
                                         rate_limit=self.rate_limit)
                            raise TenantAdmissionError(
                                f"tenant {self.tenant!r}: rate limit of "
                                f"{self.rate_limit[0]} queries per "
                                f"{self.rate_limit[1]}s exceeded")
                        if tr.enabled:
                            tr.event("service.rate_limited",
                                     parent=trace_ctx, tenant=self.tenant,
                                     retry_in=retry_in)
                if retry_in > 0.0:
                    # fall through to the off-lock sleep below, then retry
                    # the whole gate sequence (the query may coalesce or
                    # cache-hit by then — both free)
                    pass
                else:
                    ticket, to_execute = self._admit(
                        req_key, point, keep_t, plan, sink, complete,
                        trace_ctx)
            if retry_in == 0.0:
                break
            # "queue" policy, over rate: sleep OFF the lock (other tenants'
            # submits keep flowing), then retry from the top
            time.sleep(retry_in)
        if to_execute:       # run OUTSIDE the lock: submits keep flowing
            self._execute(to_execute)
        return ticket

    def _admit(self, req_key: Tuple, point: LatticePoint,
               keep_t: Tuple[CtVar, ...], plan: ContractionPlan,
               sink: Optional[Sink], complete: bool,
               trace_ctx: Optional[SpanContext]
               ) -> Tuple[CountTicket, List[_Pending]]:
        """Admission gate + queue insertion for one NEW query (queue lock
        held by the caller).  Returns the ticket and whatever the dispatch
        triggers say must now execute (outside the lock)."""
        tr = self.tracer
        # per-tenant admission gate: layered UNDER max_in_flight (which
        # protects the pool) — this bound protects the pool FROM one
        # tenant.  Coalesces and cache hits never consume a slot.
        admission_over = (self.admission_max is not None
                          and len(self._pending) >= self.admission_max)
        if admission_over and self.admission_policy == "shed":
            self.metrics.inc(shed=1)
            if tr.enabled:
                tr.event("service.shed", parent=trace_ctx,
                         atoms=point.atoms, tenant=self.tenant,
                         bound=self.admission_max)
            raise TenantAdmissionError(
                f"tenant {self.tenant!r}: admission bound of "
                f"{self.admission_max} pending queries exceeded")
        entry = _Pending(point, keep_t, plan, complete)
        entry.trace_ctx = trace_ctx
        entry.cache_result = sink is None
        if sink is not None:
            entry.sinks.append(sink)
        self._pending[req_key] = entry
        self._by_sig.setdefault(entry.sig, []).append(req_key)
        self._pending_bytes += self._estimate_bytes(plan)
        self.metrics.inc(enqueued=1, admitted=1)
        ticket = CountTicket(self, entry=entry)
        if admission_over:
            # "queue" policy: the flooding tenant pays for its own
            # drain inline, holding its pending depth at the bound
            # (overrides defer_drains, like backpressure does)
            self.metrics.inc(throttled=1)
            if tr.enabled:
                tr.event("service.flush", trigger="admission",
                         tenant=self.tenant)
            to_execute = self._drain_all()
        else:
            to_execute = self._drain_triggered(entry)
        self._wake.notify_all()      # dispatcher re-arms its deadline
        return ticket, to_execute

    def count(self, point: LatticePoint,
              keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Synchronous convenience: :meth:`submit` + blocking ``result()``.

        Usage::

            tab = svc.count(point)
        """
        return self.submit(point, keep).result()

    def count_many(self, queries: Sequence[Tuple[LatticePoint,
                                                 Optional[Sequence[CtVar]]]]
                   ) -> List[CtTable]:
        """Submit a whole query list, dispatch it bucketed, return results
        in submission order — the natural API for a client that has its
        round's frontier in hand.

        Args:
            queries: ``(point, keep)`` pairs (``keep=None`` = all axes).

        Returns:
            One :class:`~repro_torch.core.ct.CtTable` per query, positionally
            aligned with ``queries``.

        Usage::

            tabs = svc.count_many([(p, None) for p in lattice])
        """
        tickets = [self.submit(point, keep) for point, keep in queries]
        self.flush()
        return [t.result() for t in tickets]

    def count_complete(self, point: LatticePoint,
                       keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Synchronous complete-CT convenience: :meth:`submit_complete` +
        blocking ``result()``.

        Usage::

            tab = svc.count_complete(point)
        """
        return self.submit_complete(point, keep).result()

    def complete_many(self, queries: Sequence[Tuple[LatticePoint,
                                                    Optional[Sequence[CtVar]]]]
                      ) -> List[CtTable]:
        """Submit a whole complete-CT query list, dispatch it bucketed
        (both phases), return results in submission order.

        Args:
            queries: ``(point, keep)`` pairs (``keep=None`` = all
                attribute + indicator axes).

        Returns:
            One complete :class:`~repro_torch.core.ct.CtTable` per query,
            positionally aligned with ``queries``.

        Usage::

            tabs = svc.complete_many([(p, None) for p in lattice])
        """
        tickets = [self.submit_complete(point, keep)
                   for point, keep in queries]
        self.flush()
        return [t.result() for t in tickets]

    # -- asyncio client surface ---------------------------------------------
    async def acount(self, point: LatticePoint,
                     keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Asyncio-native :meth:`count`: submit + ``await`` the result
        without blocking the event loop.

        Designed for the dispatcher deployment (``dispatcher=True`` with a
        ``max_wait_s`` deadline): a flood of concurrent ``acount`` awaiters
        costs no threads — each parks on a future that the executing batch
        wakes via ``loop.call_soon_threadsafe`` — and the dispatcher's
        deadline batches them exactly like threaded clients.  Without a
        dispatcher the blocking flush runs in the loop's thread pool.

        Usage::

            svc = CountingService(engine, max_wait_s=0.005, dispatcher=True)
            tabs = await asyncio.gather(*(svc.acount(p) for p in points))
        """
        return await self.submit(point, keep).aresult()

    async def acomplete(self, point: LatticePoint,
                        keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Asyncio-native :meth:`count_complete`: complete-CT query
        (positive + Möbius negative phase) awaited without blocking the
        loop — same bridging as :meth:`acount`.

        Usage::

            tab = await svc.acomplete(point)
        """
        return await self.submit_complete(point, keep).aresult()

    # -- mutations ----------------------------------------------------------
    @contextmanager
    def fence(self):
        """Hold the store still: blocks new submits from reading the cache
        AND waits out any mid-flight bucket execution, so a mutation +
        cache reconcile inside the fence is atomic with respect to every
        query.  Queries already queued (but not executing) simply run
        after the fence — against the post-delta store, which their
        metadata-only plans are agnostic to."""
        with self._lock, self._exec_lock:
            yield self

    def apply_delta(self, delta=None, *,
                    mutate: Optional[Callable[[], object]] = None,
                    **kw) -> Optional[DeltaReport]:
        """Apply one store mutation and reconcile the engine's cache,
        fenced against in-flight buckets (the version bump never tears a
        running batch, and no submit can read a stale entry in between).

        Args:
            delta: a :class:`~repro_torch.core.database.FactDelta` or
                :class:`~repro_torch.core.database.AttrDelta` already applied
                to the engine's database — pass it when the mutation
                itself happened elsewhere (under this service's
                :meth:`fence`).
            mutate: alternatively, a thunk that performs the mutation and
                returns the delta; it runs INSIDE the fence (this is what
                :meth:`insert_facts` / :meth:`delete_facts` use).
            **kw: forwarded to :meth:`~repro_torch.core.engine.CountingEngine
                .apply_delta` (e.g. ``max_update_fraction``).

        Returns:
            The engine's :class:`~repro_torch.core.engine.DeltaReport`, or
            ``None`` for an empty delta.

        Usage::

            report = svc.apply_delta(mutate=lambda: db.insert_facts(...))
        """
        with self.fence():
            if mutate is not None:
                delta = mutate()
            if delta is None:
                return None
            report = self.engine.apply_delta(delta, **kw)
        self.metrics.inc(deltas=1, delta_updated=report.updated,
                         delta_invalidated=report.invalidated,
                         delta_retained=report.retained)
        return report

    def insert_facts(self, rel: str, src, dst,
                     attrs=None, **kw) -> Optional[DeltaReport]:
        """Fenced convenience: :meth:`~repro_torch.core.database.RelationalDB
        .insert_facts` on the engine's database + cache reconcile, as one
        atomic step (see :meth:`apply_delta`).

        Usage::

            svc.insert_facts("Rated", src, dst, {"rating": vals})
        """
        return self.apply_delta(
            mutate=lambda: self.engine.db.insert_facts(rel, src, dst, attrs),
            **kw)

    def delete_facts(self, rel: str, src, dst, **kw) -> Optional[DeltaReport]:
        """Fenced convenience: :meth:`~repro_torch.core.database.RelationalDB
        .delete_facts` + cache reconcile, as one atomic step.

        Usage::

            svc.delete_facts("Rated", src, dst)
        """
        return self.apply_delta(
            mutate=lambda: self.engine.db.delete_facts(rel, src, dst), **kw)

    def update_attrs(self, etype: str, rows, attrs,
                     **kw) -> Optional[DeltaReport]:
        """Fenced convenience: :meth:`~repro_torch.core.database.RelationalDB
        .update_attrs` (entity-attribute writes) + cache reconcile, as one
        atomic step.  Entries whose dependency stamps intersect the
        written ``(etype, attr)`` pairs are invalidated; everything else
        is retained untouched (see :meth:`~repro_torch.core.engine
        .CountingEngine.apply_delta`).

        Usage::

            svc.update_attrs("user", rows, {"age": new_ages})
        """
        return self.apply_delta(
            mutate=lambda: self.engine.db.update_attrs(etype, rows, attrs),
            **kw)

    def prefetch(self, policy, queries: Sequence[Tuple[LatticePoint,
                                                       Tuple[CtVar, ...]]]
                 ) -> int:
        """Batch-warm a positive policy's cache: ask the policy which of
        ``queries`` it would have to contract from data
        (:meth:`~repro_torch.core.engine._Policy.batchable_misses`), execute those
        in signature buckets, and hand each result back through the
        policy's absorb hook.

        Args:
            policy: a positive policy from :mod:`repro_torch.core.engine`
                (``batchable_misses``/``absorb`` protocol).
            queries: the ``(point, keep)`` positive sub-queries about to
                be issued (see :func:`repro_torch.core.mobius.positive_queries`).

        Returns:
            The number of queries actually executed (cache misses).

        Usage::

            n = svc.prefetch(strategy.provider, positive_queries(point, keep))
        """
        todo = policy.batchable_misses(list(queries))
        if not todo:
            return 0
        for point, keep in todo:
            self.submit(point, keep, sink=policy.absorb)
        self.flush()
        return len(todo)

    # -- dispatcher lifecycle -----------------------------------------------
    def start(self) -> "CountingService":
        """Start the dispatcher thread (idempotent).

        The dispatcher sleeps until the oldest pending query's
        ``max_wait_s`` deadline, then drains and executes the queue on its
        own — no subsequent submit needed.  Submits wake it so the
        deadline is always armed against the current oldest entry.  With
        ``max_wait_s=None`` the thread stays parked until :meth:`shutdown`
        (all other triggers run on the submitting thread).

        Returns:
            ``self``, for chaining.

        Raises:
            ServiceShutdown: the service was already shut down.

        Usage::

            svc = CountingService(engine, max_wait_s=0.01).start()
        """
        with self._lock:
            if self._shut_down:
                raise ServiceShutdown("start on a shut-down service")
            if self._dispatcher_thread is not None:
                return self
            t = threading.Thread(target=self._dispatch_loop,
                                 name="counting-dispatcher", daemon=True)
            self._dispatcher_thread = t
        t.start()
        return self

    @property
    def running(self) -> bool:
        """Whether the dispatcher thread is alive."""
        t = self._dispatcher_thread
        return t is not None and t.is_alive()

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Stop the service: halt the dispatcher thread and settle every
        pending query.  Idempotent; subsequent submits raise
        :class:`ServiceShutdown`.

        Args:
            drain: ``True`` executes the remaining queue before returning
                (every waiter gets its result); ``False`` fails every
                pending waiter with :class:`ServiceShutdown` immediately —
                a clean error, never a hang.
            timeout: seconds to wait for the dispatcher thread to exit
                (``None`` = forever).

        Usage::

            svc.shutdown()                 # graceful: drain, then stop
            svc.shutdown(drain=False)      # fast: fail pending waiters
        """
        with self._lock:
            if self._shut_down:
                return
            self._shut_down = True
            entries = self._drain_all()
            self._wake.notify_all()
            thread, self._dispatcher_thread = self._dispatcher_thread, None
        if thread is not None:
            thread.join(timeout)
        if not entries:
            return
        if drain:
            try:
                self._execute(entries)
            except BaseException:      # noqa: BLE001 — each waiter already
                pass                   # holds the batch's error; shutdown
                                       # itself must not throw (callers
                                       # run it in finally blocks)
            return
        err = ServiceShutdown(
            f"counting service shut down with {len(entries)} queries "
            f"pending")
        for e in entries:
            e.error = err
            e.settle()

    def _device(self):
        """The engine's CUDA device as the current one of the calling
        thread (a thread starts on device 0), or nothing on the host."""
        dev = self.engine.device
        return torch.cuda.device(dev) if dev.type == "cuda" else nullcontext()

    def _dispatch_loop(self) -> None:
        with self._device():
            self._dispatch_forever()

    def _dispatch_forever(self) -> None:
        while True:
            entries: List[_Pending] = []
            with self._lock:
                if self._shut_down:
                    return
                timeout = None
                if self.max_wait_s is not None and self._pending:
                    oldest = min(e.enqueued_at
                                 for e in self._pending.values())
                    due = self.max_wait_s - (time.perf_counter() - oldest)
                    if due <= 0:
                        self.metrics.inc(wait_flushes=1)
                        if self.tracer.enabled:
                            self.tracer.event("service.flush",
                                              trigger="deadline")
                        entries = self._drain_all()
                    else:
                        timeout = due
                if not entries:
                    self._wake.wait(timeout)
                    continue
            try:
                self._execute(entries)
            except BaseException:      # noqa: BLE001 — waiters already got
                pass                   # the error via their tickets; the
                                       # dispatcher survives to serve the
                                       # next deadline

    # -- scheduler ----------------------------------------------------------
    def flush(self) -> None:
        """Drain and execute every pending query."""
        with self._lock:
            entries = self._drain_all()
        if entries:
            self._execute(entries)

    @contextmanager
    def defer_drains(self):
        """Suspend the size/deadline dispatch triggers inside the block:
        submits only QUEUE, nothing executes on the caller's thread until
        its own :meth:`flush`.  For callers that hold a whole flood and
        flush right after — the router queues every shard's full query
        list under this and then drains the shards together, so one
        shard's inline size-triggered drain cannot serialise the others
        behind it.  Backpressure (in-flight count/byte limits) and the
        "queue" admission policy stay armed.  Re-entrant and thread-safe.

        Usage::

            with svc.defer_drains():
                tickets = [svc.submit(p) for p in points]
            svc.flush()
        """
        with self._lock:
            self._defer_depth += 1
        try:
            yield self
        finally:
            with self._lock:
                self._defer_depth -= 1

    def pending(self) -> int:
        """Number of queries currently queued (not yet dispatched)."""
        with self._lock:
            return len(self._pending)

    # -- external (router- or registry-fused) execution ----------------------
    def drain_pending(self) -> List[_Pending]:
        """Take the whole queue for an EXTERNAL executor — the router's
        fused cross-shard evaluation, the registry's cross-tenant one.  The
        caller OWNS the drained entries: it must hand each a table through
        :meth:`deliver_external`, run them with :meth:`execute_drained`, or
        settle them with an error — an entry dropped on the floor hangs
        its waiters forever."""
        with self._lock:
            return self._drain_all()

    def execute_drained(self, entries: List[_Pending]) -> None:
        """Run previously drained entries through the normal batch path
        (the fused router flush falls back here when shard queues do not
        align)."""
        if entries:
            self._execute(entries)

    def deliver_external(self, delivered: Sequence[Tuple[_Pending,
                                                         CtTable]]) -> None:
        """Deliver externally computed tables for drained entries: the
        usual sink/cache/result routing under the exec lock, then a
        synchronisation of the engine's device (every table is computed
        before any waiter wakes, as in a batch of this service's own), then
        settle.  The tables must be what this service's own batch would
        have produced (the fused paths evaluate the same plans)."""
        tr = self.tracer
        try:
            with self._exec_lock, self._device():
                now = time.perf_counter()
                for e, tab in delivered:
                    self.metrics.observe_wait(now - e.enqueued_at)
                    if tr.enabled:
                        e.trace_ctx = tr.record(
                            "service.queue", e.enqueued_at, now,
                            parent=e.trace_ctx, external=True,
                            tenant=self.tenant)
                    self._deliver(e, tab)
                synchronize(self.engine.device)
        finally:
            self._settle_all([e for e, _ in delivered])

    def _drain_all(self) -> List[_Pending]:
        """Take the whole queue (lock held)."""
        entries = list(self._pending.values())
        self._pending.clear()
        self._by_sig.clear()
        self._pending_bytes = 0
        if entries:
            self.metrics.inc(flushes=1)
        return entries

    def _drain_bucket(self, sig: Tuple) -> List[_Pending]:
        """Take one signature bucket (lock held)."""
        keys = self._by_sig.pop(sig, [])
        entries = [self._pending.pop(k) for k in keys]
        self._pending_bytes -= sum(self._estimate_bytes(e.plan)
                                   for e in entries)
        if entries:
            self.metrics.inc(flushes=1)
        return entries

    def _drain_triggered(self, entry: _Pending) -> List[_Pending]:
        """Apply the dispatch triggers after admitting ``entry`` (lock
        held); returns whatever must now execute."""
        over_count = len(self._pending) > self.max_in_flight
        over_bytes = (self.max_pending_bytes is not None
                      and self._pending_bytes > self.max_pending_bytes
                      and len(self._pending) > 1)
        tr = self.tracer
        if over_count or over_bytes:
            self.metrics.inc(backpressure_flushes=1)
            if tr.enabled:
                tr.event("service.flush", trigger="backpressure",
                         over_count=over_count, over_bytes=over_bytes)
            return self._drain_all()
        if self._defer_depth:
            return []                  # the caller flushes itself
        if len(self._by_sig.get(entry.sig, ())) >= self.max_batch_size:
            self.metrics.inc(size_flushes=1)
            if tr.enabled:
                tr.event("service.flush", trigger="size", sig=entry.sig)
            return self._drain_bucket(entry.sig)
        if self.max_wait_s is not None:
            oldest = min(e.enqueued_at for e in self._pending.values())
            if time.perf_counter() - oldest >= self.max_wait_s:
                self.metrics.inc(wait_flushes=1)
                if tr.enabled:
                    tr.event("service.flush", trigger="deadline")
                return self._drain_all()
        return []

    def _execute(self, entries: List[_Pending]) -> None:
        # one batch executes at a time: the exec lock serialises engine
        # stats bumps, metrics, cache writes and sink callbacks across
        # client threads (the queue lock is NOT held here).  Entries are
        # already out of the queue, so every event MUST be set even on
        # failure — a waiter left unsignalled would hang forever.
        eng = self.engine
        tr = self.tracer
        try:
            with self._exec_lock, self._device():
                now = time.perf_counter()
                for e in entries:
                    self.metrics.observe_wait(now - e.enqueued_at)
                    if tr.enabled:
                        # the queue span is only known now (retroactive);
                        # re-point the entry at it so its exec span nests
                        e.trace_ctx = tr.record(
                            "service.queue", e.enqueued_at, now,
                            parent=e.trace_ctx, sig=e.sig,
                            tenant=self.tenant)
                positives = [e for e in entries if not e.complete]
                completes = [e for e in entries if e.complete]
                if positives:
                    t0 = time.perf_counter()
                    with eng.stats.timer("positive"):
                        tabs = execute_bucketed(
                            eng.executor, eng.db,
                            [e.plan for e in positives],
                            eng.stats, max_batch_size=self.max_batch_size,
                            metrics=self.metrics, tracer=tr)
                    if tr.enabled:
                        t1 = time.perf_counter()
                        for e in positives:
                            tr.record("service.exec", t0, t1,
                                      parent=e.trace_ctx, phase="positive",
                                      batch=len(positives))
                    for e, tab in zip(positives, tabs):
                        self._deliver(e, tab)
                if completes:
                    t0 = time.perf_counter()
                    tabs = execute_complete_bucketed(
                        eng, self._complete_policy(),
                        [(e.point, e.keep) for e in completes],
                        eng.stats, max_batch_size=self.max_batch_size,
                        metrics=self.metrics,
                        use_butterfly=self.use_butterfly)
                    # the positive phase's timer synchronised; the negative
                    # phase has none, so its exec span ends on the card here
                    synchronize(eng.device)
                    if tr.enabled:
                        t1 = time.perf_counter()
                        for e in completes:
                            tr.record("service.exec", t0, t1,
                                      parent=e.trace_ctx, phase="complete",
                                      batch=len(completes))
                    for e, tab in zip(completes, tabs):
                        self._deliver(e, tab)
                # every table is computed before any waiter wakes
                synchronize(eng.device)
        except BaseException as err:
            for e in entries:
                if e.result is None and e.error is None:
                    e.error = err          # propagate to every waiter
            raise
        finally:
            self._settle_all(entries)

    def _settle_all(self, entries: Sequence[_Pending]) -> None:
        """Wake every waiter, then record each entry's submit→settle
        latency (and offer it to the slow-query log when tracing)."""
        done = time.perf_counter()
        slow = self.tracer.slow
        for e in entries:
            e.settle()
            dt = done - e.enqueued_at
            self.metrics.observe_e2e(dt)
            if slow is not None:
                slow.offer("service.e2e", dt, sig=e.sig,
                           complete=e.complete, atoms=e.point.atoms)

    def _deliver(self, e: _Pending, tab: CtTable) -> None:
        """Route one finished query: sinks, cache write, result slot."""
        eng = self.engine
        for sink in e.sinks:
            sink(e.point, e.keep, tab)
        if e.cache_result or not e.sinks:
            if e.complete:
                # family-table namespace; the positives inside already did
                # their own ct_rows accounting through the policy
                eng.cache.put(self._complete_key(e.point, e.keep), tab)
            else:
                key = self._cache_key(e.point, e.keep)
                eng.count_rows_once(key, tab)
                eng.cache.put(key, tab)
        e.result = tab

    # -- bookkeeping --------------------------------------------------------
    def _cache_key(self, point: LatticePoint,
                   keep: Tuple[CtVar, ...]) -> Tuple:
        # same namespace as OnDemandPositives: a search sharing this engine
        # is served straight from the warmed cache
        return ("pos", self.engine.executor.name, point.atoms, tuple(keep))

    def _complete_key(self, point: LatticePoint,
                      keep: Tuple[CtVar, ...]) -> Tuple:
        # same namespace as Strategy.family_ct: a search sharing this
        # engine is served straight from the warmed family cache
        return ("fam", point.atoms, tuple(keep))

    def _complete_policy(self) -> OnDemandPositives:
        """The positive policy backing complete-CT queries (lazy; shares
        the engine's cache and row accounting with any co-resident
        search)."""
        if self._policy is None:
            self._policy = OnDemandPositives(self.engine)
        return self._policy

    def _estimate_bytes(self, plan: ContractionPlan) -> int:
        n = 1
        for d in plan.out_shape:
            n *= int(d)
        return n * self.engine.dtype.itemsize

    def discovery(self, **kwargs):
        """The model-discovery service running over this counting service
        (built lazily on first call, then shared — so every caller's
        searches hit one warm score memo).  Keyword arguments are
        forwarded to :class:`~repro_torch.discover.service.DiscoveryService`
        on first construction and ignored afterwards.

        Usage::

            result = svc.discovery().discover()
        """
        if self._discovery is None:
            from ..discover import DiscoveryService
            self._discovery = DiscoveryService(self, tracer=self.tracer,
                                               **kwargs)
        return self._discovery

    def stats(self) -> dict:
        """Service + cache health snapshot (JSON-able; see
        :meth:`~repro_torch.serve.metrics.ServiceMetrics.snapshot`).

        Usage::

            print(svc.stats()["qps"], svc.stats()["cache"]["hits"])
        """
        out = self.metrics.snapshot(self.engine.cache)
        out["tenant"] = self.tenant
        out["tracer"] = self.tracer.snapshot()
        if self._discovery is not None:
            out["discovery"] = self._discovery.stats()
        return out
