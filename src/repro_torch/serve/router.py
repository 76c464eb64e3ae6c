"""Cross-database routing: one counting service per shard, merged answers.

This is the horizontal-scaling front-end over a
:class:`~repro_torch.core.database.ShardedDatabase`: the database is
hash-partitioned by root entity and each shard runs its OWN
planner/executor/cache stack behind its own
:class:`~repro_torch.serve.service.CountingService`, every stack on the
router's one device.  The :class:`CountingRouter` is the thin layer clients
talk to instead:

* each positive-count query is routed per
  :meth:`~repro_torch.core.database.ShardedDatabase.route` — **fan-out** (every
  shard computes its partial table; the router sums them: sufficient
  statistics are additive over data partitions, Qian & Schulte's
  parallelisation) or **single-shard** (the query touches only replicated
  tables, so any one shard has the exact answer);
* shard services keep all of their batching machinery: a flood of router
  queries becomes per-shard signature-bucketed stacked dispatches;
* the router keeps its OWN result cache and in-flight table: a repeated
  query is answered from the merged-result cache without touching any
  shard, and identical *concurrent* fan-out queries coalesce onto one
  in-flight ticket instead of re-executing and re-merging per caller;
* per-shard :class:`~repro_torch.serve.metrics.ServiceMetrics` roll up
  into one aggregate view (:meth:`CountingRouter.stats`), with
  routing-level counters (:class:`~repro_torch.serve.metrics
  .RouterMetrics`) on top.

Merging is exact, not approximate: counts are integer-valued and every
satisfied grounding is counted on exactly one shard (see
``ShardedDatabase.route`` for the routability condition; unroutable
queries raise :class:`~repro_torch.core.database.NotRoutableError` instead
of returning a wrong sum).  Below 2^24 the float32 sum is exact in any
order.

On the CUDA card the shard services share the one device and its current
stream: a fan-out's shard batches, run on the flush pool's threads,
serialise on the card.  The fused paths evaluate every shard's plans in
one evaluation (:meth:`~repro_torch.core.executors.Executor
.positive_stacked_merged`, :meth:`~repro_torch.core.executors.Executor
.positive_fanout_merged`); merges are stacked ``torch.sum`` calls on the
device (:class:`~repro_torch.serve.batching.TableMerger`).  Every path
ends in a synchronisation of the device before it hands a table out, as a
service batch does.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from contextlib import ExitStack
from typing import Dict, List, Optional, Sequence, Tuple

from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext

import torch

from ..core.cache import DEFAULT_TENANT
from ..core.contract import CostStats
from ..core.ct import CtTable
from ..core.database import NotRoutableError, ShardedDatabase
from ..core.device import resolve_device, synchronize
from ..core.engine import CountingEngine, DeltaReport
from ..core.executors import (Executor, fanout_stack_key, make_executor,
                              plan_stack_key)
from ..core.mobius import complete_ct_many, positive_queries
from ..core.variables import CtVar, LatticePoint
from ..obs.trace import NullTracer, SpanContext, default_tracer
from .batching import TableMerger
from .metrics import RouterMetrics, ServiceMetrics, merge_stats_dicts
from .service import CountingService, CountTicket

__all__ = ["CountingRouter", "RouterTicket", "NotRoutableError"]


class RouterTicket:
    """Handle for a routed query: one per-shard
    :class:`~repro_torch.serve.service.CountTicket` per participating shard.
    ``result()`` blocks on the shard tickets with **overlapped waits** —
    partials from shards that have already settled are folded into a
    running device-side sum (one stacked sum, see
    :class:`~repro_torch.serve.batching.TableMerger`) while the slower
    shards are still executing — and hands the merged device tensor
    straight into the router's result cache, no host copy.

    A ticket may be shared by several callers (identical concurrent
    queries coalesce onto one in-flight ticket), so the merge runs once
    under a per-ticket lock; every caller gets the same table.  A batched
    resolver (:meth:`CountingRouter.count_many`) can also install the
    merged table directly (:meth:`_install`), in which case ``result()``
    just hands it back."""

    def __init__(self, router: "CountingRouter",
                 tickets: Sequence[CountTicket], merge: bool,
                 key: Optional[Tuple] = None,
                 result: Optional[CtTable] = None,
                 epoch: int = 0,
                 trace_ctx: Optional[SpanContext] = None):
        self._router = router
        self._tickets = list(tickets)
        self._merge = merge
        self._key = key
        self._epoch = epoch            # cache generation at submit time
        self._result: Optional[CtTable] = result
        self._resolve_lock = threading.Lock()
        self._trace_ctx = trace_ctx    # the router.submit span's context
        self._t0 = time.perf_counter()  # router-level e2e reference

    @property
    def done(self) -> bool:
        return self._result is not None or all(t.done for t in self._tickets)

    def result(self, timeout: Optional[float] = None) -> CtTable:
        """The merged count table.

        Args:
            timeout: total wait bound in seconds for THIS call (None =
                wait forever) — one deadline across the lock acquire and
                every shard ticket, not a per-shard allowance.  Best
                effort: a shard wait first flushes that shard's queue
                synchronously (see :meth:`~repro_torch.serve.service
                .CountTicket.result`), and an in-progress flush runs to
                completion before the deadline is re-checked.

        Returns:
            The single-database-equivalent :class:`~repro_torch.core.ct.CtTable`:
            the sum of the per-shard tables for a fan-out query, the one
            shard's table otherwise.

        Raises:
            TimeoutError: the merged table was not ready within
                ``timeout``.
            BaseException: whatever a shard's batch execution raised.
        """
        if self._result is not None:
            return self._result
        deadline = None if timeout is None else time.monotonic() + timeout

        def remaining() -> Optional[float]:
            return None if deadline is None \
                else max(deadline - time.monotonic(), 0.0)

        # coalesced callers merge ONCE; the lock acquire honours the
        # caller's deadline even while another caller is mid-merge
        if not self._resolve_lock.acquire(
                timeout=-1 if timeout is None else remaining()):
            raise TimeoutError("merged count did not resolve in time")
        try:
            if self._result is None:
                try:
                    out = self._merge_overlapped(remaining)
                except BaseException:
                    self._router._forget(self._key)   # later submits retry
                    raise
                self._router._settle(self._key, out, self._epoch)
                self._result = out
                self._observe_settled("overlapped")
        finally:
            self._resolve_lock.release()
        return self._result

    def _observe_settled(self, path: str) -> None:
        """Router-level end-to-end accounting for this query: latency
        histogram, cache-install trace event, slow-query log offer."""
        router = self._router
        dt = time.perf_counter() - self._t0
        router.metrics.observe_e2e(dt)
        tr = router.tracer
        if tr.enabled:
            tr.event("router.cache_install", parent=self._trace_ctx,
                     path=path)
        slow = tr.slow
        if slow is not None and self._key is not None:
            slow.offer("router.e2e", dt, path=path, key=self._key,
                       shards=len(self._tickets))

    def _merge_overlapped(self, remaining) -> CtTable:
        """Collect the per-shard tables, merging as tickets settle: every
        pass folds all CURRENTLY settled partials (plus the running sum)
        into one device sum, then blocks on one still-pending shard — so
        the sum of the fast shards' tables overlaps the slow shards'
        execution instead of serialising after the slowest."""
        pending = list(self._tickets)
        if len(pending) == 1:
            return pending[0].result(remaining())
        router = self._router
        tr = router.tracer
        shard_of = {id(t): s for s, t in enumerate(self._tickets)}
        vars_out = None
        partial = None                 # running device-side sum
        n_merged = 0
        folds = 0
        straggler = 0                  # shard whose table arrived last
        t_merge0 = time.perf_counter()
        while pending:
            ready = [t for t in pending if t.done]
            if not ready:              # nothing settled: block on one shard
                ready = [pending[0]]   # (its result() flushes that shard)
            tabs = [t.result(remaining()) for t in ready]
            pending = [t for t in pending if t not in ready]
            straggler = shard_of[id(ready[-1])]
            if vars_out is None:
                vars_out = tabs[0].vars
            arrays = ([] if partial is None else [partial]) \
                + [t.counts for t in tabs]
            with router._device():
                partial = router._merger.reduce_arrays(arrays)
            n_merged += len(tabs)
            if len(arrays) > 1:
                folds += 1
        synchronize(router.device)
        out = CtTable(vars_out, partial)
        dt = time.perf_counter() - t_merge0
        if self._merge and n_merged > 1:
            router.metrics.inc(merged_tables=n_merged, device_merges=folds,
                               partial_merges=max(folds - 1, 0))
            router.metrics.observe_merge(dt)
            if tr.enabled:
                tr.record("router.merge", t_merge0, t_merge0 + dt,
                          parent=self._trace_ctx, path="overlapped",
                          folds=folds, merged=n_merged,
                          straggler_shard=straggler)
        return out

    def _shard_tables(self, timeout: Optional[float] = None
                      ) -> Optional[List[CtTable]]:
        """The raw per-shard tables, for a batched resolver — ``None`` if
        this ticket already carries a merged result (cache hit or a
        concurrent caller merged first)."""
        if self._result is not None:
            return None
        return [t.result(timeout) for t in self._tickets]

    def _install(self, tab: CtTable, n_merged: int) -> None:
        """Publish a batch-merged table onto this ticket (no-op if a
        concurrent caller already merged it per-ticket)."""
        with self._resolve_lock:
            if self._result is not None:
                return
            if self._merge and n_merged > 1:
                self._router.metrics.inc(merged_tables=n_merged)
            self._router._settle(self._key, tab, self._epoch)
            self._result = tab
            self._observe_settled("batched")


class _MergedProvider:
    """:class:`~repro_torch.core.mobius.PositiveProvider` over merged shard
    answers: positive sub-pattern tables go through the router (served
    from its merged-result cache after the warm batch), per-variable
    histograms from one shard's engine — entity tables are replicated, so
    any single shard holds the exact histogram."""

    def __init__(self, router: "CountingRouter", engine: CountingEngine):
        self._router, self._engine = router, engine

    def positive(self, point: LatticePoint, keep) -> CtTable:
        return self._router.count(point, tuple(keep))

    def hist(self, var, keep) -> CtTable:
        return self._engine.hist(var, tuple(keep))


class CountingRouter:
    """Fan-out/merge front-end over one
    :class:`~repro_torch.serve.service.CountingService` per database shard.

    Args:
        sdb: the partitioned database (see
            :func:`~repro_torch.core.database.shard_database`).
        executor: backend name (``"dense"`` / ``"sparse"`` /
            ``"sparse_sharded"``) — one executor INSTANCE is built per
            shard, on ``device`` (the mesh-sharded ones all over the one
            default group) — or a ready
            :class:`~repro_torch.core.executors.Executor` instance, which is
            then shared by every shard engine (and whose device the router
            takes when ``device`` is not given).
        max_batch_size / max_wait_s / max_in_flight / max_pending_bytes:
            per-shard service knobs, passed through to every
            :class:`~repro_torch.serve.service.CountingService`.
        cache_budget_bytes: per-shard ct-cache budget (each shard engine
            owns an independent cache).
        cache_entries: size of the router's own merged-result cache (LRU
            by entry count; ``0`` disables router-level caching).  This
            cache exists to skip the fan-out + merge entirely on repeats.
        cache_result_bytes: byte bound on the same cache (LRU-trimmed
            when either limit is crossed), so a flood of LARGE merged
            tables cannot pin unbounded front-end memory.
        dtype: accumulation dtype for every shard engine.
        metrics: routing-level counters; defaults to a fresh
            :class:`~repro_torch.serve.metrics.RouterMetrics`.
        tracer: request tracer shared by the router AND every shard
            service/engine/cache (see :mod:`repro_torch.obs.trace`); defaults
            to :func:`~repro_torch.obs.trace.default_tracer` — the free no-op
            tracer unless ``REPRO_TRACE`` enables one.
        tenant: the logical database this router fronts (stamped on its
            services and its discovery version tokens).
        device: where every shard stack counts, resolved once
            (``None`` = the CUDA card; raises without one, never drops to
            the host).

    Usage::

        router = CountingRouter(shard_database(db, 4), executor="sparse")
        tab = router.count(point)          # == single-DB answer, exactly
    """

    def __init__(self, sdb: ShardedDatabase, executor="sparse",
                 max_batch_size: int = 64,
                 max_wait_s: Optional[float] = None,
                 max_in_flight: int = 1024,
                 max_pending_bytes: Optional[int] = None,
                 cache_budget_bytes: Optional[int] = None,
                 cache_entries: int = 1024,
                 cache_result_bytes: int = 64 << 20,
                 dtype=torch.float32,
                 rebalance_rows: Optional[int] = None,
                 metrics: Optional[RouterMetrics] = None,
                 tracer: Optional[NullTracer] = None,
                 tenant: str = DEFAULT_TENANT,
                 device=None):
        self.device = (executor.device if isinstance(executor, Executor)
                       and device is None else resolve_device(device))
        self.sdb = sdb
        self.tenant = tenant
        self.cache_entries = cache_entries
        self.cache_result_bytes = cache_result_bytes
        self.rebalance_rows = rebalance_rows
        self.metrics = metrics if metrics is not None else RouterMetrics()
        self.tracer = tracer if tracer is not None else default_tracer()
        self._lock = threading.Lock()      # metrics + router cache state
        # one writer at a time: apply_delta and rebalance serialise here
        # (readers never take it — they work on snapshots)
        self._mutate_lock = threading.Lock()
        # multi-shard read consistency: a fan-out's per-shard sub-submits
        # happen under this gate, and apply_delta holds it while fencing +
        # draining every shard — so a merged answer is always computed
        # entirely pre- or entirely post-delta, never a mix of shard
        # states that never coexisted.  Re-entrant: complete_many holds it
        # across its whole warm batch, whose fan-outs re-enter in submit()
        self._submit_gate = threading.RLock()
        self._results: "OrderedDict[Tuple, CtTable]" = OrderedDict()
        self._results_bytes = 0
        self._epoch = 0                    # bumped by invalidate()
        self._inflight: Dict[Tuple, "RouterTicket"] = {}
        self._merger = TableMerger()   # stacked device-side sums
        self._flush_pool: Optional[ThreadPoolExecutor] = None
        # kept to build replacement services after a rebalance
        self._executor_spec = executor
        self._dtype = dtype
        self._eng_kw = dict(cache_budget_bytes=cache_budget_bytes)
        self._svc_kw = dict(max_batch_size=max_batch_size,
                            max_wait_s=max_wait_s,
                            max_in_flight=max_in_flight,
                            max_pending_bytes=max_pending_bytes,
                            tracer=self.tracer,
                            tenant=tenant)
        self._discovery = None             # lazily built DiscoveryService
        self.engines: List[CountingEngine] = []
        self.services: List[CountingService] = []
        for shard in sdb.shards:
            eng, svc = self._build_shard_stack(shard)
            self.engines.append(eng)
            self.services.append(svc)

    def _build_shard_stack(self, shard) -> Tuple[CountingEngine,
                                                 CountingService]:
        """One planner/executor/cache stack + service for one shard DB on
        the router's device (one executor INSTANCE per shard unless the
        caller supplied a ready instance to share)."""
        ex = (self._executor_spec if not isinstance(self._executor_spec, str)
              else make_executor(self._executor_spec, dtype=self._dtype,
                                 device=self.device))
        eng = CountingEngine(shard, ex, CostStats(), dtype=self._dtype,
                             device=self.device, **self._eng_kw)
        return eng, CountingService(eng, **self._svc_kw)

    def _device(self):
        """The router's CUDA device as the calling thread's current one,
        or nothing on the host (the shard services do the same for their
        own batches)."""
        return (torch.cuda.device(self.device)
                if self.device.type == "cuda" else nullcontext())

    def _snapshot(self) -> Tuple[ShardedDatabase, List[CountingService],
                                 List[CountingEngine], int]:
        """A coherent ``(sdb, services, engines, epoch)`` view: routing
        decisions and shard submits for ONE query must come from the same
        generation, or a mid-rebalance submit could mix old and new shard
        sets (double- or under-counting the moved rows).  ``rebalance``
        swaps all three references together under the lock."""
        with self._lock:
            return self.sdb, self.services, self.engines, self._epoch

    @property
    def n_shards(self) -> int:
        return self.sdb.n_shards

    def set_tracer(self, tracer: NullTracer) -> "CountingRouter":
        """Wire one tracer through the router and every shard stack
        (services, engines, executors, caches); shard stacks built by a
        later :meth:`rebalance` inherit it too.  Pass
        :data:`~repro_torch.obs.trace.NULL_TRACER` to turn tracing back off.

        Usage::

            router.set_tracer(Tracer())
        """
        self.tracer = tracer
        self._svc_kw["tracer"] = tracer
        for svc in self._snapshot()[1]:
            svc.set_tracer(tracer)
        return self

    # -- client API ---------------------------------------------------------
    def submit(self, point: LatticePoint,
               keep: Optional[Sequence[CtVar]] = None) -> RouterTicket:
        """Route one positive-count query; returns immediately.

        Fan-out queries enqueue on EVERY shard service (each applies its
        own batching/backpressure); single-shard queries enqueue on the
        shard that holds the full answer.  A query whose merged result is
        already in the router cache short-circuits without touching any
        shard; an identical query already in flight returns the SAME
        ticket (the fan-out executes and merges once, not once per
        caller).

        Args:
            point: lattice point to count (>= 1 atom).
            keep: ct-table axes; defaults to all entity/edge attributes of
                the point.

        Returns:
            A :class:`RouterTicket`; call ``.result()`` for the merged
            table.

        Raises:
            NotRoutableError: no additive merge exists for this query
                under the database's partitioning (see
                :meth:`~repro_torch.core.database.ShardedDatabase.route`).
        """
        tr = self.tracer
        if not tr.enabled:
            return self._submit_routed(point, keep, None)
        with tr.span("router.submit", atoms=point.atoms) as sp:
            return self._submit_routed(point, keep, sp)

    def _submit_routed(self, point: LatticePoint,
                       keep: Optional[Sequence[CtVar]],
                       span) -> RouterTicket:
        """:meth:`submit` body; ``span`` is the open ``router.submit``
        span (or ``None`` when tracing is off) — the routing decision and
        per-shard submits are annotated onto it and its context becomes
        the parent of every downstream span of this query."""
        sdb, services, engines, epoch = self._snapshot()
        ctx = span.context if span is not None else None
        key = (point.atoms, engines[0].plan(point, keep).keep)
        with self._lock:
            self.metrics.inc(requests=1)
            hit = self._results.get(key)
            if hit is not None:
                self._results.move_to_end(key)
                self.metrics.inc(cache_hits=1)
                if span is not None:
                    span.set(mode="cache_hit")
                return RouterTicket(self, (), merge=False, result=hit,
                                    trace_ctx=ctx)
            inflight = self._inflight.get(key)
            if inflight is not None:
                self.metrics.inc(coalesced=1)
                if span is not None:
                    span.set(mode="coalesced")
                return inflight
        try:
            mode, shard = sdb.route(point)
        except NotRoutableError:
            self.metrics.inc(not_routable=1)
            if span is not None:
                span.set(mode="not_routable")
            raise
        if span is not None:
            span.set(mode=mode, shards=(len(services) if mode == "fanout"
                                        else 1))
        if mode == "fanout":
            self.metrics.inc(fanout_requests=1)
            # the gate keeps a concurrent apply_delta from landing between
            # two shard enqueues of the SAME query (see __init__)
            with self._submit_gate:
                tickets = [svc.submit(point, keep, trace_ctx=ctx)
                           for svc in services]
            ticket = RouterTicket(self, tickets, merge=True, key=key,
                                  epoch=epoch, trace_ctx=ctx)
        else:
            self.metrics.inc(single_shard_requests=1)
            ticket = RouterTicket(
                self, [services[shard % len(services)].submit(
                    point, keep, trace_ctx=ctx)],
                merge=False, key=key, epoch=epoch, trace_ctx=ctx)
        with self._lock:
            # benign race: a concurrent identical submit may have landed
            # first — keep the first ticket; shard-level coalescing already
            # dedupes the underlying work
            ticket = self._inflight.setdefault(key, ticket)
        return ticket

    def count(self, point: LatticePoint,
              keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Synchronous convenience: :meth:`submit` + merged ``result()``."""
        return self.submit(point, keep).result()

    def count_many(self, queries: Sequence[Tuple[LatticePoint,
                                                 Optional[Sequence[CtVar]]]]
                   ) -> List[CtTable]:
        """Submit a whole query list, flush every shard, return merged
        tables in submission order — the per-shard services see the full
        flood at once, so same-signature queries stack per shard, and the
        merges are batched too: same-shape shard tables across the WHOLE
        flood are summed in one stacked device sum per shape group (see
        :class:`~repro_torch.serve.batching.TableMerger`) instead of one add
        chain per query.  A flood of fan-out queries alone takes the
        reassembly fast path (:meth:`_count_many_fanout`).

        Usage::

            tabs = router.count_many([(p, None) for p in lattice])

        Raises:
            NotRoutableError: some query has no additive merge — raised
                BEFORE anything is enqueued, so a bad query in the list
                never strands partial work on the shard queues.
        """
        sdb, services, engines, epoch = self._snapshot()
        # validate up front, enqueue nothing on a mixed good/bad list
        routes = [sdb.route(point) for point, _ in queries]
        if len(services) > 1 and queries \
                and all(mode == "fanout" for mode, _ in routes):
            out = self._count_many_fanout(sdb, engines, epoch, queries)
            if out is not None:
                return out
        # queue-only submits + one concurrent flush: no shard executes
        # inline on this thread, so shard batches overlap (see flush())
        with ExitStack() as defers:
            for svc in services:
                defers.enter_context(svc.defer_drains())
            tickets = [self.submit(point, keep) for point, keep in queries]
            self.flush()
        return self._resolve_many(tickets)

    def _count_many_fanout(self, sdb: ShardedDatabase,
                           engines: List[CountingEngine], epoch: int,
                           queries: Sequence[Tuple[LatticePoint,
                                                   Optional[Sequence[CtVar]]]]
                           ) -> Optional[List[CtTable]]:
        """All-fan-out flood fast path: reassemble the shards' edge tables
        into one view of the unsharded database and evaluate each
        :func:`~repro_torch.core.executors.fanout_stack_key` group ONCE on it
        (:meth:`~repro_torch.core.executors.Executor.positive_fanout_merged`) —
        the answers are the merged tables at single-database cost, so
        sharding overhead is the routing bookkeeping, not ``n_shards``
        evaluations plus a merge.  The shard services are bypassed (their
        caches stay cold; the router's own merged-result cache absorbs
        repeats — it is checked first on every path).  Returns ``None``
        only where a caller disables it (the port's evaluators reassemble
        every plan; the JAX package's falls back where its jit cannot fuse
        a plan's finalise layout); :meth:`count_many` then takes the
        per-shard service path.
        """
        ex0 = engines[0].executor
        dbs = [eng.db for eng in engines]
        keys: List[Tuple] = []
        plan_of: Dict[Tuple, object] = {}
        for point, keep in queries:
            plan = engines[0].plan(point, keep)
            key = (point.atoms, plan.keep)
            keys.append(key)
            plan_of[key] = plan
        groups: "OrderedDict[Tuple, Tuple[list, list]]" = OrderedDict()
        for key in dict.fromkeys(keys):
            plan = plan_of[key]
            fk = fanout_stack_key(dbs, plan, sdb.partitioned)
            g = groups.get(fk)
            if g is None:
                g = groups[fk] = ([], [])
            g[0].append(plan)
            g[1].append(key)
        resolved: Dict[Tuple, CtTable] = {}
        n_hits = n_coal = n_fan = 0
        with self._lock:
            seen: set = set()
            for key in keys:
                if key in resolved or key in seen:
                    if key in resolved:
                        n_hits += 1
                    else:
                        n_coal += 1
                    continue
                hit = self._results.get(key)
                if hit is not None:
                    self._results.move_to_end(key)
                    n_hits += 1
                    resolved[key] = hit
                else:
                    seen.add(key)
                    n_fan += 1
        self.metrics.inc(requests=len(keys), cache_hits=n_hits,
                         coalesced=n_coal, fanout_requests=n_fan)
        todo = seen
        if todo:
            stats = [eng.stats for eng in engines]
            # the gate linearizes the whole evaluation against
            # apply_delta/rebalance, like a service-path flood's
            # submit+flush window
            with self._submit_gate, self._device():
                for plans, gkeys in groups.values():
                    live = [(p, k) for p, k in zip(plans, gkeys)
                            if k in todo]
                    if not live:
                        continue
                    gplans = [p for p, _ in live]
                    t0 = time.perf_counter()
                    merged = ex0.positive_fanout_merged(
                        dbs, gplans, sdb.partitioned, stats)
                    synchronize(self.device)
                    dt = time.perf_counter() - t0
                    for (_, key), tab in zip(live, merged):
                        self._settle(key, tab, epoch)
                        resolved[key] = tab
                    self.metrics.inc(device_merges=1, fused_dispatches=1,
                                     merged_tables=len(gplans) * len(dbs))
                    self.metrics.observe_merge(dt)
                    tr = self.tracer
                    if tr.enabled:
                        # retroactive per-query roots: the fast path has no
                        # per-query submit, but the trace must still show
                        # which dispatch answered each query
                        t1 = t0 + dt
                        for _, key in live:
                            self.metrics.observe_e2e(dt)
                            root = tr.record("router.submit", t0, t1,
                                             mode="fanout_fused",
                                             atoms=key[0])
                            tr.record("router.merge", t0, t1, parent=root,
                                      path="fanout_fused",
                                      merged=len(dbs), shards=len(dbs))
                    else:
                        for _ in live:
                            self.metrics.observe_e2e(dt)
                    slow = self.tracer.slow
                    if slow is not None:
                        slow.offer("router.e2e", dt, path="fanout_fused",
                                   queries=len(gplans), shards=len(dbs))
        return [resolved[key] for key in keys]

    def _resolve_many(self, tickets: Sequence["RouterTicket"]
                      ) -> List[CtTable]:
        """Resolve many tickets through the batched device merge: gather
        every DISTINCT unresolved ticket's per-shard tables (coalesced
        duplicates resolve once), merge them grouped by table shape, and
        install each merged table back onto its ticket (which settles the
        router cache and any concurrent waiters)."""
        distinct: "OrderedDict[int, RouterTicket]" = OrderedDict()
        for t in tickets:
            distinct.setdefault(id(t), t)
        todo: List[RouterTicket] = []
        shard_tabs: List[List[CtTable]] = []
        for t in distinct.values():
            tabs = t._shard_tables()
            if tabs is not None:
                todo.append(t)
                shard_tabs.append(tabs)
        if todo:
            with self._device():
                merged, dispatches = self._merger.merge_tables(shard_tabs)
            synchronize(self.device)
            for t, tab, tabs in zip(todo, merged, shard_tabs):
                t._install(tab, len(tabs))
            if dispatches:
                self.metrics.inc(device_merges=dispatches)
        return [t.result() for t in tickets]

    # -- scheduling ---------------------------------------------------------
    def flush(self) -> None:
        """Drain every shard service's pending queue.

        When the shard queues hold the SAME fan-out flood (the
        :meth:`count_many` / :meth:`complete_many` case), every shard's
        stacked evaluation runs as ONE evaluation and the cross-shard
        merge as one stacked sum per shape (:meth:`~repro_torch.core.executors
        .Executor.positive_stacked_merged`): on one device, per-shard
        threads buy nothing — the GIL serialises the host side and the
        card serialises the kernels — so fusing them is what makes
        sharding overhead sublinear.  Queues that don't align (mixed routes, direct shard
        clients, complete-CT entries) fall back to one concurrent
        ``svc.flush()`` per shard."""
        services, engines = self._snapshot()[1:3]
        if len(services) <= 1:
            for svc in services:
                svc.flush()
            return
        if len(engines) == len(services) \
                and self._flush_fused(services, engines):
            return
        # list() propagates the first shard exception, like a serial loop
        list(self._get_pool(len(services)).map(
            lambda svc: svc.flush(), services))

    def _get_pool(self, n: int) -> ThreadPoolExecutor:
        pool = self._flush_pool
        if pool is None or pool._max_workers < n:
            pool = self._flush_pool = ThreadPoolExecutor(
                max_workers=n, thread_name_prefix="router-flush")
        return pool

    def _flush_fused(self, services: List[CountingService],
                     engines: List[CountingEngine]) -> bool:
        """Drain every shard queue and try the fused cross-shard dispatch;
        returns ``True`` when the drained work was fully handled (fused,
        or executed per shard as a fallback) and ``False`` only when
        nothing was drained because fusion is structurally unavailable.
        Merged tables land directly on the in-flight router tickets —
        :meth:`_resolve_many` then finds them already resolved and skips
        its merge pass."""
        drained = [svc.drain_pending() for svc in services]
        if not any(drained):
            return True
        groups = self._fused_groups(engines, drained)
        if groups is None:
            self._execute_drained(services, drained)
            return True
        ex0 = engines[0].executor
        dbs = [eng.db for eng in engines]
        stats = [eng.stats for eng in engines]
        try:
            for plans, per_shard_entries, keys in groups:
                t0 = time.perf_counter()
                with ExitStack() as timers:
                    timers.enter_context(self._device())
                    for eng in engines:
                        timers.enter_context(eng.stats.timer("positive"))
                    per_shard, merged = ex0.positive_stacked_merged(
                        dbs, plans, stats)
                    synchronize(self.device)
                dt = time.perf_counter() - t0
                sig = ("pos", plans[0].shape_signature())
                for s, svc in enumerate(services):
                    svc.metrics.observe_batch(sig, len(plans), dt)
                    svc.deliver_external(
                        list(zip(per_shard_entries[s], per_shard[s])))
                for key, tab in zip(keys, merged):
                    with self._lock:
                        ticket = self._inflight.get(key)
                    if ticket is not None:
                        ticket._install(tab, len(services))
                self.metrics.inc(device_merges=1, fused_dispatches=1)
                self.metrics.observe_merge(dt)
                tr = self.tracer
                if tr.enabled:
                    tr.record("router.fused_flush", t0, t0 + dt,
                              plans=len(plans), shards=len(services))
        except BaseException as err:
            # undelivered waiters must not hang: error + settle whatever
            # deliver_external has not already settled, and clear the
            # in-flight slots so later identical submits retry
            for entries in drained:
                for e in entries:
                    if not e.event.is_set():
                        if e.error is None and e.result is None:
                            e.error = err
                        e.settle()
            with self._lock:
                for _, _, keys in groups:
                    for key in keys:
                        self._inflight.pop(key, None)
            raise
        return True

    def _fused_groups(self, engines: List[CountingEngine],
                      drained: List[list]):
        """Group aligned drained entries for the fused dispatch, or
        ``None`` when the queues cannot fuse: unequal floods, complete-CT
        entries, per-shard plans that are not the same object (one compile
        cache serves every shard, so fan-outs share plans), or shard stack
        keys that diverge (edge counts straddling a pow2 bucket edge).
        Each group is ``(plans, entries_per_shard, router_keys)`` with one
        shared stack key."""
        n = len(drained[0])
        if any(len(d) != n for d in drained):
            return None
        maps = []
        for d in drained:
            mp = {}
            for e in d:
                if e.complete:
                    return None
                mp[(e.point.atoms, e.keep)] = e
            maps.append(mp)
        if any(mp.keys() != maps[0].keys() for mp in maps[1:]):
            return None
        groups: Dict[Tuple, Tuple[list, list, list]] = {}
        order = []
        for e0 in drained[0]:
            key = (e0.point.atoms, e0.keep)
            plan = e0.plan
            sk = plan_stack_key(engines[0].db, plan)
            entries_s = [e0]
            for eng, mp in zip(engines[1:], maps[1:]):
                es = mp[key]
                if es.plan is not plan \
                        or plan_stack_key(eng.db, es.plan) != sk:
                    return None
                entries_s.append(es)
            g = groups.get(sk)
            if g is None:
                g = groups[sk] = ([], [[] for _ in engines], [])
                order.append(g)
            g[0].append(plan)
            for s, es in enumerate(entries_s):
                g[1][s].append(es)
            g[2].append(key)
        return order

    def _execute_drained(self, services: List[CountingService],
                         drained: List[list]) -> None:
        """Fallback for drained-but-unfusable queues: the normal batch
        path per shard, concurrently when more than one shard has work."""
        pairs = [(svc, ents) for svc, ents in zip(services, drained)
                 if ents]
        if len(pairs) <= 1:
            for svc, ents in pairs:
                svc.execute_drained(ents)
            return
        list(self._get_pool(len(pairs)).map(
            lambda p: p[0].execute_drained(p[1]), pairs))

    def pending(self) -> int:
        """Total queries pending across all shard services."""
        return sum(svc.pending() for svc in self._snapshot()[1])

    # -- complete-CT routing -------------------------------------------------
    def count_complete(self, point: LatticePoint,
                       keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Complete ct-table (positive + Möbius negative phase) over a
        sharded database: **positive-phase fan-out + front-end
        transform**.

        The Möbius join is a signed sum of positive sub-pattern tables,
        and positive tables are additive over shards — so every positive
        sub-query the join needs is routed/merged through the ordinary
        :meth:`submit` machinery (warmed as one batch, so each shard sees
        signature-bucketed dispatches), and the inclusion–exclusion runs
        once at the front-end on the merged tables.  The result is
        exactly the single-database :func:`~repro_torch.core.mobius
        .complete_ct`.

        Args:
            point: lattice point (>= 1 relationship atom).
            keep: ct-table axes; attr, edge-attr AND rind axes of the
                point are legal (defaults to all of them).

        Returns:
            The complete :class:`~repro_torch.core.ct.CtTable` over ``keep``.

        Raises:
            NotRoutableError: some positive sub-query has no additive
                merge under the partitioning (raised before any shard
                work is enqueued).

        Usage::

            tab = router.count_complete(point)    # == single-DB complete_ct
        """
        return self.complete_many([(point, keep)])[0]

    def complete_many(self, queries: Sequence[Tuple[LatticePoint,
                                                    Optional[Sequence[CtVar]]]]
                      ) -> List[CtTable]:
        """Route a whole complete-CT query list: every distinct positive
        sub-query across ALL queries is warmed through the shard services
        first (one fan-out batch), then each front-end transform runs on
        merged tables — see :meth:`count_complete`.

        Usage::

            tabs = router.complete_many([(p, None) for p in lattice])
        """
        sdb, services, engines, epoch = self._snapshot()
        schema = sdb.schema
        norm: List[Tuple[LatticePoint, Tuple]] = []
        for point, keep in queries:
            if keep is None:
                keep = point.all_ct_vars(schema, include_rind=True)
            norm.append((point, tuple(keep)))
        out: List[Optional[CtTable]] = [None] * len(norm)
        todo: List[int] = []
        n_hits = 0
        with self._lock:               # complete-table result cache
            for i, (point, keep) in enumerate(norm):
                hit = self._results.get(("complete", point.atoms, keep))
                if hit is not None:
                    self._results.move_to_end(("complete", point.atoms,
                                               keep))
                    n_hits += 1
                    out[i] = hit
                else:
                    todo.append(i)
        self.metrics.inc(complete_requests=len(norm), cache_hits=n_hits)
        if not todo:
            return out                                   # type: ignore
        subs: List[Tuple[LatticePoint, Tuple]] = []
        for i in todo:                 # cache hits warm nothing
            point, keep = norm[i]
            subs.extend(positive_queries(point, keep, use_butterfly=True))
        for sp, _ in subs:             # validate BEFORE enqueueing anything
            sdb.route(sp)
        # the gate spans the warm batch AND the front-end transforms: a
        # complete-CT query is a multi-read transaction, and every
        # positive sub-table its inclusion-exclusion consumes must come
        # from one side of any concurrent delta (writers wait in
        # apply_delta until the transaction finishes)
        with self._submit_gate, self._device():
            with ExitStack() as defers:
                for svc in services:
                    defers.enter_context(svc.defer_drains())
                tickets = [self.submit(sp, sk)
                           for sp, sk in dict.fromkeys(subs)]
                self.flush()
            # batched resolve: merged positives land in the router cache
            # through one device reduction per shape group
            self._resolve_many(tickets)
            provider = _MergedProvider(self, engines[0])
            # front-end negative phase, batched: same-shape butterfly
            # stacks across ALL queries transform in one K3 launch each
            # (mirrors the in-service complete path)
            tabs = complete_ct_many(
                [norm[i] for i in todo], provider,
                use_butterfly=True,
                mobius_fn=engines[0].mobius_fn(),
                mobius_fused_fn=engines[0].mobius_fused_fn())
            synchronize(self.device)
            for i, tab in zip(todo, tabs):
                point, keep = norm[i]
                self._settle(("complete", point.atoms, keep), tab, epoch)
                out[i] = tab
        return out                                       # type: ignore

    # -- mutations & rebalancing ---------------------------------------------
    def apply_delta(self, rel: str, src, dst, attrs=None, *,
                    op: str = "insert",
                    **kw) -> List[Optional[DeltaReport]]:
        """Apply one write batch to the sharded store and reconcile every
        affected shard's cache, fenced across ALL shard services.

        The edges are routed exactly like reads: partitioned
        relationships hash each edge to its owning shard (untouched
        shards keep their caches hot — their report slot is ``None``);
        replicated relationships mutate the shared table once and
        reconcile everywhere.  The router's own merged-result cache is
        epoch-invalidated.  If ``rebalance_rows`` is set, any shard whose
        partitioned row count now exceeds it is split afterwards (see
        :meth:`rebalance`).

        Args:
            rel: relationship name.
            src / dst / attrs: the edge batch (see
                :meth:`~repro_torch.core.database.RelationalDB.insert_facts`).
            op: ``"insert"`` or ``"delete"``.
            **kw: forwarded to the engines' :meth:`~repro_torch.core.engine
                .CountingEngine.apply_delta`.

        Returns:
            One :class:`~repro_torch.core.engine.DeltaReport` (or ``None``) per
            shard, aligned with the shard list at application time.

        Usage::

            router.apply_delta("Rated", src, dst, {"rating": vals})
        """
        if op not in ("insert", "delete"):
            raise ValueError(f"op must be 'insert' or 'delete', got {op!r}")
        with self._mutate_lock:
            sdb, services, engines, _ = self._snapshot()
            # the submit gate + queue drain make cross-shard reads
            # linearize around the write: no fan-out is mid-enqueue, and
            # every sub-query already queued executes against the
            # PRE-delta store before anything moves — so a merged answer
            # can never mix shard states from both sides of the write
            with self._submit_gate:
                with ExitStack() as fences:
                    # global fence: replicated tables are SHARED arrays, so
                    # no shard may be mid-batch while they move underneath
                    for svc in services:
                        fences.enter_context(svc.fence())
                    for svc in services:
                        svc.flush()        # re-entrant: fence locks held
                    deltas = (sdb.insert_facts(rel, src, dst, attrs)
                              if op == "insert"
                              else sdb.delete_facts(rel, src, dst))
                    reports = [svc.apply_delta(d, **kw) if d is not None
                               else None
                               for svc, d in zip(services, deltas)]
                # epoch-invalidate while the gate still blocks readers, so
                # no submit can serve a pre-delta merged result afterwards
                self.invalidate()
            self.metrics.inc(deltas=1)
        if self.rebalance_rows is not None:
            for s in range(sdb.n_shards):
                if sdb.partitioned_rows(s) > self.rebalance_rows:
                    self.rebalance(s)
        return reports

    def insert_facts(self, rel: str, src, dst, attrs=None,
                     **kw) -> List[Optional[DeltaReport]]:
        """Convenience for :meth:`apply_delta` with ``op="insert"``."""
        return self.apply_delta(rel, src, dst, attrs, op="insert", **kw)

    def delete_facts(self, rel: str, src, dst,
                     **kw) -> List[Optional[DeltaReport]]:
        """Convenience for :meth:`apply_delta` with ``op="delete"``."""
        return self.apply_delta(rel, src, dst, op="delete", **kw)

    def update_attrs(self, etype: str, rows, attrs,
                     **kw) -> List[Optional[DeltaReport]]:
        """Apply one entity-attribute write batch to the sharded store and
        reconcile every shard's cache, fenced across ALL shard services —
        the attribute analogue of :meth:`apply_delta`.

        Entity tables are REPLICATED (shared arrays across shards), so the
        write lands once and every shard's cache is reconciled against its
        own :class:`~repro_torch.core.database.AttrDelta` stamp: entries whose
        dependency tags intersect the written ``(etype, attr)`` pairs are
        invalidated, everything else stays resident.  The router's own
        merged-result cache is epoch-invalidated.

        Args:
            etype: entity type name.
            rows / attrs: the row ids and per-attribute new values (see
                :meth:`~repro_torch.core.database.RelationalDB.update_attrs`).
            **kw: forwarded to the engines' :meth:`~repro_torch.core.engine
                .CountingEngine.apply_delta`.

        Returns:
            One :class:`~repro_torch.core.engine.DeltaReport` (or ``None``) per
            shard, aligned with the shard list at application time.

        Usage::

            router.update_attrs("user", rows, {"age": new_ages})
        """
        with self._mutate_lock:
            sdb, services, engines, _ = self._snapshot()
            with self._submit_gate:
                with ExitStack() as fences:
                    # entity tables are shared arrays: nothing may be
                    # mid-batch while attribute columns move underneath
                    for svc in services:
                        fences.enter_context(svc.fence())
                    for svc in services:
                        svc.flush()        # re-entrant: fence locks held
                    deltas = sdb.update_attrs(etype, rows, attrs)
                    reports = [svc.apply_delta(d, **kw) if d is not None
                               else None
                               for svc, d in zip(services, deltas)]
                self.invalidate()
            self.metrics.inc(deltas=1)
        return reports

    def rebalance(self, shard_id: int) -> int:
        """Split one shard online: re-partition its relationship tables
        onto a NEW shard (half its hash buckets move — see
        :meth:`~repro_torch.core.database.ShardedDatabase.split_shard`), build a
        fresh engine + service pair for both halves, and swap the
        router's shard set atomically under the epoch guard.

        No query is lost: in-flight tickets hold references to the OLD
        generation's services and shard databases (which the split left
        intact), so they drain to the correct pre-swap answers; their
        results are kept out of the router cache by the epoch bump.
        Submits arriving after the swap route against the new generation.
        Data is unchanged by a split, so answers are identical either
        way.

        Args:
            shard_id: index of the shard to split (current generation).

        Returns:
            The index of the NEW shard (== old ``n_shards``).

        Raises:
            IndexError / ValueError: see :meth:`~repro_torch.core.database
                .ShardedDatabase.split_shard`.

        Usage::

            new_shard = router.rebalance(hot_shard)
        """
        with self._mutate_lock:
            sdb, services, engines, _ = self._snapshot()
            new_sdb = sdb.split_shard(shard_id)
            eng_a, svc_a = self._build_shard_stack(new_sdb.shards[shard_id])
            eng_b, svc_b = self._build_shard_stack(new_sdb.shards[-1])
            new_idx = new_sdb.n_shards - 1
            old_svc = services[shard_id]
            with self._lock:
                self.sdb = new_sdb
                self.engines = (engines[:shard_id] + [eng_a]
                                + engines[shard_id + 1:] + [eng_b])
                self.services = (services[:shard_id] + [svc_a]
                                 + services[shard_id + 1:] + [svc_b])
                self._results.clear()
                self._results_bytes = 0
                self._epoch += 1       # mid-flight merges settle, not cache
            self.metrics.inc(rebalances=1)
        old_svc.flush()                # drain stragglers on the old stack
        return new_idx

    def shutdown(self, drain: bool = True,
                 timeout: Optional[float] = None) -> None:
        """Shut every shard service down (see :meth:`~repro_torch.serve
        .service.CountingService.shutdown`) and stop the flush pool's
        threads.  Idempotent.

        Usage::

            router.shutdown()
        """
        for svc in self._snapshot()[1]:
            svc.shutdown(drain=drain, timeout=timeout)
        pool, self._flush_pool = self._flush_pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # -- router-level result cache -------------------------------------------
    def invalidate(self) -> None:
        """Drop every cached merged result (e.g. after a data refresh).
        Live in-flight tickets still settle their waiters normally, but
        their (pre-invalidate) tables are NOT re-published into the
        cache — the epoch bump keeps stale data out."""
        with self._lock:
            self._results.clear()
            self._results_bytes = 0
            self._epoch += 1

    def _settle(self, key: Optional[Tuple], tab: CtTable,
                epoch: int) -> None:
        """Publish a merged result: cache it (LRU-trimmed by entry count
        AND bytes) and clear the in-flight slot so later identical
        submits hit the cache.  Results from a pre-``invalidate`` epoch
        settle their waiters but are not cached."""
        if key is None:
            return
        with self._lock:
            self._inflight.pop(key, None)
            if (epoch != self._epoch or self.cache_entries <= 0
                    or tab.nbytes > self.cache_result_bytes):
                return
            old = self._results.pop(key, None)
            if old is not None:
                self._results_bytes -= old.nbytes
            self._results[key] = tab
            self._results_bytes += tab.nbytes
            while (len(self._results) > self.cache_entries
                   or self._results_bytes > self.cache_result_bytes):
                _, dropped = self._results.popitem(last=False)
                self._results_bytes -= dropped.nbytes

    def _forget(self, key: Optional[Tuple]) -> None:
        """Drop a failed query's in-flight slot so later submits retry."""
        if key is None:
            return
        with self._lock:
            self._inflight.pop(key, None)

    # -- observability ------------------------------------------------------
    def discovery(self, **kwargs):
        """The model-discovery service running over this router (built
        lazily on first call, then shared, so concurrent clients' searches
        share one warm score memo over the sharded store).  Keyword
        arguments are forwarded to :class:`~repro_torch.discover.service
        .DiscoveryService` on first construction and ignored afterwards.

        Usage::

            result = router.discovery().discover()
        """
        if self._discovery is None:
            from ..discover import DiscoveryService
            self._discovery = DiscoveryService(self, tracer=self.tracer,
                                               **kwargs)
        return self._discovery

    def stats(self) -> dict:
        """Health snapshot: routing counters, the per-shard service
        snapshots, and their roll-up.

        Returns:
            ``{"router": ..., "aggregate": ..., "shards": [...]}`` where
            ``aggregate`` is the :meth:`~repro_torch.serve.metrics.ServiceMetrics
            .merged` view of all shard services plus the key-wise sum of
            the shard cache counters.
        """
        services = self._snapshot()[1]
        shard_snaps = [svc.stats() for svc in services]
        agg = ServiceMetrics.merged(
            [svc.metrics for svc in services]).snapshot()
        # deep merge: numeric leaves sum recursively, so nested sub-dicts
        # (per-tenant cache rollups) survive aggregation instead of being
        # silently dropped by a flat top-level-numeric sweep
        agg["cache"] = merge_stats_dicts(
            [snap.get("cache", {}) for snap in shard_snaps])
        out = {"router": self.metrics.snapshot(), "aggregate": agg,
               "shards": shard_snaps, "tenant": self.tenant,
               "tracer": self.tracer.snapshot()}
        if self._discovery is not None:
            out["discovery"] = self._discovery.stats()
        return out
