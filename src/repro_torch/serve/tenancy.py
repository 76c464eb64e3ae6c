"""Multi-tenant serving fleet: many logical databases behind ONE shared
counting pool.

A :class:`TenantRegistry` owns the three resources worth sharing across
tenants — one :class:`~repro_torch.core.executors.Executor` on one device, the
byte-budgeted :class:`~repro_torch.core.cache.CtCache` store, and the discovery
score memo — and gives every tenant its own isolated slice of each:

* **Cache** — each tenant counts against the one global byte budget
  through a :meth:`~repro_torch.core.cache.CtCache.scoped` view.  A tenant may
  reserve a floor (global eviction can never push it below its
  reservation) and accept a cap (its own entries shrink first once it
  crosses it), so a flooding tenant can spend the shared slack but never
  another tenant's reserved bytes.
* **Admission** — each tenant's :class:`~repro_torch.serve.service
  .CountingService` carries a per-tenant ``admission_max`` bound layered
  UNDER the pool-level ``max_in_flight``/pending-byte backpressure: a
  flooding tenant queues inline (policy ``"queue"``) or is shed with
  :class:`~repro_torch.serve.service.TenantAdmissionError` (policy ``"shed"``)
  while every other tenant's queue is untouched.
* **Dispatch** — :meth:`TenantRegistry.count_many` drains every involved
  tenant's queue and stacks same-shape plans from DIFFERENT tenants into
  one evaluation (:func:`~repro_torch.serve.batching.execute_bucketed_multi`:
  one K1/K2 launch per hop step of a stack group on the card); results
  are handed back through each tenant's own
  :meth:`~repro_torch.serve.service.CountingService.deliver_external`, so cache
  writes, metrics, and trace spans stay per-tenant.
* **Discovery** — per-tenant :class:`~repro_torch.discover.service
  .DiscoveryService` instances share ONE score memo; tenant-prefixed
  version tokens (:func:`~repro_torch.discover.providers._tenant_token`) keep
  the entries disjoint, so one tenant's writes never invalidate
  another's scores.

The default-tenant shim: a bare :class:`~repro_torch.serve.service
.CountingService` (or a private ``CtCache``) is exactly the degenerate
single-tenant registry — nothing in the single-database API changed.

Usage::

    reg = TenantRegistry(executor="dense", cache_budget_bytes=64 << 20)
    reg.add_tenant("acme", db_a, reserved_bytes=8 << 20)
    reg.add_tenant("globex", db_b, admission_max=128,
                   admission_policy="shed")
    tabs = reg.count_many([("acme", p1, None), ("globex", p2, None)])
    print(reg.stats()["tenants"]["acme"]["cache"]["hits"])
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from contextlib import ExitStack, nullcontext
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from ..core.cache import CtCache
from ..core.contract import CostStats
from ..core.ct import CtTable
from ..core.database import ShardedDatabase
from ..core.device import resolve_device
from ..core.engine import CountingEngine
from ..core.executors import Executor, make_executor
from ..core.variables import CtVar, LatticePoint
from ..obs.trace import NULL_TRACER, NullTracer, default_tracer
from .batching import execute_bucketed_multi
from .metrics import ServiceMetrics, merge_stats_dicts
from .router import CountingRouter
from .service import CountingService, CountTicket, TenantAdmissionError

__all__ = ["Tenant", "TenantRegistry", "TenantAdmissionError"]

TenantQuery = Tuple[str, LatticePoint, Optional[Sequence[CtVar]]]


class Tenant:
    """One logical database's slice of the shared pool.

    ``service`` is set for single-database tenants (their cache is a
    scoped view of the registry's shared store and their positives ride
    the cross-tenant fused dispatch); ``router`` is set for sharded
    tenants (per-shard private caches, outside the shared store's
    accounting — their floods still batch within the tenant).
    """

    __slots__ = ("tenant_id", "db", "engine", "service", "router")

    def __init__(self, tenant_id: str, db,
                 engine: Optional[CountingEngine] = None,
                 service: Optional[CountingService] = None,
                 router: Optional[CountingRouter] = None):
        self.tenant_id = tenant_id
        self.db = db
        self.engine = engine
        self.service = service
        self.router = router

    @property
    def frontend(self) -> Union[CountingService, CountingRouter]:
        """The object clients talk to: the tenant's service or router."""
        return self.service if self.service is not None else self.router


class TenantRegistry:
    """A fleet of logical databases behind one shared counting pool.

    Args:
        executor: executor spec (``"dense"``/``"sparse"``) or a ready
            :class:`~repro_torch.core.executors.Executor` instance.  ONE
            instance is shared by every tenant — that is what lets one
            evaluation serve same-shape plans of many tenants.
        cache_budget_bytes: global byte budget of the shared CT store
            (``None`` = unbounded; per-tenant floors/caps still apply).
        max_batch_size: signature-bucket dispatch size, per tenant AND
            for the cross-tenant fused dispatch.
        max_wait_s / max_in_flight / max_pending_bytes: forwarded to
            every tenant's service (pool-level backpressure).
        dtype: count dtype for engines built here.
        tracer: request tracer shared by the whole fleet (spans carry a
            ``tenant`` attribute, so one trace log splits cleanly).
        use_butterfly: Möbius evaluation order for complete-CT queries.
        device: where every tenant counts, resolved once (``None`` = the
            CUDA card; raises without one, never drops to the host; a
            ready executor's device when ``device`` is not given).

    Usage::

        reg = TenantRegistry()
        reg.add_tenant("a", db_a)
        tab = reg.count("a", point)
    """

    def __init__(self, *, executor: Union[str, Executor] = "dense",
                 cache_budget_bytes: Optional[int] = None,
                 max_batch_size: int = 64,
                 max_wait_s: Optional[float] = None,
                 max_in_flight: int = 1024,
                 max_pending_bytes: Optional[int] = None,
                 dtype=torch.float32,
                 tracer: Optional[NullTracer] = None,
                 use_butterfly: bool = True,
                 device=None):
        self.device = (executor.device if isinstance(executor, Executor)
                       and device is None else resolve_device(device))
        self.cache = CtCache(cache_budget_bytes)
        self.executor: Executor = (
            executor if isinstance(executor, Executor)
            else make_executor(executor, dtype=dtype, device=self.device))
        self.tracer = tracer if tracer is not None else default_tracer()
        self.cache.tracer = self.tracer
        self.max_batch_size = max_batch_size
        self._dtype = dtype
        self._svc_kw = dict(max_batch_size=max_batch_size,
                            max_wait_s=max_wait_s,
                            max_in_flight=max_in_flight,
                            max_pending_bytes=max_pending_bytes,
                            use_butterfly=use_butterfly)
        self._lock = threading.Lock()
        self._tenants: "OrderedDict[str, Tenant]" = OrderedDict()
        # one score memo for the whole fleet: tenant-prefixed version
        # tokens keep entries disjoint (see discover.providers)
        self._score_memo: Dict[Tuple, float] = {}

    # -- fleet management ----------------------------------------------------
    def add_tenant(self, tenant_id: str, db, *,
                   reserved_bytes: int = 0,
                   cache_cap_bytes: Optional[int] = None,
                   admission_max: Optional[int] = None,
                   admission_policy: str = "queue",
                   rate_limit: Optional[Tuple[int, float]] = None,
                   **overrides) -> Tenant:
        """Register a logical database under ``tenant_id``.

        Args:
            db: a :class:`~repro_torch.core.database.RelationalDB` (joins the
                shared cache/executor pool) or a
                :class:`~repro_torch.core.database.ShardedDatabase` (fronted by
                its own :class:`~repro_torch.serve.router.CountingRouter`;
                per-shard caches stay private to the tenant).
            reserved_bytes: cache floor — global eviction pressure from
                OTHER tenants can never push this tenant's resident bytes
                below it.
            cache_cap_bytes: cache ceiling — this tenant's own entries
                are evicted (its own LRU first) once it crosses it.
            admission_max: per-tenant pending-query bound (``None``
                disables the gate).
            admission_policy: ``"queue"`` (flooder drains its own queue
                inline) or ``"shed"`` (raise
                :class:`~repro_torch.serve.service.TenantAdmissionError`).
            rate_limit: per-tenant token bucket ``(n, window_s)`` — at
                most ``n`` newly admitted queries per ``window_s``
                seconds, enforced per ``admission_policy`` (see
                :class:`~repro_torch.serve.service.CountingService`); ``None``
                disables it.
            **overrides: per-tenant overrides of the registry's service
                keywords (``max_in_flight``, ``max_pending_bytes``, ...).

        Returns:
            The new :class:`Tenant` record.

        Raises:
            ValueError: duplicate ``tenant_id``.

        Usage::

            reg.add_tenant("acme", db, reserved_bytes=4 << 20,
                           admission_max=256, admission_policy="shed")
        """
        with self._lock:
            if tenant_id in self._tenants:
                raise ValueError(f"tenant {tenant_id!r} already registered")
        svc_kw = dict(self._svc_kw)
        svc_kw.update(overrides)
        if isinstance(db, ShardedDatabase):
            router_kw = {k: v for k, v in svc_kw.items()
                         if k != "use_butterfly"}
            router = CountingRouter(db, executor=self.executor,
                                    dtype=self._dtype, tracer=self.tracer,
                                    tenant=tenant_id, device=self.device,
                                    **router_kw)
            tenant = Tenant(tenant_id, db, router=router)
        else:
            handle = self.cache.scoped(tenant_id)
            self.cache.set_tenant_budget(tenant_id,
                                         reserved_bytes=reserved_bytes,
                                         cap_bytes=cache_cap_bytes)
            eng = CountingEngine(db, self.executor, CostStats(),
                                 cache=handle, dtype=self._dtype,
                                 device=self.device)
            handle.stats = eng.stats   # mirror cache bytes into CostStats
            svc = CountingService(eng, metrics=ServiceMetrics(),
                                  tracer=self.tracer, tenant=tenant_id,
                                  admission_max=admission_max,
                                  admission_policy=admission_policy,
                                  rate_limit=rate_limit,
                                  **svc_kw)
            tenant = Tenant(tenant_id, db, engine=eng, service=svc)
        with self._lock:
            if tenant_id in self._tenants:      # lost a registration race
                raise ValueError(f"tenant {tenant_id!r} already registered")
            self._tenants[tenant_id] = tenant
        return tenant

    def remove_tenant(self, tenant_id: str) -> None:
        """Shut the tenant's frontend down, evict its cache entries, and
        release its reservation."""
        with self._lock:
            tenant = self._tenants.pop(tenant_id)
        self._shutdown_tenant(tenant)
        if tenant.service is not None:
            self.cache.set_tenant_budget(tenant_id, reserved_bytes=0,
                                         cap_bytes=None)
            self.cache.evict_all(tenant=tenant_id)

    def tenant(self, tenant_id: str) -> Tenant:
        """Look one tenant up (raises ``KeyError`` if unregistered)."""
        with self._lock:
            try:
                return self._tenants[tenant_id]
            except KeyError:
                raise KeyError(f"unknown tenant {tenant_id!r}; registered: "
                               f"{list(self._tenants)}") from None

    def tenant_ids(self) -> List[str]:
        with self._lock:
            return list(self._tenants)

    def set_tenant_budget(self, tenant_id: str, reserved_bytes: int = 0,
                          cap_bytes: Optional[int] = None) -> None:
        """Re-budget a live tenant (floor + optional cap; a cap below
        current residency shrinks immediately)."""
        self.tenant(tenant_id)         # raise on unknown ids
        self.cache.set_tenant_budget(tenant_id, reserved_bytes=reserved_bytes,
                                     cap_bytes=cap_bytes)

    # -- per-tenant pass-throughs --------------------------------------------
    def count(self, tenant_id: str, point: LatticePoint,
              keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Synchronous single count against one tenant."""
        return self.tenant(tenant_id).frontend.count(point, keep)

    def count_complete(self, tenant_id: str, point: LatticePoint,
                       keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Synchronous single complete-CT query against one tenant."""
        return self.tenant(tenant_id).frontend.count_complete(point, keep)

    def complete_many(self, tenant_id: str, queries) -> List[CtTable]:
        """One tenant's complete-CT flood (batched within the tenant)."""
        return self.tenant(tenant_id).frontend.complete_many(queries)

    def apply_delta(self, tenant_id: str, rel: str, src, dst, attrs=None,
                    **kw):
        """Write facts into ONE tenant's database.  Only that tenant's
        cache entries and score-memo token move; every other tenant's
        warm state is untouched (that is the isolation the scoped cache
        and tenant-prefixed version tokens buy)."""
        fe = self.tenant(tenant_id).frontend
        return fe.insert_facts(rel, src, dst, attrs, **kw)

    def update_attrs(self, tenant_id: str, etype: str, rows, attrs, **kw):
        """Write entity attributes into ONE tenant's database, fenced and
        reconciled like :meth:`apply_delta` — entries of OTHER tenants
        sharing the pool are untouched (their scoped cache views carry
        different tenant tags)."""
        fe = self.tenant(tenant_id).frontend
        return fe.update_attrs(etype, rows, attrs, **kw)

    def discovery(self, tenant_id: str, **kwargs):
        """The tenant's model-discovery service, sharing the fleet-wide
        score memo (built lazily on first call per tenant)."""
        kwargs.setdefault("memo", self._score_memo)
        return self.tenant(tenant_id).frontend.discovery(**kwargs)

    # -- cross-tenant fused dispatch -----------------------------------------
    def count_many(self, queries: Sequence[TenantQuery]) -> List[CtTable]:
        """Count a mixed-tenant query list with cross-tenant batching.

        Queries from different tenants whose plans share a stack
        signature ride ONE evaluation on the shared executor; results are
        routed back through each tenant's own delivery path, so caches,
        metrics, and spans stay per-tenant.

        Args:
            queries: ``(tenant_id, point, keep)`` triples.

        Returns:
            One :class:`~repro_torch.core.ct.CtTable` per query, positionally
            aligned with ``queries``.

        Usage::

            tabs = reg.count_many([("a", p, None), ("b", p, None)])
        """
        tickets: List[CountTicket] = []
        involved: "OrderedDict[str, Tenant]" = OrderedDict()
        for tid, _, _ in queries:
            if tid not in involved:
                involved[tid] = self.tenant(tid)
        with ExitStack() as stack:
            # suspend inline drains so every tenant's whole share of the
            # flood is queued before anything executes (backpressure and
            # admission bounds stay armed)
            for t in involved.values():
                if t.service is not None:
                    stack.enter_context(t.service.defer_drains())
            for tid, point, keep in queries:
                tickets.append(involved[tid].frontend.submit(point, keep))
            self._execute_cross_tenant(
                [t.service for t in involved.values()
                 if t.service is not None])
        for t in involved.values():            # sharded tenants batch
            if t.router is not None:           # within the tenant
                t.router.flush()
        return [tk.result() for tk in tickets]

    def _execute_cross_tenant(self,
                              services: Sequence[CountingService]) -> None:
        """Drain every service and run all positives through ONE
        cross-tenant bucketed dispatch; completes fall back to each
        tenant's normal path (their Möbius phase is engine-resident)."""
        drained = [(svc, svc.drain_pending()) for svc in services]
        pos: List[Tuple[CountingService, object]] = []
        for svc, entries in drained:
            pos.extend((svc, e) for e in entries if not e.complete)
        if pos:
            tr = self.tracer
            try:
                with (torch.cuda.device(self.device)
                      if self.device.type == "cuda" else nullcontext()):
                    tabs = execute_bucketed_multi(
                        self.executor,
                        [svc.engine.db for svc, _ in pos],
                        [e.plan for _, e in pos],
                        [svc.engine.stats for svc, _ in pos],
                        max_batch_size=self.max_batch_size,
                        metrics_list=[svc.metrics for svc, _ in pos],
                        tracer=tr if tr.enabled else NULL_TRACER)
            except BaseException as err:
                # settle EVERY drained entry (positives and completes):
                # they are out of their queues, so an unsettled waiter
                # would hang forever
                for svc, entries in drained:
                    for e in entries:
                        if e.result is None and e.error is None:
                            e.error = err
                    svc._settle_all(entries)
                raise
            by_svc: Dict[int, Tuple[CountingService, list]] = {}
            for (svc, e), tab in zip(pos, tabs):
                by_svc.setdefault(id(svc), (svc, []))[1].append((e, tab))
            for svc, delivered in by_svc.values():
                svc.deliver_external(delivered)
        for svc, entries in drained:
            completes = [e for e in entries if e.complete]
            if completes:
                svc.execute_drained(completes)

    # -- fleet-wide control --------------------------------------------------
    def flush_all(self) -> None:
        """Drain and execute every tenant's pending queue (per-tenant
        paths; use :meth:`count_many` for the fused dispatch)."""
        for t in self._snapshot_tenants():
            t.frontend.flush()

    def shutdown(self, drain: bool = True) -> None:
        """Shut every tenant's frontend down."""
        for t in self._snapshot_tenants():
            self._shutdown_tenant(t, drain=drain)

    @staticmethod
    def _shutdown_tenant(tenant: Tenant, drain: bool = True) -> None:
        if tenant.service is not None:
            tenant.service.shutdown(drain=drain)
        else:                          # routers front one service per shard
            tenant.router.shutdown(drain=drain)

    def _snapshot_tenants(self) -> List[Tenant]:
        with self._lock:
            return list(self._tenants.values())

    # -- observability -------------------------------------------------------
    def stats(self) -> dict:
        """Fleet health rollup.

        Returns:
            ``{"tenants": {tid: frontend.stats()}, "aggregate": deep
            numeric merge across tenants, "cache": shared store info
            (with per-tenant residency/floor/cap sub-dicts)}``.

        Usage::

            reg.stats()["tenants"]["acme"]["enqueued"]
            reg.stats()["aggregate"]["cache"]["hits"]
        """
        tenants = {t.tenant_id: t.frontend.stats()
                   for t in self._snapshot_tenants()}
        # sharded tenants already publish a service-shaped "aggregate"
        # sub-dict; plain tenants' snapshots are service-shaped directly
        parts = [snap.get("aggregate", snap) for snap in tenants.values()]
        return {"tenants": tenants,
                "aggregate": merge_stats_dicts(parts),
                "cache": self.cache.info()}
