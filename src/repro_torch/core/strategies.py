"""PRECOUNT / ONDEMAND / HYBRID / TUPLEID counts-caching strategies
(paper Algs. 1-3 + the tuple-ID future-work variant).

All four expose the same interface to structure search:

    prepare(db, lattice)                    # pre-search phase
    family_ct(point, keep_vars) -> CtTable  # during search

and record the paper's instrumentation (Fig. 3 time decomposition into
metadata / positive / negative, Fig. 4 memory, Table 5 ct sizes) in
``stats``.

Each strategy is a *thin policy* over shared machinery
(:mod:`repro_torch.core.engine`): it picks a positive-table policy, decides
what runs at ``prepare`` time vs. search time, and shares one
byte-budgeted :class:`~repro_torch.core.cache.CtCache` across positives,
messages, family memos and histograms.  The contraction backend is
pluggable (``executor="dense" | "sparse"``), the counting device is
``device`` (``None`` = the CUDA card), and the Möbius negative phase runs
through the executor (the K3 kernel on the card), or through a
``mobius_fn`` override.

* PRECOUNT — prepare() contracts the positive ct-table for every lattice
  point AND runs the Möbius join to the complete table over *all* variables
  of the point; family_ct() is a pure projection, summed in float64 and
  rounded once (the complete table's negative cells pass 2^24, where a
  float32 sum of many of them drifts).  Pays the Eq. (3) blowup.
* ONDEMAND — prepare() builds only per-variable histograms (metadata);
  family_ct() contracts the family's positive tables from the raw data (the
  expensive JOINs, re-run per family) then runs a small Möbius join.
* HYBRID — prepare() contracts and caches only the *positive* ct-table per
  lattice point (JOINs once, like PRECOUNT); family_ct() projects the
  cached positives down to the family and runs a small Möbius join (like
  ONDEMAND, but with zero data access).
* TUPLEID — prepare() caches per-relationship message matrices (tuple-ID
  propagation); family positives recombine them with zero edge access.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

import torch

from .contract import CostStats
from .ct import CtTable
from .database import RelationalDB
from .device import resolve_device
from .engine import (CachedFullPositives, CountingEngine, OnDemandPositives,
                     TupleIdPositives)
from .mobius import (butterfly_batch, complete_ct, complete_ct_many,
                     positive_queries)
from .variables import CtVar, LatticePoint


#: micro-batch cap of :meth:`Strategy.prefetch`, the JAX package's
#: ``CountingService`` default ``max_batch_size``
PREFETCH_BATCH = 64


def _freeze(point: LatticePoint, keep: Sequence[CtVar]) -> Tuple:
    return (point.atoms, tuple(keep))


def _project_wide(table: CtTable, keep: Sequence[CtVar]) -> CtTable:
    """``table.project(keep)`` summed in float64 and rounded once to the
    table's dtype.  A complete table's cells are integers below 2^53 in
    float64, so the sum is exact in any order: the family is the correctly
    rounded projection on every device, where a float32 sum over many
    cells past 2^24 drifts by many units in the last place, and by a
    different amount on each device."""
    wide = CtTable(table.vars, table.counts.double()).project(keep)
    return CtTable(wide.vars, wide.counts.to(table.counts.dtype))


@dataclass
class Strategy:
    """Base policy: shared engine, unified family memo, Möbius wiring.

    Subclasses set ``_policy_cls`` and ``_precount_complete`` /
    ``_warm_hists`` flags — everything else (caching, stats, executor and
    Möbius dispatch) lives in the shared machinery.
    """

    name: str = "base"
    dtype: object = torch.float32
    use_butterfly: bool = True
    mobius_fn: Optional[object] = None     # overrides the executor's step
    stats: CostStats = field(default_factory=CostStats)
    executor: object = "dense"             # name or Executor instance
    cache_budget_bytes: Optional[int] = None
    device: object = None                  # None = the CUDA card

    _policy_cls = None                     # set by subclasses
    _precount_complete = False             # PRECOUNT: complete tables upfront
    _warm_hists = False                    # ONDEMAND: hists are the metadata

    def __post_init__(self) -> None:
        self.device = resolve_device(self.device)

    # -- pre-search phase ----------------------------------------------------
    def prepare(self, db: RelationalDB,
                lattice: Sequence[LatticePoint]) -> None:
        self.db, self.lattice = db, list(lattice)
        with self.stats.timer("metadata"):
            from .executors import make_executor
            ex = make_executor(self.executor, dtype=self.dtype,
                               device=self.device)
            self.engine = CountingEngine(
                db, ex, self.stats,
                cache_budget_bytes=self.cache_budget_bytes, dtype=self.dtype,
                device=self.device)
            self.provider = self._policy_cls(self.engine)
            self._rows_counted = set()
            if self._warm_hists:
                for point in lattice:
                    for v in point.vars:
                        self.provider.hist(v, ())
        # data access inside the policy times itself (-> time_positive),
        # including any eviction-driven recompute later on
        self.provider.precompute(lattice)
        if self._precount_complete:
            for point in lattice:
                self._complete_full(point)

    # -- complete tables -----------------------------------------------------
    def _mobius_fn(self):
        return self.mobius_fn if self.mobius_fn is not None \
            else self.engine.executor.mobius

    def _timed_complete(self, point: LatticePoint,
                        keep: Tuple[CtVar, ...]) -> CtTable:
        """Möbius join timed as negative-phase work; positive contractions
        nested inside it (ONDEMAND joins, eviction recomputes) time
        themselves in the policy, so the disjoint timer subtracts that
        growth to keep the Fig. 3 decomposition disjoint."""
        with self.stats.disjoint_timer("negative"):
            return complete_ct(point, keep, self.provider, self.stats,
                               use_butterfly=self.use_butterfly,
                               mobius_fn=self._mobius_fn())

    def _complete_full(self, point: LatticePoint) -> CtTable:
        """Complete (positive+negative) table over *all* axes of a point —
        the PRECOUNT global ct.  Cached; recomputed if evicted."""
        keep = tuple(point.all_ct_vars(self.db.schema, include_rind=True))
        key = ("complete", point.atoms, keep)
        hit = self.engine.cache.get(key)
        if hit is None:
            hit = self._timed_complete(point, keep)
            if key not in self._rows_counted:    # once per point, not per
                self._rows_counted.add(key)      # eviction recompute
                self.stats.ct_rows += hit.nnz_rows()
            self.engine.cache.put(key, hit)
        return hit

    # -- search phase --------------------------------------------------------
    def family_ct(self, point: LatticePoint,
                  keep: Sequence[CtVar]) -> CtTable:
        if self._precount_complete:
            return _project_wide(self._complete_full(point), keep)
        key = ("fam",) + _freeze(point, keep)
        hit = self.engine.cache.get(key)
        if hit is not None:
            return hit
        tab = self._timed_complete(point, tuple(keep))
        self.engine.cache.put(key, tab)
        return tab

    def _mobius_batch_fn(self):
        """The batched negative-phase step, honouring a ``mobius_fn``
        override the same way :meth:`_mobius_fn` does."""
        if self.mobius_fn is not None:
            return lambda stacks, k: butterfly_batch(stacks, k,
                                                     self.mobius_fn)
        return self.engine.executor.mobius_batch

    def _mobius_fused_fn(self):
        """The FUSED batched negative phase (assembly + transform +
        finalise per shape/perm group).  A ``mobius_fn`` override opts
        out and takes the unfused batched path."""
        if self.mobius_fn is not None:
            return None
        return self.engine.executor.mobius_batch_fused

    # -- mutations -----------------------------------------------------------
    def apply_delta(self, delta, **kw):
        """Reconcile this strategy's cache after a store mutation —
        delegates to :meth:`~repro_torch.core.engine.CountingEngine
        .apply_delta` (fine-grained invalidation + in-place delta updates
        of positive and derived tables).

        Usage::

            delta = db.insert_facts("Rated", src, dst, {"rating": vals})
            report = strategy.apply_delta(delta)
        """
        return self.engine.apply_delta(delta, **kw)

    def prefetch(self, queries: Sequence[Tuple[LatticePoint,
                                               Tuple[CtVar, ...]]]) -> int:
        """Warm the positive policy's cache for ``queries``: the queries
        the policy would have to count from data
        (:meth:`~repro_torch.core.engine._Policy.batchable_misses`) run in
        shape-signature micro-batches of at most ``PREFETCH_BATCH``
        through :func:`~repro_torch.serve.batching.execute_bucketed`
        (stack-compatible plans as one flattened evaluation,
        :meth:`~repro_torch.core.executors.Executor.positive_batch`), and
        each table goes back through the policy's absorb hook.  Runs on
        the calling thread; batched equals unbatched, so the tables are
        those the Möbius join would have contracted on its own.

        Returns:
            The number of queries contracted (cache misses).
        """
        from ..serve.batching import execute_bucketed
        todo = self.provider.batchable_misses(list(queries))
        if not todo:
            return 0
        eng = self.engine
        plans = [eng.plan(point, keep) for point, keep in todo]
        with self.stats.timer("positive"):
            tabs = execute_bucketed(eng.executor, eng.db, plans, self.stats,
                                    max_batch_size=PREFETCH_BATCH,
                                    tracer=eng.tracer)
        for (point, _), plan, tab in zip(todo, plans, tabs):
            self.provider.absorb(point, plan.keep, tab)
        return len(todo)

    def family_ct_many(self, point: LatticePoint,
                       keeps: Sequence[Sequence[CtVar]]) -> list:
        """Fetch a whole round of family tables at once.

        The positive sub-queries every missing family's Möbius join will
        issue are enumerated up front (:func:`~repro_torch.core.mobius
        .positive_queries`) and the policy's misses among them are
        contracted first (:meth:`prefetch`).  The *negative* phase of the
        missing families then runs through
        :func:`~repro_torch.core.mobius.complete_ct_many`: butterfly input
        stacks are grouped by shape (same-signature families are
        same-shape by construction) and each group is transformed in ONE
        launch (:meth:`~repro_torch.core.executors.Executor
        .mobius_batch_fused`).  Results — including the recompute
        semantics under cache eviction — are numerically identical to
        per-family :meth:`family_ct`."""
        keeps = [tuple(k) for k in keeps]
        if self._precount_complete or len(keeps) <= 1:
            return [self.family_ct(point, keep) for keep in keeps]
        cache = self.engine.cache
        missing = [keep for keep in keeps
                   if ("fam",) + _freeze(point, keep) not in cache]
        missing = list(dict.fromkeys(missing))
        if missing and self.provider.supports_batch_prefetch:
            queries = []
            for keep in missing:
                queries.extend(positive_queries(point, keep,
                                                self.use_butterfly))
            self.prefetch(queries)
        fresh = {}
        if missing:
            with self.stats.disjoint_timer("negative"):
                tabs = complete_ct_many(
                    [(point, keep) for keep in missing], self.provider,
                    self.stats, use_butterfly=self.use_butterfly,
                    mobius_fn=self._mobius_fn(),
                    mobius_batch_fn=self._mobius_batch_fn(),
                    mobius_fused_fn=self._mobius_fused_fn())
            for keep, tab in zip(missing, tabs):
                cache.put(("fam",) + _freeze(point, keep), tab)
                fresh[keep] = tab      # return directly: under a tight
                                       # budget the puts may evict each
                                       # other, and a cache round-trip
                                       # would recompute per family
        return [fresh[keep] if keep in fresh
                else self.family_ct(point, keep) for keep in keeps]


class OnDemand(Strategy):
    _policy_cls = OnDemandPositives
    _warm_hists = True

    def __init__(self, **kw):
        super().__init__(name="ONDEMAND", **kw)


class Precount(Strategy):
    _policy_cls = CachedFullPositives
    _precount_complete = True

    def __init__(self, **kw):
        super().__init__(name="PRECOUNT", **kw)


class Hybrid(Strategy):
    _policy_cls = CachedFullPositives

    def __init__(self, **kw):
        super().__init__(name="HYBRID", **kw)


class TupleId(Strategy):
    """The paper's future-work pre-count variant: tuple-ID propagation."""

    _policy_cls = TupleIdPositives

    def __init__(self, **kw):
        super().__init__(name="TUPLEID", **kw)


STRATEGIES = {"PRECOUNT": Precount, "ONDEMAND": OnDemand, "HYBRID": Hybrid,
              "TUPLEID": TupleId}


def make_strategy(name: str, **kw) -> Strategy:
    """Build a strategy by name.  Keyword arguments are the
    :class:`Strategy` fields, among them ``executor`` (``"dense"`` |
    ``"sparse"``), ``cache_budget_bytes`` and ``device`` (``None`` = the
    CUDA card; pass ``device="cpu"`` to count on the host)."""
    return STRATEGIES[name.upper()](**kw)
