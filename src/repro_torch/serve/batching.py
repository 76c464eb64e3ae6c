"""Bucketed plan execution: the bridge between shape-signature batching and
the executors' stacked entry point.

A scheduler thinks in *shape signatures*
(:meth:`~repro_torch.core.plan.ContractionPlan.shape_signature`); the
executors stack on the stricter
:func:`~repro_torch.core.executors.plan_stack_key` (same topology AND array
sizes).  :func:`execute_bucketed` sits between the two: it chops an
arbitrary mix of compiled plans into same-shape micro-batches of at most
``max_batch_size``, hands each to
:meth:`~repro_torch.core.executors.Executor.positive_batch` (which
re-groups by stack key and stacks what it can, loops what it can't), and
reports each micro-batch's latency to ``metrics``.

:func:`execute_complete_bucketed` is the same bridge for **complete-CT
queries** (positive + Möbius negative phase): the positive sub-queries of
every complete query are enumerated up front
(:func:`~repro_torch.core.mobius.positive_queries`), deduplicated through
the positive policy, and executed via :func:`execute_bucketed`; the
negative phase then runs through
:func:`~repro_torch.core.mobius.complete_ct_many`, which groups same-shape
butterfly stacks and transforms each group in one launch.

:func:`execute_bucketed_multi` is :func:`execute_bucketed` over many
databases (the tenants of one registry): same-shape plans of different
databases share a micro-batch and one evaluation
(:meth:`~repro_torch.core.executors.Executor.positive_batch_multi`).
:class:`TableMerger` sums a sharded router's per-shard tables, batched by
shape (:func:`~repro_torch.core.ct.sum_partials`).

``metrics`` is duck-typed: anything with ``observe_batch(sig, n, seconds)``
and ``observe_mobius(n_stacks, seconds)``.  Latencies are host-clock
seconds around the dispatch; where ``metrics`` is given, each dispatch
ends with a synchronisation of the device, so on the card they hold the
kernels' time and not only the time it took to enqueue them.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.contract import CostStats
from ..core.ct import CtTable, sum_partials
from ..core.database import RelationalDB
from ..core.device import synchronize
from ..core.engine import CountingEngine
from ..core.executors import Executor
from ..core.mobius import complete_ct_many, positive_queries
from ..core.plan import ContractionPlan, group_by_signature
from ..core.variables import CtVar, LatticePoint
from ..obs.trace import NULL_TRACER, NullTracer


class TableMerger:
    """Device-side sum of a sharded router's per-shard count tables.

    Count-table merging is exact addition, so it runs where the tables
    are: same-shape shard tables — across MANY queries at once — are
    stacked and summed in ONE ``torch.sum`` per ``(n_partials, shape)``
    group (:func:`~repro_torch.core.ct.sum_partials`), instead of
    ``n_shards - 1`` adds per query.  Stateless, so one instance serves
    concurrent floods.

    Usage::

        merged, n = TableMerger().merge_tables([[tab_shard0, tab_shard1]])
    """

    def reduce_arrays(self, arrays: Sequence[torch.Tensor]) -> torch.Tensor:
        """Sum one query's partial count tensors (same shape) in one
        stacked sum — the overlapped path's partial fold."""
        arrays = list(arrays)
        if len(arrays) == 1:
            return arrays[0]
        return torch.sum(torch.stack(arrays), dim=0)

    def merge_tables(self, per_query: Sequence[Sequence[CtTable]]
                     ) -> Tuple[List[CtTable], int]:
        """Merge many queries' per-shard tables, batched by shape.

        Args:
            per_query: one list of same-``vars`` shard tables per query
                (per-shard plans are compiled against the same schema, so
                one query's shard tables align axis for axis).

        Returns:
            ``(merged, dispatches)``: one merged table per query in input
            order, and the number of stacked sums issued.

        Usage::

            merged, n_disp = merger.merge_tables(shard_tables)
        """
        return sum_partials(per_query)


def execute_bucketed(executor: Executor, db: RelationalDB,
                     plans: Sequence[ContractionPlan],
                     stats: Optional[CostStats] = None,
                     max_batch_size: Optional[int] = None,
                     metrics=None,
                     tracer: NullTracer = NULL_TRACER) -> List[CtTable]:
    """Evaluate ``plans`` in shape-signature micro-batches.

    Results align positionally with ``plans`` and are bit-identical to
    per-plan :meth:`~repro_torch.core.executors.Executor.positive`
    execution; only the dispatch granularity changes.

    Args:
        executor: the backend to evaluate with.
        db: the database the plans were compiled against.
        plans: compiled :class:`~repro_torch.core.plan.ContractionPlan`
            list.
        stats: optional :class:`~repro_torch.core.contract.CostStats` for
            join/row accounting.
        max_batch_size: cap per micro-batch (``None``/0 = one batch per
            signature bucket).
        metrics: optional sink with ``observe_batch(sig, n, seconds)``,
            called once per micro-batch (after a synchronisation).
        tracer: optional tracer; each micro-batch dispatch becomes a
            ``batch.dispatch`` span.

    Returns:
        One :class:`~repro_torch.core.ct.CtTable` per plan, in input order.

    Usage::

        tabs = execute_bucketed(engine.executor, db, plans, engine.stats)
    """
    results: List[Optional[CtTable]] = [None] * len(plans)
    for sig, idxs in group_by_signature(plans, key="shape").items():
        step = max(max_batch_size or len(idxs), 1)
        for s in range(0, len(idxs), step):
            chunk = idxs[s:s + step]
            span = (tracer.span("batch.dispatch", sig=sig,
                                queries=len(chunk))
                    if tracer.enabled else nullcontext())
            t0 = time.perf_counter()
            with span:
                tabs = executor.positive_batch(db, [plans[i] for i in chunk],
                                               stats)
                if metrics is not None:
                    synchronize(executor.device)
            if metrics is not None:
                metrics.observe_batch(sig, len(chunk),
                                      time.perf_counter() - t0)
            for i, tab in zip(chunk, tabs):
                results[i] = tab
    return results                                         # type: ignore


def execute_bucketed_multi(executor: Executor,
                           dbs: Sequence[RelationalDB],
                           plans: Sequence[ContractionPlan],
                           stats_list: Optional[Sequence[
                               Optional[CostStats]]] = None,
                           max_batch_size: Optional[int] = None,
                           metrics_list: Optional[Sequence] = None,
                           tracer: NullTracer = NULL_TRACER
                           ) -> List[CtTable]:
    """:func:`execute_bucketed` across MANY databases — the cross-tenant
    dispatch path.  Item ``i`` is ``plans[i]`` against ``dbs[i]``; plans
    from different databases that share a shape signature land in the same
    micro-batch and, when their stack keys match too, the same evaluation
    (:meth:`~repro_torch.core.executors.Executor.positive_batch_multi`:
    one K1/K2 launch per hop step of the group on the card).

    Args:
        executor: the SHARED backend.
        dbs: one database per plan.
        plans: compiled plans, positionally paired with ``dbs``.
        stats_list: optional per-item :class:`~repro_torch.core.contract
            .CostStats` (each tenant engine's).
        max_batch_size: cap per micro-batch (``None``/0 = one batch per
            signature bucket).
        metrics_list: optional per-item metrics sinks; each distinct sink
            in a micro-batch receives one ``observe_batch`` with its own
            query count and its share of the dispatch's seconds (after a
            synchronisation, as in :func:`execute_bucketed`).
        tracer: optional tracer; each micro-batch becomes a
            ``batch.dispatch`` span carrying the database fan-in.

    Returns:
        One :class:`~repro_torch.core.ct.CtTable` per item, in input order.

    Usage::

        tabs = execute_bucketed_multi(executor, dbs, plans)
    """
    results: List[Optional[CtTable]] = [None] * len(plans)
    for sig, idxs in group_by_signature(plans, key="shape").items():
        step = max(max_batch_size or len(idxs), 1)
        for s in range(0, len(idxs), step):
            chunk = idxs[s:s + step]
            c_dbs = [dbs[i] for i in chunk]
            span = (tracer.span("batch.dispatch", sig=sig,
                                queries=len(chunk),
                                dbs=len({id(d) for d in c_dbs}))
                    if tracer.enabled else nullcontext())
            t0 = time.perf_counter()
            with span:
                tabs = executor.positive_batch_multi(
                    c_dbs, [plans[i] for i in chunk],
                    [stats_list[i] for i in chunk]
                    if stats_list is not None else None)
                if metrics_list is not None:
                    synchronize(executor.device)
            dt = time.perf_counter() - t0
            if metrics_list is not None:
                shares: Dict[int, Tuple[object, int]] = {}
                for i in chunk:
                    m = metrics_list[i]
                    if m is not None:
                        _, n = shares.get(id(m), (m, 0))
                        shares[id(m)] = (m, n + 1)
                for m, n in shares.values():
                    m.observe_batch(sig, n, dt * n / len(chunk))
            for i, tab in zip(chunk, tabs):
                results[i] = tab
    return results                                         # type: ignore


def execute_complete_bucketed(engine: CountingEngine, policy,
                              queries: Sequence[Tuple[LatticePoint,
                                                      Sequence[CtVar]]],
                              stats: Optional[CostStats] = None,
                              max_batch_size: Optional[int] = None,
                              metrics=None,
                              use_butterfly: bool = True) -> List[CtTable]:
    """Evaluate complete-CT queries (positive + negative phases) batched.

    Phase 1 (positive): the positive sub-queries every query's Möbius join
    will issue are enumerated, filtered to what ``policy`` would contract
    from data (:meth:`~repro_torch.core.engine._Policy.batchable_misses`),
    executed through :func:`execute_bucketed`, and absorbed back into the
    policy's cache.  Phase 2 (negative):
    :func:`~repro_torch.core.mobius.complete_ct_many` assembles each
    query's butterfly stack from the warmed cache and transforms
    same-shape groups in one launch each.

    Results align positionally with ``queries`` and are identical to
    per-query :func:`~repro_torch.core.mobius.complete_ct`.  Time
    accounting matches the strategy path: data access lands in
    ``time_positive``, the transform in ``time_negative`` (disjointly).

    Args:
        engine: the planner/executor/cache stack to execute against.
        policy: a positive policy from :mod:`repro_torch.core.engine`
            (``batchable_misses``/``absorb``/``positive``/``hist``).
        queries: ``(point, keep)`` pairs; ``keep`` may contain attr and
            rind axes.
        stats: optional :class:`~repro_torch.core.contract.CostStats`.
        max_batch_size: positive-phase micro-batch cap (see
            :func:`execute_bucketed`).
        metrics: optional sink with ``observe_batch`` (per positive
            micro-batch) and ``observe_mobius(n_stacks, seconds)`` (per
            batched transform).
        use_butterfly: evaluation order, as in
            :func:`~repro_torch.core.mobius.complete_ct`.

    Returns:
        One complete :class:`~repro_torch.core.ct.CtTable` per query.

    Usage::

        tabs = execute_complete_bucketed(engine, policy, queries)
    """
    queries = [(point, tuple(keep)) for point, keep in queries]
    pos: List[Tuple[LatticePoint, Tuple[CtVar, ...]]] = []
    for point, keep in queries:
        pos.extend(positive_queries(point, keep, use_butterfly))
    todo = policy.batchable_misses(pos)
    tracer = getattr(engine, "tracer", NULL_TRACER)
    if todo:
        plans = [engine.plan(p, k) for p, k in todo]
        with (stats.timer("positive") if stats is not None
              else nullcontext()):
            tabs = execute_bucketed(engine.executor, engine.db, plans,
                                    stats, max_batch_size, metrics,
                                    tracer=tracer)
        for (p, _), plan, tab in zip(todo, plans, tabs):
            policy.absorb(p, plan.keep, tab)

    fused_fn = engine.mobius_fused_fn()
    if metrics is not None or tracer.enabled:
        inner_fused = fused_fn

        def fused_fn(blocks, k, perm):
            with (tracer.span("mobius.dispatch", stacks=len(blocks), k=k)
                  if tracer.enabled else nullcontext()):
                t0 = time.perf_counter()
                out = inner_fused(blocks, k, perm)
                if metrics is not None:
                    synchronize(engine.device)
                dt = time.perf_counter() - t0
            if metrics is not None:
                metrics.observe_mobius(len(blocks), dt)
            return out

    # residual data access (unwarmed misses, eviction recomputes) times
    # itself in the policy; the disjoint timer subtracts its growth to keep
    # the Fig. 3 decomposition disjoint
    with (stats.disjoint_timer("negative") if stats is not None
          else nullcontext()):
        return complete_ct_many(queries, policy, stats,
                                use_butterfly=use_butterfly,
                                mobius_fn=engine.mobius_fn(),
                                mobius_fused_fn=fused_fn)
