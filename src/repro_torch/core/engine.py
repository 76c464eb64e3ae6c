"""Counting engine: planner + executor + cache, shared by every strategy.

A :class:`CountingEngine` owns

* the database handle,
* one :class:`~repro_torch.core.executors.Executor` (``"dense"`` or
  ``"sparse"``) on one device,
* one :class:`~repro_torch.core.cache.CtCache` (byte-budgeted LRU, shared
  by all namespaces: positives, messages, family tables, histograms),
* the shared :class:`~repro_torch.core.contract.CostStats` instrumentation.

On top sit three *positive-table policies* — they all satisfy the
:class:`~repro_torch.core.mobius.PositiveProvider` protocol consumed by the
Möbius join, and differ only in WHEN joins run and WHAT is cached:

* :class:`OnDemandPositives` — contract from raw data per request, memoise
  the result (the paper's post-counting data access pattern);
* :class:`CachedFullPositives` — contract each lattice point once at full
  attribute resolution up front; serve requests by projection
  (PRECOUNT / HYBRID pre-counting);
* :class:`TupleIdPositives` — cache per-(relationship, direction) message
  matrices up front (tuple-ID propagation, Yin et al. 2004); serve
  requests by projecting + recombining cached messages with zero edge
  table access.

Eviction is always safe: every policy recomputes on miss.  Cache entries
are stamped with the ``(db.version, dependency-tag set)`` they were
computed under (:func:`key_deps` derives the tags from the key itself).
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Hashable, List, Optional, Sequence, Set, Tuple

import torch

from ..obs.trace import NULL_TRACER
from .cache import CtCache
from .contract import CostStats
from .ct import CtTable
from .database import RelationalDB
from .device import resolve_device
from .executors import Executor, make_executor, project_columns
from .plan import ContractionPlan, compile_plan_cached
from .variables import Atom, CtVar, LatticePoint, Var, attr_var, edge_var


def _attr_tags(keep) -> Set[Tuple]:
    """``("attr", etype, name)`` tags for the entity-attr axes of a keep
    tuple (edge-attr and rind axes are covered by the relation name)."""
    return {("attr", v.owner[0].etype, v.owner[1])
            for v in keep if v.kind == "attr"}


def key_deps(key: Tuple) -> Optional[FrozenSet[Hashable]]:
    """The dependency tags a cache entry was derived from, read off the
    key itself (every namespace embeds its pattern).  Tags mix relationship
    names (edge-table dependencies) with ``("attr", etype, name)`` tuples
    (entity-attribute-column dependencies) and the ``("attr*", etype)``
    wildcard for entries that read every attribute of a type:

    * ``("pos", executor, atoms, keep)`` — the atoms' relations + the kept
      entity-attr columns;
    * ``("full", executor, atoms)`` — the atoms' relations + the
      ``("attr*", etype)`` wildcard per pattern variable;
    * ``("fam", atoms, keep)`` / ``("complete", atoms, keep)`` — the
      atoms' relations + the kept entity-attr columns;
    * ``("msg", executor, atom, child, parent)`` — the atom's relation +
      ``("attr*", child_etype)``;
    * ``("hist", executor, var, keep)`` — the kept entity-attr columns;
    * anything else — ``None`` (unknown; invalidation drops it
      conservatively).
    """
    try:
        ns = key[0]
        if ns == "pos":
            return frozenset({a.rel for a in key[2]} | _attr_tags(key[3]))
        if ns == "full":
            etypes = {v.etype for a in key[2] for v in (a.src, a.dst)}
            return frozenset({a.rel for a in key[2]}
                             | {("attr*", et) for et in etypes})
        if ns in ("fam", "complete"):
            return frozenset({a.rel for a in key[1]} | _attr_tags(key[2]))
        if ns == "msg":
            return frozenset({key[2].rel, ("attr*", key[3].etype)})
        if ns == "hist":
            return frozenset(_attr_tags(key[3]))
    except (TypeError, AttributeError, IndexError):
        pass
    return None


class CountingEngine:
    """Shared planner/executor/cache machinery on one device
    (``device=None`` = the CUDA card)."""

    def __init__(self, db: RelationalDB, executor="dense",
                 stats: Optional[CostStats] = None,
                 cache: Optional[CtCache] = None,
                 cache_budget_bytes: Optional[int] = None,
                 dtype=torch.float32, device=None):
        self.db = db
        self.device = resolve_device(device)
        self.stats = stats if stats is not None else CostStats()
        self.executor: Executor = (
            executor if isinstance(executor, Executor)
            else make_executor(executor, dtype=dtype, device=self.device))
        if self.executor.device != self.device:
            raise ValueError(f"executor counts on {self.executor.device}, "
                             f"the engine on {self.device}")
        self.stats.device = self.device
        self.cache = cache if cache is not None else CtCache(
            cache_budget_bytes, self.stats)
        self.cache.deps_fn = key_deps
        self.cache.version_fn = lambda: self.db.version
        self.tracer = NULL_TRACER
        self.dtype = dtype
        # Table 5's "once per distinct artefact" row accounting
        self.rows_counted: Set[Tuple] = set()
        # default-keep memo: all_ct_vars walks the schema per call
        self._keep_cache: Dict[Tuple, Tuple[CtVar, ...]] = {}

    def count_rows_once(self, key: Tuple, tab: CtTable) -> None:
        if key not in self.rows_counted:
            self.rows_counted.add(key)
            self.stats.ct_rows += tab.nnz_rows()

    def plan(self, point: LatticePoint,
             keep: Optional[Sequence[CtVar]] = None) -> ContractionPlan:
        if keep is None:
            keep = self._keep_cache.get(point.atoms)
            if keep is None:
                keep = tuple(point.all_ct_vars(self.db.schema,
                                               include_rind=False))
                self._keep_cache[point.atoms] = keep
        return compile_plan_cached(self.db.schema, point, tuple(keep))

    def contract(self, point: LatticePoint,
                 keep: Optional[Sequence[CtVar]] = None) -> CtTable:
        """Positive ct-table straight from the data (counts as JOIN work)."""
        return self.executor.positive(self.db, self.plan(point, keep),
                                      self.stats)

    def hist(self, var: Var, keep: Tuple[CtVar, ...]) -> CtTable:
        key = ("hist", self.executor.name, var, tuple(keep))
        hit = self.cache.get(key)
        if hit is None:
            hit = self.cache.put(key, self.executor.hist(
                self.db, var, tuple(keep), self.stats))
        return hit

    def mobius_fn(self):
        """The executor's negative-phase step, ``(stack, k) -> stack``."""
        return self.executor.mobius

    def mobius_batch_fn(self):
        """The executor's BATCHED negative-phase step,
        ``(stacks, k) -> [stack]``."""
        return self.executor.mobius_batch

    def mobius_fused_fn(self):
        """The executor's FUSED batched negative phase,
        ``(block_lists, k, perm) -> [table tensor]``."""
        return self.executor.mobius_batch_fused


class _Policy:
    """Base: delegate histograms; subclasses implement ``positive``.

    All data-access work (contractions, message propagation) is timed here
    under ``time_positive`` — including eviction-driven *recomputes* — so
    the Fig. 3 decomposition stays truthful under a cache budget.
    ``ct_rows`` (Table 5) is bumped once per distinct artefact, not per
    recompute."""

    def __init__(self, engine: CountingEngine):
        self.engine = engine

    def _count_rows_once(self, key: Tuple, tab: CtTable) -> None:
        self.engine.count_rows_once(key, tab)

    def hist(self, var: Var, keep: Tuple[CtVar, ...]) -> CtTable:
        return self.engine.hist(var, keep)

    def precompute(self, lattice: Sequence[LatticePoint]) -> None:
        pass

    supports_batch_prefetch = False    # callers skip query enumeration when
                                       # a policy can never batch (TUPLEID)

    def batchable_misses(self, queries: Sequence[Tuple[LatticePoint,
                                                       Tuple[CtVar, ...]]]
                         ) -> List[Tuple[LatticePoint,
                                         Optional[Tuple[CtVar, ...]]]]:
        """Of the positive queries a Möbius join is about to issue, the
        deduplicated subset this policy would contract *from data* on miss.
        Policies whose misses are not plan contractions (tuple-ID message
        recombination) return []."""
        return []

    def absorb(self, point: LatticePoint,
               keep: Optional[Tuple[CtVar, ...]], tab: CtTable) -> None:
        """Accept a positive table computed for a query previously reported
        by :meth:`batchable_misses` (same caching + row accounting as the
        policy's own miss path)."""
        raise NotImplementedError


class OnDemandPositives(_Policy):
    """Contract positives from the database per request (counts JOINs);
    memoised in the shared cache (the paper's post-count cache)."""

    supports_batch_prefetch = True

    def _key(self, point: LatticePoint, keep: Tuple[CtVar, ...]) -> Tuple:
        return ("pos", self.engine.executor.name, point.atoms, tuple(keep))

    def positive(self, point: LatticePoint,
                 keep: Tuple[CtVar, ...]) -> CtTable:
        eng = self.engine
        key = self._key(point, keep)
        hit = eng.cache.get(key)
        if hit is None:
            with eng.stats.timer("positive"):   # the per-family JOIN cost
                hit = eng.contract(point, keep)
            self._count_rows_once(key, hit)
            eng.cache.put(key, hit)
        return hit

    def batchable_misses(self, queries):
        out, seen = [], set()
        for point, keep in queries:
            key = self._key(point, keep)
            if key not in self.engine.cache and key not in seen:
                seen.add(key)
                out.append((point, tuple(keep)))
        return out

    def absorb(self, point, keep, tab):
        key = self._key(point, keep)
        self._count_rows_once(key, tab)
        self.engine.cache.put(key, tab)


class CachedFullPositives(_Policy):
    """Serve positives by *projection* from full-attribute positive tables
    contracted once per lattice point — zero data access afterwards
    (HYBRID / PRECOUNT).  Evicted entries are re-contracted on miss."""

    supports_batch_prefetch = True

    def precompute(self, lattice: Sequence[LatticePoint]) -> None:
        for point in lattice:
            self._full(point)

    def _full_key(self, point: LatticePoint) -> Tuple:
        return ("full", self.engine.executor.name, point.atoms)

    def _full(self, point: LatticePoint) -> CtTable:
        eng = self.engine
        key = self._full_key(point)
        hit = eng.cache.get(key)
        if hit is None:
            with eng.stats.timer("positive"):
                hit = eng.contract(point, None)
            self._count_rows_once(key, hit)
            eng.cache.put(key, hit)
        return hit

    def batchable_misses(self, queries):
        # misses here are evicted full-resolution tables: one (point, None)
        # re-contraction per distinct sub-point no longer resident
        out, seen = [], set()
        for point, _ in queries:
            key = self._full_key(point)
            if key not in self.engine.cache and key not in seen:
                seen.add(key)
                out.append((point, None))
        return out

    def absorb(self, point, keep, tab):
        key = self._full_key(point)
        self._count_rows_once(key, tab)
        self.engine.cache.put(key, tab)

    def positive(self, point: LatticePoint,
                 keep: Tuple[CtVar, ...]) -> CtTable:
        return self._full(point).project(keep)


class TupleIdPositives(_Policy):
    """Positive tables via tuple-ID propagation (the paper's 'Pre-Count
    Variants' future-work section, realised in tensors).

    ``precompute`` caches, per (relationship, direction), the full-resolution
    message matrix ``M[parent_entity, D_child_attrs x D_edge_attrs]`` — the
    mass each parent node receives through that relationship.  A family
    positive is then a pure contraction of cached entity-indexed matrices
    (column projection + root reduce): edge tables are never touched again."""

    def _full_resolution(self, atom: Atom, child: Var
                         ) -> Tuple[Tuple[CtVar, ...], Tuple[CtVar, ...]]:
        schema = self.engine.db.schema
        cattrs = tuple(attr_var(child, a.name, a.card)
                       for a in schema.entity(child.etype).attrs)
        rel = schema.relationship(atom.rel)
        eattrs = tuple(edge_var(rel.name, a.name, a.card) for a in rel.attrs)
        return cattrs, eattrs

    def _msg(self, atom: Atom, child: Var, parent: Var):
        eng = self.engine
        key = ("msg", eng.executor.name, atom, child, parent)
        hit = eng.cache.get(key)
        if hit is None:
            cattrs, eattrs = self._full_resolution(atom, child)
            with eng.stats.timer("positive"):
                m, mvars = eng.executor.leaf_hop(eng.db, atom, child, parent,
                                                 cattrs, eattrs, eng.stats)
            hit = eng.cache.put(key, (m, tuple(mvars)),
                                nbytes=m.numel() * m.element_size())
        return hit

    def precompute(self, lattice: Sequence[LatticePoint]) -> None:
        seen: Set[Tuple] = set()
        for point in lattice:
            for atom in point.atoms:
                for child, parent in ((atom.src, atom.dst),
                                      (atom.dst, atom.src)):
                    if (atom.rel, child, parent) not in seen:
                        seen.add((atom.rel, child, parent))
                        self._msg(atom, child, parent)

    def positive(self, point: LatticePoint,
                 keep: Tuple[CtVar, ...]) -> CtTable:
        eng = self.engine
        keep = tuple(keep)
        plan = eng.plan(point, keep)
        factors: List[Tuple[torch.Tensor, Tuple[CtVar, ...]]] = []
        for hop in plan.root.hops:
            if hop.is_leaf_hop:
                m, mvars = self._msg(hop.atom, hop.child, hop.parent)
                factors.append(project_columns(m, mvars, keep))
            else:   # deeper subtree (chains of length > 2): propagate live
                factors.append(eng.executor.hop_message(eng.db, hop,
                                                        eng.stats))
        return eng.executor.root_reduce(eng.db, plan.root.own, factors,
                                        keep, eng.stats)


POSITIVE_POLICIES = {
    "ondemand": OnDemandPositives,
    "cached_full": CachedFullPositives,
    "tupleid": TupleIdPositives,
}
