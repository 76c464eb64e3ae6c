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

Eviction is always safe: every policy recomputes on miss.

**Mutations.**  Cache entries are stamped with the ``(db.version,
dependency-tag set)`` they were computed under (:func:`key_deps` derives
the tags from the key itself), and :meth:`CountingEngine.apply_delta`
reconciles the cache after a :class:`~repro_torch.core.database.FactDelta`
or :class:`~repro_torch.core.database.AttrDelta` is applied to the store.
Reconciliation is the paper's pre/post trade-off applied to writes:
positive artefacts (``"pos"``/``"full"`` tables, ``"msg"`` matrices) are
multilinear in each relationship's edge multiset, so a small fact delta
**updates them in place** by counting just the delta edges — surviving
``"pos"``/``"full"`` entries through ONE
:meth:`~repro_torch.core.executors.Executor.positive_batch` call over the
delta view (K1/K2 on the card).  Derived ``"fam"``/``"complete"`` tables
are updated in place too: the Möbius transform is linear, so the positive
block deltas push through the butterfly
(:func:`~repro_torch.core.mobius.complete_ct_delta_many`, one K3 launch
per ``(shape, perm)`` group) and add onto the resident tables.  Above the
cost threshold the entry is dropped instead and recomputed on next miss
(post-counting the write).  Entries whose dependency tags miss the delta —
including every ``"hist"`` on a fact delta — are retained untouched.
Attribute deltas invalidate exactly the entries whose tags intersect the
written ``(etype, attr)`` columns (counts are *not* linear in attribute
values, so there is no in-place path) and retain everything else.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Hashable, List, Optional, Sequence, Set, Tuple

import torch

from ..obs.trace import NULL_TRACER
from .cache import CtCache
from .contract import CostStats
from .ct import CtTable
from .database import AttrDelta, RelationalDB
from .device import resolve_device
from .executors import Executor, make_executor, project_columns
from .mobius import complete_ct_delta_many
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


@dataclass
class DeltaReport:
    """What one :meth:`CountingEngine.apply_delta` reconciliation did to
    the cache: entries refreshed in place (``updated``), dropped
    (``invalidated``) and left untouched (``retained``)."""

    rel: str
    op: str
    num_edges: int
    updated: int = 0
    invalidated: int = 0
    retained: int = 0
    version: int = 0

    def as_dict(self) -> dict:
        return dict(rel=self.rel, op=self.op, num_edges=self.num_edges,
                    updated=self.updated, invalidated=self.invalidated,
                    retained=self.retained, version=self.version)


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

    # -- delta count maintenance --------------------------------------------
    def apply_delta(self, delta,
                    max_update_fraction: float = 0.25) -> DeltaReport:
        """Reconcile the cache after ``delta`` was applied to ``self.db``.

        Accepts a :class:`~repro_torch.core.database.FactDelta`
        (relationship writes) or an
        :class:`~repro_torch.core.database.AttrDelta` (entity-attribute
        writes).  For a fact delta, walks the resident entries once and,
        per entry:

        * dependency tags miss ``delta.rel`` → **retained** untouched;
        * positive artefact (``"pos"``/``"full"`` table, ``"msg"``
          matrix) and the delta is *small* (``delta.num_edges <=
          max_update_fraction *`` the relation's post-delta edge count) →
          **updated in place**: the entry's own contraction plan runs over
          a delta view of the database (just the changed edges) and the
          result is added/subtracted — exact, because positive counts are
          multilinear in each relationship's edge multiset and lattice
          patterns use distinct relations.  All surviving ``"pos"`` /
          ``"full"`` entries go through ONE
          :meth:`~repro_torch.core.executors.Executor.positive_batch` call;
        * derived ``"fam"``/``"complete"`` table and the delta is small →
          **updated in place through the butterfly**
          (:func:`~repro_torch.core.mobius.complete_ct_delta_many`).
          Entries whose kept indicators sum ``delta.rel`` out are provably
          unaffected and retained;
        * otherwise → **invalidated** (dropped; recomputed on next miss —
          the post-count fallback of the pre/post trade-off, applied to
          writes).

        An attribute delta has no in-place path: entries whose tags
        intersect the written ``(etype, attr)`` columns are invalidated,
        everything else is retained.

        Deltas must be reconciled in application order, one per call:
        ``delta.new_version`` must equal the store's current version
        (otherwise a second delta to an overlapping pattern would double
        the cross terms).

        Args:
            delta: the applied :class:`~repro_torch.core.database.FactDelta`
                or :class:`~repro_torch.core.database.AttrDelta`.
            max_update_fraction: in-place-update cost threshold, as a
                fraction of the relation's current edge count.

        Returns:
            A :class:`DeltaReport` with updated/invalidated/retained
            counts.

        Raises:
            ValueError: ``delta`` is not the store's latest version.

        Usage::

            delta = db.insert_facts("Rated", src, dst, {"rating": vals})
            report = engine.apply_delta(delta)
        """
        if delta.new_version != self.db.version:
            raise ValueError(
                f"delta version {delta.new_version} != store version "
                f"{self.db.version}; reconcile deltas in application order")
        if isinstance(delta, AttrDelta):
            return self._apply_attr_delta(delta)
        rel = delta.rel
        report = DeltaReport(rel, delta.op, delta.num_edges,
                             version=self.db.version)
        rel_edges = self.db.relations[rel].num_edges
        small = delta.num_edges <= max_update_fraction * max(rel_edges, 1)
        delta_db = delta.as_db(self.db) if small else None
        cache = self.cache
        ex = self.executor
        with self.tracer.span("engine.apply_delta", rel=rel, op=delta.op,
                              num_edges=delta.num_edges,
                              small=small) as sp:
            # one classification walk over a stable snapshot, then one
            # batched dispatch per artefact family
            pos_items: List[Tuple[Tuple, CtTable, ContractionPlan]] = []
            msg_keys: List[Tuple] = []
            fam_items: List[Tuple[Tuple, LatticePoint,
                                  Tuple[CtVar, ...]]] = []
            for key in cache.keys_snapshot():
                meta = cache.entry_meta(key)
                if meta is None:
                    continue
                deps, _version = meta
                if deps is not None and rel not in deps:
                    report.retained += 1
                    continue
                bucket = self._classify_for_delta(key) if small else None
                if bucket is None:
                    if cache.discard(key):
                        report.invalidated += 1
                    continue
                kind, payload = bucket
                if kind == "pos":
                    pos_items.append((key,) + payload)
                elif kind == "msg":
                    msg_keys.append(key)
                else:
                    fam_items.append((key,) + payload)

            # surviving positive tables: ONE batched call over the delta
            # view, grouped by plan signature inside positive_batch
            if pos_items:
                with self.stats.timer("positive"), ex.local_mode():
                    dtabs = ex.positive_batch(
                        delta_db, [p for _, _, p in pos_items], self.stats)
                for (key, old, _), dtab in zip(pos_items, dtabs):
                    new = old + dtab.scale(delta.sign)
                    cache.put(key, new, nbytes=new.nbytes)
                    cache.count_delta_updates()
                    report.updated += 1

            # message matrices: one leaf hop over the delta edges each
            for key in msg_keys:
                new_val, nb = self._delta_update_msg(key, delta_db,
                                                     delta.sign)
                if new_val is not None:
                    cache.put(key, new_val, nbytes=nb)
                    cache.count_delta_updates()
                    report.updated += 1
                elif cache.discard(key):
                    report.invalidated += 1

            # derived tables: push the block deltas through the batched
            # butterfly and add onto the resident tables
            if fam_items:
                provider = _DeltaPositives(self, delta_db)
                outs = complete_ct_delta_many(
                    [(point, keep) for _, point, keep in fam_items], rel,
                    provider, self.stats,
                    mobius_fn=self.mobius_fn(),
                    mobius_batch_fn=self.mobius_batch_fn(),
                    mobius_fused_fn=self.mobius_fused_fn())
                for (key, _, _), (status, dtab) in zip(fam_items, outs):
                    if status == "zero":
                        report.retained += 1
                        continue
                    old = cache.peek(key) if status == "delta" else None
                    if old is None:
                        if cache.discard(key):
                            report.invalidated += 1
                        continue
                    new = old + dtab.scale(delta.sign)
                    cache.put(key, new, nbytes=new.nbytes)
                    cache.count_delta_updates()
                    report.updated += 1
            sp.set(updated=report.updated, invalidated=report.invalidated,
                   retained=report.retained)
        return report

    def _apply_attr_delta(self, delta: AttrDelta) -> DeltaReport:
        """Reconcile after an entity-attribute write: drop exactly the
        entries whose dependency tags intersect the written columns (or
        whose deps are unknown), retain the rest."""
        tags = delta.dep_tags()
        report = DeltaReport(delta.etype, "update_attrs", delta.num_rows,
                             version=self.db.version)
        cache = self.cache
        with self.tracer.span("engine.apply_delta", etype=delta.etype,
                              op="update_attrs",
                              num_rows=delta.num_rows) as sp:
            for key in cache.keys_snapshot():
                meta = cache.entry_meta(key)
                if meta is None:
                    continue
                deps, _version = meta
                if deps is not None and not (deps & tags):
                    report.retained += 1
                    continue
                if cache.discard(key):
                    report.invalidated += 1
            sp.set(updated=0, invalidated=report.invalidated,
                   retained=report.retained)
        return report

    def _classify_for_delta(self, key: Tuple):
        """Sort one affected resident entry into its delta-update family:
        ``("pos", (old, plan))`` for positive tables, ``("msg", ())`` for
        message matrices, ``("fam", (point, keep))`` for derived tables —
        or ``None`` when the entry cannot be delta-updated (unknown
        namespace, other executor's artefact, unplannable key) and must be
        dropped."""
        ns = key[0]
        ex = self.executor
        try:
            if ns == "pos" and key[1] == ex.name:
                old = self.cache.peek(key)
                if old is None:
                    return None
                plan = compile_plan_cached(self.db.schema,
                                           LatticePoint(key[2]),
                                           tuple(key[3]))
                return "pos", (old, plan)
            if ns == "full" and key[1] == ex.name:
                old = self.cache.peek(key)
                if old is None:
                    return None
                return "pos", (old, self.plan(LatticePoint(key[2]), None))
            if ns == "msg" and key[1] == ex.name:
                return "msg", ()
            if ns in ("fam", "complete"):
                return "fam", (LatticePoint(key[1]), tuple(key[2]))
        except (KeyError, ValueError, TypeError):
            pass
        return None

    def _delta_update_msg(self, key: Tuple, delta_db: RelationalDB,
                          sign: int) -> Tuple[Optional[object],
                                              Optional[int]]:
        """Tuple-ID message matrices are per-relationship segment sums —
        linear in the edge list by construction, so the delta hop (K1 or
        K2 over the delta edges) simply adds on."""
        _, _, atom, child, parent = key
        hit = self.cache.peek(key)
        if hit is None:
            return None, None
        m, mvars = hit
        schema = self.db.schema
        cattrs = tuple(attr_var(child, a.name, a.card)
                       for a in schema.entity(child.etype).attrs)
        rel_t = schema.relationship(atom.rel)
        eattrs = tuple(edge_var(rel_t.name, a.name, a.card)
                       for a in rel_t.attrs)
        ex = self.executor
        with self.stats.timer("positive"), ex.local_mode():
            dm, dvars = ex.leaf_hop(delta_db, atom, child, parent,
                                    cattrs, eattrs, self.stats)
        if tuple(dvars) != tuple(mvars):
            return None, None          # layout drifted: drop instead
        new_m = m + sign * dm
        return (new_m, tuple(mvars)), new_m.numel() * new_m.element_size()


class _DeltaPositives:
    """Positive provider over a delta view, for
    :func:`~repro_torch.core.mobius.complete_ct_delta_many`: contractions
    hit the delta edges only (exact per-block deltas, by multilinearity)
    while histograms serve FULL values through the engine's cache (the
    delta view shares the entity tables, so full histograms are exactly the
    unchanged factors of the delta's product form).  Results memoise
    per call only — delta-view positives must never land in the real
    cache."""

    def __init__(self, engine: CountingEngine, delta_db: RelationalDB):
        self.engine = engine
        self.delta_db = delta_db
        self._memo: Dict[Tuple, CtTable] = {}

    def positive(self, point: LatticePoint,
                 keep: Tuple[CtVar, ...]) -> CtTable:
        key = (point.atoms, tuple(keep))
        hit = self._memo.get(key)
        if hit is None:
            eng = self.engine
            plan = compile_plan_cached(eng.db.schema, point, tuple(keep))
            with eng.stats.timer("positive"), eng.executor.local_mode():
                hit = eng.executor.positive(self.delta_db, plan, eng.stats)
            self._memo[key] = hit
        return hit

    def hist(self, var: Var, keep: Tuple[CtVar, ...]) -> CtTable:
        return self.engine.hist(var, keep)


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
            with eng.tracer.span("precount.point") as sp, \
                    eng.stats.timer("positive"):
                if eng.tracer.enabled:
                    sp.set(point=str(point))
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
