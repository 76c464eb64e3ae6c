"""First-order Bayesian-network structure search (learn-and-join style).

Greedy hill-climbing over predicate dependencies per relationship lattice
point, bottom-up through the lattice with edge inheritance from sub-points
(Schulte & Khosravi 2012, simplified).  Every family evaluation goes through
the pluggable counting :class:`~repro_torch.core.strategies.Strategy` — this module
is deliberately strategy-agnostic: it is the *workload generator* whose
pattern stream the pre/post/hybrid caches serve.

Family scoring is **batched**: each hill-climbing round first enumerates
every candidate move, fetches the ct-tables of the not-yet-scored families
through the strategy (cache-served for PRECOUNT/HYBRID/TUPLEID), groups the
resulting ``N_ijk`` matrices by shape, and scores each group in ONE
batched BDeu call (:func:`~repro_torch.core.bdeu.bdeu_score_batch`, the K4
kernel on the card) instead of one call per family.  Scores are memoised
globally by (child, parents): the same family is generated repeatedly
during search (and across lattice points), which is exactly what makes
counts caching pay off.

The counting backend is **pluggable**: any object with the
``family_ct(point, keep)`` / ``family_ct_many(point, keeps)`` protocol can
serve the family tables — a bare :class:`~repro_torch.core.strategies
.Strategy` or a :class:`~repro_torch.serve.service.CountingService` (see
:mod:`repro_torch.discover.providers`) — so one search loop covers local
and served execution, and parity between them is a table equality, not a
code-path equivalence.  Candidate moves are sorted into a canonical order
before the argmax, so exact score ties break identically no matter which
backend produced the tables.
"""

from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import (Callable, Dict, FrozenSet, Iterable, List, MutableMapping,
                    Optional, Sequence, Set, Tuple)

import torch

from ..obs.profile import gc_spans, profiled_tracer, profiling
from ..obs.trace import NULL_TRACER, NullTracer
from .bdeu import bdeu_score_batch, family_nijk, family_score
from .database import RelationalDB
from .device import resolve_device
from .strategies import Strategy
from .variables import CtVar, LatticePoint, build_lattice


@dataclass
class BNModel:
    nodes: Tuple[CtVar, ...]
    parents: Dict[CtVar, FrozenSet[CtVar]]
    score: float

    def edges(self) -> List[Tuple[CtVar, CtVar]]:
        return [(p, c) for c, ps in self.parents.items() for p in ps]


Family = Tuple[CtVar, FrozenSet[CtVar]]          # (child, parents)

# round hook: (point, n_moves, families_scored_this_round, t0, t1)
RoundCallback = Callable[[LatticePoint, int, int, float, float], None]


class StructureSearch:
    """Greedy hill-climbing over one pluggable count provider.

    Args:
        db: the database (used for its schema; may be ``None`` when
            ``schema`` or a ``counts`` provider with a ``schema``
            attribute is given — the served deployment).
        strategy: the counting strategy; doubles as the default count
            provider (``family_ct`` / ``family_ct_many``).
        counts: count-provider override — any object with the strategy's
            family-table protocol (service-backed, see
            :mod:`repro_torch.discover.providers`).
        schema: the schema counted over, where ``db`` is ``None``.
        batch_scoring: score each round's frontier in one batched BDeu
            call per shape group (``False``: one family at a time).
        score_cache: external score memo (``in`` / ``[]`` protocol on
            ``(child, parents)`` keys).  :class:`~repro_torch.discover
            .service.DiscoveryService` injects a version-scoped view here
            so concurrent searches share one memo that composes with store
            mutations; by default each search owns a private dict.
        round_cb: optional per-climbing-round hook
            ``(point, n_moves, n_scored, t0, t1)`` — the discovery
            service's round counters and histograms attach here.
        tracer: records a ``discover.point`` span per lattice point, a
            ``discover.round`` span per climbing round (``moves``,
            ``scored``; a point's first round also holds its first
            scoring pass) and a ``search.score`` span per batched BDeu
            pass (:data:`~repro_torch.obs.trace.NULL_TRACER`: none).
    """

    def __init__(self, db: Optional[RelationalDB],
                 strategy: Optional[Strategy],
                 max_parents: int = 3, ess: float = 1.0,
                 max_moves: int = 200, batch_scoring: bool = True,
                 counts: Optional[object] = None,
                 schema: Optional[object] = None,
                 score_cache: Optional[MutableMapping] = None,
                 round_cb: Optional[RoundCallback] = None,
                 tracer: NullTracer = NULL_TRACER):
        self.db = db
        self.strategy = strategy
        self.counts = counts if counts is not None else strategy
        if self.counts is None:
            raise ValueError("StructureSearch needs a strategy or a counts "
                             "provider")
        if schema is not None:
            self.schema = schema
        elif db is not None:
            self.schema = db.schema
        else:
            self.schema = self.counts.schema
        self.max_parents = max_parents
        self.ess = ess
        self.max_moves = max_moves
        self.batch_scoring = batch_scoring
        self.round_cb = round_cb
        self.tracer = tracer
        self._score_cache: MutableMapping[Family, float] = (
            score_cache if score_cache is not None else {})
        # which relations each scored family's table depended on (the
        # point's relation set at scoring time) — the delta-refresh layer
        # uses this to carry forward scores a write cannot have changed
        self.family_deps: Dict[Family, FrozenSet[str]] = {}
        self.families_scored = 0
        self.batch_calls = 0          # batched BDeu calls issued

    # -- family scoring (through the counting strategy) ---------------------
    def local_score(self, point: LatticePoint, child: CtVar,
                    parents: FrozenSet[CtVar]) -> float:
        key = (child, parents)
        if key not in self._score_cache:
            keep = tuple(sorted(parents)) + (child,)
            tab = self.counts.family_ct(point, keep)
            self._score_cache[key] = family_score(tab, child, self.ess)
            self.family_deps[key] = point.rels
            self.families_scored += 1
        return self._score_cache[key]

    def batch_scores(self, point: LatticePoint,
                     fams: Iterable[Family]) -> None:
        """Score every not-yet-cached family of ``fams`` with one batched
        BDeu call per N_ijk shape group.  The ct-tables themselves are
        fetched through the strategy's batched entry point
        (:meth:`~repro_torch.core.strategies.Strategy.family_ct_many`),
        which runs the round's negative phase as one transform per shape
        group."""
        todo: List[Family] = []
        seen: Set[Family] = set()
        for fam in fams:
            if fam not in self._score_cache and fam not in seen:
                seen.add(fam)
                todo.append(fam)
        if not todo:
            return
        keeps = [tuple(sorted(parents)) + (child,)
                 for child, parents in todo]
        fetch_many = getattr(self.counts, "family_ct_many", None)
        tabs = (fetch_many(point, keeps) if fetch_many is not None
                else [self.counts.family_ct(point, k) for k in keeps])
        groups: Dict[Tuple[int, int], List[Tuple[Family, torch.Tensor]]] = {}
        for (child, parents), tab in zip(todo, tabs):
            nijk = family_nijk(tab, child)
            groups.setdefault(tuple(nijk.shape), []).append(
                ((child, parents), nijk))
        with self.tracer.span("search.score") as sp:
            if self.tracer.enabled:
                sp.set(groups=len(groups), families=len(todo))
            for shape, members in groups.items():
                stack = torch.stack([nijk for _, nijk in members])
                scores = bdeu_score_batch(stack, ess=self.ess).cpu().numpy()
                self.batch_calls += 1
                for (fam, _), s in zip(members, scores):
                    self._score_cache[fam] = float(s)
                    self.family_deps[fam] = point.rels
        self.families_scored += len(todo)

    # -- acyclicity ----------------------------------------------------------
    @staticmethod
    def _creates_cycle(parents: Dict[CtVar, Set[CtVar]],
                       src: CtVar, dst: CtVar) -> bool:
        """Would edge src->dst close a cycle? (is dst an ancestor of src?)"""
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(parents[n])
        return False

    # -- hill climbing per lattice point -------------------------------------
    def _candidate_moves(self, nodes: Sequence[CtVar],
                         parents: Dict[CtVar, Set[CtVar]]
                         ) -> List[Tuple[str, CtVar, CtVar, FrozenSet[CtVar]]]:
        """All legal single-edge moves, sorted into a canonical order
        (op, src, dst, parent set) — the argmax's strict ``>`` then breaks
        exact score ties on the SAME move regardless of enumeration order,
        so every count provider that gives the same tables learns the same
        models edge for edge."""
        moves = []
        for src, dst in itertools.permutations(nodes, 2):
            if src in parents[dst]:
                moves.append(("del", src, dst,
                              frozenset(parents[dst] - {src})))
            else:
                if len(parents[dst]) >= self.max_parents:
                    continue
                if self._creates_cycle(parents, src, dst):
                    continue
                moves.append(("add", src, dst,
                              frozenset(parents[dst] | {src})))
        moves.sort(key=lambda m: (m[0], m[1], m[2], tuple(sorted(m[3]))))
        return moves

    def climb_point(self, point: LatticePoint,
                    init_parents: Optional[Dict[CtVar, Set[CtVar]]] = None
                    ) -> BNModel:
        with self.tracer.span("discover.point") as sp:
            if self.tracer.enabled:
                sp.set(point=str(point))
            return self._climb(point, init_parents)

    def _climb(self, point: LatticePoint,
               init_parents: Optional[Dict[CtVar, Set[CtVar]]]) -> BNModel:
        nodes = list(point.all_ct_vars(self.schema, include_rind=True))
        parents: Dict[CtVar, Set[CtVar]] = {n: set() for n in nodes}
        if init_parents:
            for c, ps in init_parents.items():
                if c in parents:
                    parents[c] = {p for p in ps if p in parents}

        def sc(child: CtVar) -> float:
            return self.local_score(point, child, frozenset(parents[child]))

        tracer = self.tracer
        total: Optional[float] = None
        for _ in range(max(self.max_moves, 1)):
            with tracer.span("discover.round") as rnd:
                scored_in_span = self.families_scored
                if total is None:
                    # a point's first round span holds its first scoring
                    # pass (round_cb's counts leave it out)
                    if self.batch_scoring:
                        self.batch_scores(point, ((n, frozenset(parents[n]))
                                                  for n in nodes))
                    total = sum(sc(n) for n in nodes)
                    if not self.max_moves:
                        break
                t0 = time.perf_counter()
                scored_before = self.families_scored
                moves = self._candidate_moves(nodes, parents)
                if self.batch_scoring:
                    # one batched scoring pass over the whole round's frontier
                    self.batch_scores(point, ((dst, ps)
                                              for _, _, dst, ps in moves))
                best_delta, best_apply = 0.0, None
                for op, src, dst, new_ps in moves:
                    delta = (self.local_score(point, dst, new_ps) - sc(dst))
                    if delta > best_delta:
                        best_delta = delta
                        best_apply = (op, src, dst)
                if tracer.enabled:
                    rnd.set(moves=len(moves),
                            scored=self.families_scored - scored_in_span)
                if self.round_cb is not None:
                    # the scores came back to the host, so the round's
                    # device work is done by now: t1 is the card's time, too
                    self.round_cb(point, len(moves),
                                  self.families_scored - scored_before,
                                  t0, time.perf_counter())
            if best_apply is None:
                break
            op, src, dst = best_apply
            if op == "add":
                parents[dst].add(src)
            else:
                parents[dst].remove(src)
            total += best_delta
        return BNModel(tuple(nodes),
                       {n: frozenset(ps) for n, ps in parents.items()},
                       total)

    # -- learn-and-join over the lattice --------------------------------------
    def run(self, lattice: Sequence[LatticePoint],
            init_models: Optional[Dict[LatticePoint, BNModel]] = None
            ) -> Dict[LatticePoint, BNModel]:
        """Learn-and-join bottom-up over the lattice (``lattice`` is
        ordered bottom-up): each point's climb starts from the union of
        its sub-points' edges.

        Args:
            lattice: bottom-up ordered lattice points.
            init_models: warm-start models (the refresh hook) — each
                point's climb starts from its previous model's edges on
                top of the usual sub-point inheritance, so an online
                refresh hill-climbs locally from the current model
                instead of from scratch.
        """
        models: Dict[LatticePoint, BNModel] = {}
        for point in lattice:          # lattice is bottom-up ordered
            init: Dict[CtVar, Set[CtVar]] = {}
            for sub, m in models.items():
                if sub.rels < point.rels:      # inherit sub-point edges
                    for c, ps in m.parents.items():
                        init.setdefault(c, set()).update(ps)
            if init_models is not None and point in init_models:
                for c, ps in init_models[point].parents.items():
                    init.setdefault(c, set()).update(ps)
            models[point] = self.climb_point(point, init)
        return models


def discover_model(db: RelationalDB, strategy: Strategy,
                   max_chain_length: int = 2, max_parents: int = 3,
                   ess: float = 1.0, device=None
                   ) -> Tuple[Dict[LatticePoint, BNModel], Strategy]:
    """End-to-end model discovery: build lattice, run the strategy's
    pre-search phase, hill-climb bottom-up.  Returns per-point models and the
    strategy (whose ``stats`` carry the paper's metrics).

    ``device`` (``None`` = the CUDA card) must be the strategy's device:
    a run on the host is asked for by name on both.

    While a ``torch.profiler`` session records, the discovery records its
    spans (``discover.run`` at the root) into
    :func:`~repro_torch.obs.profile.profiled_tracer` through the strategy,
    its engine and executor, and the search; otherwise it records none.

    Raises:
        RuntimeError: ``device`` is the CUDA card and none is available.
        ValueError: the strategy counts on another device."""
    device = resolve_device(device)
    if strategy.device != device:
        raise ValueError(f"strategy counts on {strategy.device}, "
                         f"discover_model was asked for {device}")
    tracer = profiled_tracer() if profiling() else NULL_TRACER
    with tracer.span("discover.run") as sp, gc_spans(tracer):
        lattice = build_lattice(db.schema, max_chain_length)
        if tracer.enabled:
            sp.set(strategy=strategy.name, points=len(lattice))
            strategy.set_tracer(tracer)
        try:
            strategy.prepare(db, lattice)
            search = StructureSearch(db, strategy, max_parents=max_parents,
                                     ess=ess, tracer=tracer)
            models = search.run(lattice)
        finally:
            if tracer.enabled:
                strategy.set_tracer(NULL_TRACER)
    return models, strategy
