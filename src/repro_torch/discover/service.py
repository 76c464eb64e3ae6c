"""Model discovery as a service: hill-climbing through the counting stack.

:class:`DiscoveryService` runs the learn-and-join structure search of
:mod:`repro_torch.core.search` with its candidate-family floods routed
through a pluggable count provider (:mod:`repro_torch.discover.providers`)
— a bare :class:`~repro_torch.core.strategies.Strategy`, a batching
:class:`~repro_torch.serve.service.CountingService`, or a sharded
:class:`~repro_torch.serve.router.CountingRouter` — so ONE search code
path covers local, served and sharded execution, and the parity tests can
demand the served and sharded models be *edge-identical* to the local
oracle (counts are exact integers below 2^24; the search sorts candidate
moves canonically before the argmax, so ties break the same way on every
backend).

Each search runs on its caller's thread and scores its families there
(K4 on the card), while the counting service's dispatcher, or whichever
client thread flushes, runs the counting batches.

Two service-level behaviours sit on top of the search loop:

* **Shared version-scoped score memo.**  Scores live in one dict keyed by
  ``(version_token, family)``; each search sees a :class:`_MemoView`
  pinned to the token it observed at start.  Concurrent searches over the
  same warm CT cache therefore share every family score, while a
  committed :class:`~repro_torch.core.database.FactDelta` bumps the token and
  silently retires stale entries — a search that raced a write simply
  re-scores under the new token.  ``discover()`` re-runs (warm) until the
  token is stable across a whole search, so results are never computed
  from a torn mix of pre- and post-write counts.

* **Online model refresh.**  ``refresh(changed)`` re-scores only families
  whose recorded dependency sets (the lattice point's relations at
  scoring time) intersect the changed relations: every other family's
  score is carried forward to the new version token (counted in
  ``families_retained``), so only the delta-touched slice of the family
  space is re-counted.  By default the climb then re-runs over the warm
  memo, making the result bit-identical to a from-scratch relearn;
  ``warm_start=True`` instead hill-climbs locally from the current model
  (fewer rounds, possibly a different local optimum).  The
  ``families_rescored`` counter is the test hook proving selectivity.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Dict, FrozenSet, Iterable, Optional, Tuple, Union

from ..core.database import AttrDelta, FactDelta, RelationalDB
from ..core.search import BNModel, Family, StructureSearch
from ..core.variables import LatticePoint, build_lattice
from ..obs.hist import CountHistogram, LatencyHistogram
from ..obs.trace import NULL_TRACER
from ..serve.metrics import _LockedMetrics
from .providers import as_count_provider

__all__ = [
    "DiscoveryMetrics",
    "DiscoveryResult",
    "DiscoveryService",
    "RefreshReport",
    "models_signature",
]


def models_signature(models: Dict[LatticePoint, BNModel]) -> dict:
    """Canonical, order-insensitive rendering of a learned model set —
    the shape two discovery runs are compared by in the parity tests."""
    sig = {}
    for point, m in models.items():
        sig[str(point)] = sorted(
            (str(child), tuple(sorted(str(p) for p in ps)))
            for child, ps in m.parents.items())
    return sig


@dataclass
class DiscoveryMetrics(_LockedMetrics):
    """Counters/histograms for one :class:`DiscoveryService`."""
    discoveries: int = 0          # discover() calls completed
    refreshes: int = 0            # refresh() calls completed
    restarts: int = 0             # searches re-run after a version race
    rounds: int = 0               # hill-climbing rounds executed
    families_scored: int = 0      # family CTs scored (memo misses)
    families_rescored: int = 0    # families re-scored by refresh()
    families_retained: int = 0    # scores carried across a version bump
    round_hist: LatencyHistogram = field(
        default_factory=LatencyHistogram)  # per-round wall latency
    rescored_hist: CountHistogram = field(
        default_factory=CountHistogram)    # families re-scored per refresh
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    @classmethod
    def _hist_fields(cls):
        # The base helper matches only LatencyHistogram; this class also
        # carries a CountHistogram, so widen the match.
        return [f.name for f in dataclasses.fields(cls)
                if "Histogram" in str(f.type) and not f.name.startswith("_")]

    def observe_round(self, dt: float) -> None:
        with self._lock:
            self.round_hist.observe(dt)

    def observe_rescored(self, n: int) -> None:
        with self._lock:
            self.rescored_hist.observe(n)

    def snapshot(self) -> dict:
        """JSON-able dict of every counter + histogram summary."""
        return self._base_snapshot()


@dataclass(frozen=True)
class DiscoveryResult:
    """One completed discovery: the per-lattice-point models plus the
    provenance needed to reason about it (which store version it reflects,
    how much scoring work it cost, how often it raced a write)."""
    models: Dict[LatticePoint, BNModel]
    score: float                  # sum of per-point model scores
    version: Tuple                # provider version token the run settled on
    families_scored: int          # memo misses across the run (all restarts)
    restarts: int                 # re-runs forced by version races

    def signature(self) -> dict:
        return models_signature(self.models)


@dataclass(frozen=True)
class RefreshReport:
    """What one ``refresh()`` did: which relations changed, how many
    family scores were re-computed vs carried forward."""
    changed: FrozenSet[str]
    rescored: int                 # families re-scored (dependency hit)
    retained: int                 # scores carried to the new version token
    total_families: int           # families known to the service's memo
    result: DiscoveryResult


class _MemoView:
    """A version-pinned view of the service's shared score memo.

    :class:`StructureSearch` only ever uses ``in`` / ``[]`` get / ``[]``
    set on its score cache, so this implements exactly those three.
    Reads ride on the GIL-atomicity of dict lookups; writes take the
    service lock so they never interleave with the refresh-time rebuild.
    """

    __slots__ = ("_svc", "_token")

    def __init__(self, svc: "DiscoveryService", token: Tuple):
        self._svc = svc
        self._token = token

    def __contains__(self, key: Family) -> bool:
        return (self._token, key) in self._svc._memo

    def __getitem__(self, key: Family) -> float:
        return self._svc._memo[(self._token, key)]

    def __setitem__(self, key: Family, value: float) -> None:
        with self._svc._lock:
            self._svc._memo[(self._token, key)] = value


ChangedSpec = Union[str, FactDelta, AttrDelta,
                    Iterable[Union[str, FactDelta, AttrDelta]]]


class DiscoveryService:
    """Hill-climbing model discovery over any counting backend.

    Args:
        backend: a :class:`Strategy` (with ``db``), a
            :class:`CountingService`, a :class:`CountingRouter`, or a
            ready-made count provider.
        db: database for a bare-strategy backend (ignored otherwise).
        max_chain_length: lattice depth (relationship-chain length).
        max_parents/ess/max_moves/batch_scoring: forwarded to
            :class:`StructureSearch` unchanged.
        max_restarts: cap on version-race re-runs per ``discover()``.
        metrics: share an existing :class:`DiscoveryMetrics`.
        tracer: span sink; defaults to the backend's tracer when it has
            one (so search-round spans land in the same ring as the
            counting spans they caused).
        memo: share an existing score-memo dict across several discovery
            services — the multi-tenant registry passes ONE dict to every
            tenant's service.  Safe because memo keys are
            ``(version_token, family)`` and a backend naming a tenant
            prefixes its tokens with the tenant id, so entries stay
            disjoint: one tenant's writes move only its own token, and a
            shared-memo refresh retains other tokens' entries instead of
            garbage-collecting them.

    Usage::

        svc = DiscoveryService(router)      # or a service, or strategy + db
        result = svc.discover()
        report = svc.refresh(delta)             # selective re-score
    """

    def __init__(self, backend, *, db: Optional[RelationalDB] = None,
                 max_chain_length: int = 2, max_parents: int = 3,
                 ess: float = 1.0, max_moves: int = 200,
                 batch_scoring: bool = True, max_restarts: int = 64,
                 metrics: Optional[DiscoveryMetrics] = None,
                 tracer=None,
                 memo: Optional[Dict[Tuple[Tuple, Family], float]] = None):
        self.provider = as_count_provider(backend, db)
        self.schema = self.provider.schema
        self.lattice = build_lattice(self.schema, max_chain_length)
        self.provider.prepare(self.lattice)
        self.max_parents = max_parents
        self.ess = ess
        self.max_moves = max_moves
        self.batch_scoring = batch_scoring
        self.max_restarts = max_restarts
        self.metrics = metrics if metrics is not None else DiscoveryMetrics()
        self.tracer = (tracer if tracer is not None
                       else getattr(self.provider, "tracer", None)
                       or NULL_TRACER)
        self._lock = threading.Lock()
        self._shared_memo = memo is not None
        self._memo: Dict[Tuple[Tuple, Family], float] = (
            memo if memo is not None else {})
        self._deps: Dict[Family, FrozenSet[str]] = {}
        self._models: Optional[Dict[LatticePoint, BNModel]] = None
        self._token: Optional[Tuple] = None

    # -- internals ------------------------------------------------------------
    def _round_cb(self, point: LatticePoint, n_moves: int, n_scored: int,
                  t0: float, t1: float) -> None:
        self.metrics.inc(rounds=1, families_scored=n_scored)
        self.metrics.observe_round(t1 - t0)

    def _make_search(self, token: Tuple) -> StructureSearch:
        return StructureSearch(
            None, None, counts=self.provider, schema=self.schema,
            max_parents=self.max_parents, ess=self.ess,
            max_moves=self.max_moves, batch_scoring=self.batch_scoring,
            score_cache=_MemoView(self, token), round_cb=self._round_cb,
            tracer=self.tracer)

    def _run_stable(self, init_models: Optional[Dict[LatticePoint, BNModel]]
                    ) -> Tuple[Dict[LatticePoint, BNModel], Tuple, int, int]:
        """Run searches until one completes without the provider version
        moving underneath it.  Re-runs are warm: any family whose score
        landed under the final token (or was carried forward) is a memo
        hit.  Returns (models, token, families_scored, restarts)."""
        scored = 0
        for attempt in range(self.max_restarts + 1):
            token = self.provider.version()
            search = self._make_search(token)
            models = search.run(self.lattice, init_models=init_models)
            scored += search.families_scored
            with self._lock:
                self._deps.update(search.family_deps)
            if self.provider.version() == token:
                return models, token, scored, attempt
            self.metrics.inc(restarts=1)
        raise RuntimeError(f"discovery did not stabilise within "
                           f"{self.max_restarts} restarts (writes never "
                           f"quiesced)")

    # -- public API -----------------------------------------------------------
    def discover(self) -> DiscoveryResult:
        """Learn models for every lattice point from the current store
        state.  Safe to call concurrently from many threads: all calls
        share the memo (warm-cache hits) and each returns a result
        consistent with a single store version."""
        with self.tracer.span("discover.run"):
            models, token, scored, restarts = self._run_stable(None)
        with self._lock:
            self._models = models
            self._token = token
        self.metrics.inc(discoveries=1)
        return DiscoveryResult(models=models,
                               score=sum(m.score for m in models.values()),
                               version=token, families_scored=scored,
                               restarts=restarts)

    def refresh(self, changed: ChangedSpec, *,
                warm_start: bool = False) -> RefreshReport:
        """Selectively re-learn after committed writes.

        ``changed`` names the mutated relation(s) — a relation name, a
        :class:`FactDelta`, an :class:`~repro_torch.core.database.AttrDelta`,
        or an iterable of any mix.  Scores of families whose dependency
        sets are disjoint from ``changed`` are carried forward to the new
        version token; every other family is re-scored lazily as the
        hill-climb touches it — that selective re-counting is where the
        savings live, since counting (not move enumeration) is the search
        bottleneck.  An :class:`AttrDelta` anywhere in ``changed``
        disables carry-forward entirely (conservative full rescore):
        family dependency sets record relation names, and almost every
        family's sufficient statistics depend on entity attributes, so
        no selective match is sound for attribute writes.

        With ``warm_start=False`` (default) the climb restarts from the
        empty graph over the warm memo, which makes the refreshed model
        **bit-identical to a from-scratch relearn** on the mutated store:
        same init, same canonical move order, same scores (retained
        entries equal what a fresh count would produce, because their
        dependencies did not change).  ``warm_start=True`` instead
        hill-climbs locally from the current model — fewer rounds, same
        selective re-scoring, but greedy single-edge moves cannot reverse
        an edge in one step, so the result may be a different (equally
        local) optimum than a full relearn.
        """
        rels, attr_write = self._split_changed(changed)
        with self.tracer.span("discover.refresh", changed=sorted(rels),
                              attr_write=attr_write):
            if self._models is None:      # nothing to refresh from
                result = self.discover()
                report = RefreshReport(changed=rels,
                                       rescored=result.families_scored,
                                       retained=0,
                                       total_families=len(self._deps),
                                       result=result)
                self.metrics.inc(refreshes=1,
                                 families_rescored=report.rescored)
                self.metrics.observe_rescored(report.rescored)
                return report

            new_token = self.provider.version()
            retained = self._carry_forward(new_token,
                                           None if attr_write else rels)
            init = self._models if warm_start else None
            models, token, scored, restarts = self._run_stable(init)
        with self._lock:
            self._models = models
            self._token = token
            total = len(self._deps)
        self.metrics.inc(refreshes=1, families_rescored=scored,
                         families_retained=retained)
        self.metrics.observe_rescored(scored)
        result = DiscoveryResult(models=models,
                                 score=sum(m.score for m in models.values()),
                                 version=token, families_scored=scored,
                                 restarts=restarts)
        return RefreshReport(changed=rels, rescored=scored,
                             retained=retained, total_families=total,
                             result=result)

    def reset_memo(self) -> None:
        """Drop every memoized family score (but no CT cache state) —
        benchmarks use this to re-measure scoring work over warm counts.
        On a shared memo this clears IN PLACE (every sharer's scores go,
        including other tenants')."""
        with self._lock:
            if self._shared_memo:
                self._memo.clear()
            else:
                self._memo = {}

    def stats(self) -> dict:
        return self.metrics.snapshot()

    # -- refresh plumbing -----------------------------------------------------
    @staticmethod
    def _split_changed(changed: ChangedSpec
                       ) -> Tuple[FrozenSet[str], bool]:
        """Normalise a changed-spec into ``(relation names, any
        attribute write?)``.  Attribute writes are reported as
        ``attr:etype.name`` strings in the relation set (for the refresh
        report) but carry-forward treats them as change-everything."""
        if isinstance(changed, str):
            return frozenset((changed,)), False
        if isinstance(changed, FactDelta):
            return frozenset((changed.rel,)), False
        if isinstance(changed, AttrDelta):
            return frozenset(f"attr:{changed.etype}.{a}"
                             for a in changed.attrs), True
        rels, has_attr = set(), False
        for item in changed:
            if isinstance(item, AttrDelta):
                has_attr = True
                rels.update(f"attr:{item.etype}.{a}" for a in item.attrs)
            elif isinstance(item, FactDelta):
                rels.add(item.rel)
            else:
                rels.add(str(item))
        return frozenset(rels), has_attr

    def _carry_forward(self, new_token: Tuple,
                       changed: Optional[FrozenSet[str]]) -> int:
        """Move scores whose dependencies are disjoint from ``changed``
        from the previous model's token to ``new_token``; drop everything
        else (it will be re-scored lazily).  ``changed=None`` means
        *everything* changed (an attribute write): nothing is carried
        forward, old-token entries are still dropped/rebuilt so the memo
        does not leak.  A private memo is rebuilt
        into a fresh dict and swapped atomically so concurrent readers
        only ever see a complete mapping; a SHARED memo is edited in
        place instead — other sharers' tokens (other tenants') are
        retained rather than garbage-collected, so one tenant's write
        never invalidates another's scores, and a reader racing the move
        at worst misses a score transiently (costing one re-score)."""
        retained = 0
        with self._lock:
            old_token = self._token
            if self._shared_memo:
                if old_token == new_token:
                    return 0
                moves, drops = [], []
                for (tok, fam), s in list(self._memo.items()):
                    if tok != old_token:
                        continue
                    deps = self._deps.get(fam)
                    if (changed is not None and deps is not None
                            and not (deps & changed)):
                        moves.append(((new_token, fam), s))
                    drops.append((tok, fam))
                for k in drops:
                    self._memo.pop(k, None)
                for k, s in moves:
                    self._memo[k] = s
                return len(moves)
            memo: Dict[Tuple[Tuple, Family], float] = {}
            for (tok, fam), s in self._memo.items():
                if tok == new_token:
                    memo[(tok, fam)] = s
                elif tok == old_token:
                    deps = self._deps.get(fam)
                    if (changed is not None and deps is not None
                            and not (deps & changed)):
                        memo[(new_token, fam)] = s
                        retained += 1
            self._memo = memo
        return retained
