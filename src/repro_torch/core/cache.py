"""CtCache: one byte-budgeted LRU cache under every counting strategy.

* every entry is charged by byte size (``CtTable.nbytes``, a tensor's
  ``nbytes``, or an explicit ``nbytes=``);
* a byte budget triggers LRU eviction, and evictions *decrement* the
  shared :class:`~repro_torch.core.contract.CostStats` so ``cache_bytes``
  is the live footprint and ``peak_bytes`` the true high-water mark;
* an entry larger than the whole budget is admitted transiently (so its
  residency shows up in ``peak_bytes``) and immediately dropped;
* eviction is safe by construction: every caller has a recompute path on
  miss (positives re-contract, messages re-propagate, family tables
  re-join).

**Freshness.**  Every entry also records the ``(version, dependency set)``
it was computed under — ``deps`` is a frozenset of *dependency tags*:
relationship names (plain strings) for the edge tables the cached value was
derived from, plus ``("attr", etype, attr_name)`` tuples for the
entity-attribute columns it read (and the ``("attr*", etype)`` wildcard for
entries that cannot enumerate their attribute names); ``version`` is
``db.version`` at insert time.  Both default through pluggable hooks
(``deps_fn``/``version_fn``, wired by
:class:`~repro_torch.core.engine.CountingEngine`).
:meth:`CtCache.invalidate` drops only the entries whose dependency set
intersects the given tags (entries with unknown deps are dropped
conservatively).  After a write, the engine's delta maintenance walks a
:meth:`CtCache.keys_snapshot`, reads each entry's stamp
(:meth:`CtCache.entry_meta`) and value (:meth:`CtCache.peek`) without
touching the LRU or the hit counters, and either refreshes the entry in
place (:meth:`CtCache.count_delta_updates`) or drops it as stale
(:meth:`CtCache.discard`).

Keys are arbitrary hashable tuples; by convention the first element names
the namespace (``"pos"``, ``"full"``, ``"complete"``, ``"msg"``, ``"fam"``,
``"hist"``) so one cache instance can back every layer of a strategy.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (Any, Callable, FrozenSet, Hashable, Iterable, List,
                    Optional, Tuple)

from ..obs.trace import NULL_TRACER
from .contract import CostStats


def _nbytes_of(value: Any) -> int:
    nb = getattr(value, "nbytes", None)
    if nb is not None:
        return int(nb)
    if isinstance(value, tuple):
        return sum(_nbytes_of(v) for v in value)
    return 0


#: A dependency tag: a relationship name (str) or an attribute tuple
#: ``("attr", etype, name)`` / ``("attr*", etype)``.
DepTag = Hashable


class _Entry:
    __slots__ = ("value", "nbytes", "deps", "version")

    def __init__(self, value: Any, nbytes: int,
                 deps: Optional[FrozenSet[DepTag]], version: Optional[int]):
        self.value, self.nbytes = value, nbytes
        self.deps, self.version = deps, version


class CtCache:
    """Byte-budgeted LRU cache for ct-tables and message matrices, with
    per-entry ``(version, dependency-tag set)`` freshness metadata.

    Args:
        budget_bytes: LRU byte budget (``None`` = unbounded).
        stats: optional :class:`~repro_torch.core.contract.CostStats` whose
            ``cache_bytes``/``peak_bytes`` mirror the live footprint.
        deps_fn: ``key -> frozenset of dependency tags | None`` used to
            stamp entries whose ``put`` did not pass ``deps`` explicitly.
        version_fn: ``() -> int`` store version used to stamp entries
            whose ``put`` did not pass ``version``.
    """

    def __init__(self, budget_bytes: Optional[int] = None,
                 stats: Optional[CostStats] = None,
                 deps_fn: Optional[Callable[[Hashable],
                                            Optional[FrozenSet[DepTag]]]] = None,
                 version_fn: Optional[Callable[[], int]] = None):
        self.budget_bytes = budget_bytes
        self.stats = stats
        self.deps_fn = deps_fn
        self.version_fn = version_fn
        self._entries: "OrderedDict[Hashable, _Entry]" = OrderedDict()
        self._lock = threading.RLock()
        self.tracer = NULL_TRACER
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dropped = 0
        self.invalidated = 0
        self.delta_updated = 0        # entries refreshed in place by a delta

    # -- core ops -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._entries

    def get(self, key: Hashable, default=None):
        tr = self.tracer
        with self._lock:
            hit = self._entries.get(key)
            if hit is None:
                self.misses += 1
                if tr.enabled:
                    tr.event("cache.miss", key=key)
                return default
            self._entries.move_to_end(key)
            self.hits += 1
            if tr.enabled:
                tr.event("cache.hit", key=key, nbytes=hit.nbytes)
            return hit.value

    def put(self, key: Hashable, value: Any,
            nbytes: Optional[int] = None,
            deps: Optional[FrozenSet[DepTag]] = None,
            version: Optional[int] = None) -> Any:
        """Insert (or refresh) ``key``; returns ``value`` for chaining.

        ``deps``/``version`` default through the ``deps_fn``/``version_fn``
        hooks, so ordinary callers never pass them."""
        nb = _nbytes_of(value) if nbytes is None else int(nbytes)
        if deps is None and self.deps_fn is not None:
            deps = self.deps_fn(key)
        if version is None and self.version_fn is not None:
            version = self.version_fn()
        with self._lock:
            if key in self._entries:
                self._evict_one(key)
            self._entries[key] = _Entry(value, nb, deps, version)
            self.nbytes += nb
            if self.stats is not None:
                self.stats.bump_cache(nb)  # records the peak before any drop
            self._shrink_to_budget(just_added=key)
        return value

    def peek(self, key: Hashable, default=None):
        """Read a value WITHOUT hit/miss accounting or an LRU touch — the
        delta-maintenance walk reads entries it is about to refresh, which
        must not look like client traffic."""
        with self._lock:
            e = self._entries.get(key)
            return default if e is None else e.value

    def discard(self, key: Hashable) -> bool:
        """Drop one entry as *stale* (counted under ``invalidated``, not
        ``evictions``); returns whether it was resident."""
        with self._lock:
            if key not in self._entries:
                return False
            self._evict_one(key)
            self.invalidated += 1
            return True

    def count_delta_updates(self, n: int = 1) -> None:
        """Record ``n`` entries refreshed in place by a delta (the one
        place the ``delta_updated`` counter moves, under the lock)."""
        with self._lock:
            self.delta_updated += n

    def entry_meta(self, key: Hashable
                   ) -> Optional[Tuple[Optional[FrozenSet[DepTag]],
                                       Optional[int]]]:
        """The ``(deps, version)`` stamp of a resident entry (no LRU
        touch, no hit/miss accounting), or ``None`` when absent."""
        with self._lock:
            e = self._entries.get(key)
            return None if e is None else (e.deps, e.version)

    def keys_snapshot(self) -> List[Hashable]:
        """A stable snapshot of the resident keys (LRU -> MRU order) —
        what a delta-maintenance walk iterates while individual entries
        come and go underneath it."""
        with self._lock:
            return list(self._entries)

    # -- eviction -----------------------------------------------------------
    def _evict_one(self, key: Hashable) -> None:
        e = self._entries.pop(key)
        self.nbytes -= e.nbytes
        if self.stats is not None:
            self.stats.bump_cache(-e.nbytes)
        if self.tracer.enabled:
            self.tracer.event("cache.evict", key=key, nbytes=e.nbytes)

    def _shrink_to_budget(self, just_added: Optional[Hashable] = None) -> None:
        if self.budget_bytes is None or self.nbytes <= self.budget_bytes:
            return
        for key in list(self._entries):
            if self.nbytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if key == just_added:
                # the just-added entry is only reachable once everything
                # older is gone (it sits at the MRU end anyway)
                continue
            self._evict_one(key)
            self.evictions += 1
        if self.nbytes > self.budget_bytes and just_added in self._entries:
            # the new entry alone exceeds the budget: admit-then-drop, so
            # peak_bytes reflects its transient residency
            self._evict_one(just_added)
            self.dropped += 1

    def invalidate(self, rels: Optional[Iterable[DepTag]] = None) -> int:
        """Drop entries made stale by a write to ``rels`` (dependency tags;
        ``None`` drops everything).  Entries over untouched tags keep their
        residency AND their LRU position.

        Returns:
            Number of entries dropped.

        Usage::

            dropped = cache.invalidate({"Rated"})
        """
        with self._lock:
            tags = None if rels is None else frozenset(rels)
            stale = [key for key, e in self._entries.items()
                     if tags is None or e.deps is None or e.deps & tags]
            for key in stale:
                self._evict_one(key)
            self.invalidated += len(stale)
            return len(stale)

    def info(self) -> dict:
        return dict(entries=len(self._entries), nbytes=self.nbytes,
                    budget_bytes=self.budget_bytes, hits=self.hits,
                    misses=self.misses, evictions=self.evictions,
                    dropped=self.dropped, invalidated=self.invalidated,
                    delta_updated=self.delta_updated)
