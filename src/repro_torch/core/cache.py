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

**Tenancy.**  One physical store can back many logical databases.  Every
entry belongs to a tenant (:data:`DEFAULT_TENANT` when unspecified, which
keeps the single-DB API unchanged); :meth:`CtCache.scoped` hands out a
:class:`TenantCache` view that an engine uses exactly like a private
cache — its ``deps_fn``/``version_fn`` hooks live on the *view*, so two
tenants' engines never collide on the shared store.  Per-tenant byte
accounting supports two knobs (:meth:`CtCache.set_tenant_budget`):

* ``reserved_bytes`` — a floor the global LRU shrink may never evict
  below: a flooding tenant can only reclaim the *shared* headroom, never
  another tenant's reservation;
* ``cap_bytes`` — a ceiling: a tenant over its own cap evicts its own
  LRU entries first, before the global budget is even consulted.

Keys are arbitrary hashable tuples; by convention the first element names
the namespace (``"pos"``, ``"full"``, ``"complete"``, ``"msg"``, ``"fam"``,
``"hist"``) so one cache instance can back every layer of a strategy.
Tenants may freely reuse the same key tuples — the store disambiguates
internally by ``(tenant, key)``.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import (Any, Callable, Dict, FrozenSet, Hashable, Iterable, List,
                    Optional, Tuple)

from ..obs.trace import NULL_TRACER
from .contract import CostStats

#: The logical database a service fronts when none is named: the tenant of
#: a bare cache's entries, stamped on service stats and version tokens.
DEFAULT_TENANT = "default"


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
    __slots__ = ("value", "nbytes", "deps", "version", "tenant")

    def __init__(self, value: Any, nbytes: int,
                 deps: Optional[FrozenSet[DepTag]], version: Optional[int],
                 tenant: str):
        self.value, self.nbytes = value, nbytes
        self.deps, self.version = deps, version
        self.tenant = tenant


class _TenantState:
    """Per-tenant accounting: live bytes, budget knobs, and the same
    counter set the store keeps globally (so ``info()["tenants"]`` is a
    faithful per-tenant decomposition of the totals)."""

    __slots__ = ("tenant", "nbytes", "entries", "reserved", "cap", "stats",
                 "hits", "misses", "evictions", "dropped", "invalidated",
                 "delta_updated")

    def __init__(self, tenant: str):
        self.tenant = tenant
        self.nbytes = 0
        self.entries = 0
        self.reserved = 0              # floor: global shrink stops here
        self.cap: Optional[int] = None  # ceiling: own-LRU shrink above it
        self.stats: Optional[CostStats] = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dropped = 0
        self.invalidated = 0
        self.delta_updated = 0

    def info(self) -> dict:
        return dict(entries=self.entries, nbytes=self.nbytes,
                    reserved_bytes=self.reserved, cap_bytes=self.cap,
                    hits=self.hits, misses=self.misses,
                    evictions=self.evictions, dropped=self.dropped,
                    invalidated=self.invalidated,
                    delta_updated=self.delta_updated)


class CtCache:
    """Byte-budgeted LRU cache for ct-tables and message matrices, with
    per-entry ``(version, dependency-tag set)`` freshness metadata and
    per-tenant byte accounting.

    Args:
        budget_bytes: LRU byte budget across all tenants (``None`` =
            unbounded).
        stats: optional :class:`~repro_torch.core.contract.CostStats` whose
            ``cache_bytes``/``peak_bytes`` mirror the live footprint.
        deps_fn: ``key -> frozenset of dependency tags | None`` (relation
            names and/or attribute tuples) used to stamp entries whose
            ``put`` did not pass ``deps`` explicitly (``None`` = unknown,
            dropped conservatively on invalidation).
        version_fn: ``() -> int`` store version used to stamp entries
            whose ``put`` did not pass ``version``.

    Single-tenant callers never see the tenant dimension: every method
    defaults to :data:`DEFAULT_TENANT`.  Multi-tenant callers go through
    :meth:`scoped`.
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
        self._entries: "OrderedDict[Tuple[str, Hashable], _Entry]" = \
            OrderedDict()
        self._tenants: Dict[str, _TenantState] = {}
        # get/put/evict are lock-guarded: the serve layer mutates one shared
        # cache from many client threads (OrderedDict reorder + byte
        # accounting are not atomic on their own)
        self._lock = threading.RLock()
        # request tracer for hit/miss/evict events; NULL_TRACER is free, a
        # real one is wired in by CountingService.set_tracer
        self.tracer = NULL_TRACER
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.dropped = 0
        self.invalidated = 0
        self.delta_updated = 0        # entries refreshed in place by a delta

    # -- tenancy ------------------------------------------------------------
    def _state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            st = self._tenants[tenant] = _TenantState(tenant)
        return st

    def scoped(self, tenant: str) -> "TenantCache":
        """A :class:`TenantCache` view over this store for ``tenant`` —
        drop-in wherever a private ``CtCache`` was used before."""
        with self._lock:
            self._state(tenant)
        return TenantCache(self, tenant)

    def set_tenant_budget(self, tenant: str, reserved_bytes: int = 0,
                          cap_bytes: Optional[int] = None) -> None:
        """Set ``tenant``'s byte reservation (floor the global shrink
        cannot cross) and optional cap (ceiling its own entries shrink
        to).  A cap below current residency shrinks immediately."""
        with self._lock:
            st = self._state(tenant)
            st.reserved = int(reserved_bytes)
            st.cap = None if cap_bytes is None else int(cap_bytes)
            self._shrink_tenant_to_cap(st, just_added=None)

    def tenants_info(self) -> Dict[str, dict]:
        with self._lock:
            return {t: st.info() for t, st in self._tenants.items()}

    # -- core ops -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Hashable) -> bool:
        return (DEFAULT_TENANT, key) in self._entries

    def contains(self, key: Hashable, tenant: str = DEFAULT_TENANT) -> bool:
        return (tenant, key) in self._entries

    def tenant_len(self, tenant: str = DEFAULT_TENANT) -> int:
        with self._lock:
            st = self._tenants.get(tenant)
            return 0 if st is None else st.entries

    def get(self, key: Hashable, default=None,
            tenant: str = DEFAULT_TENANT):
        tr = self.tracer
        tkey = (tenant, key)
        with self._lock:
            hit = self._entries.get(tkey)
            st = self._state(tenant)
            if hit is None:
                self.misses += 1
                st.misses += 1
                if tr.enabled:
                    tr.event("cache.miss", key=key, tenant=tenant)
                return default
            self._entries.move_to_end(tkey)
            self.hits += 1
            st.hits += 1
            if tr.enabled:
                tr.event("cache.hit", key=key, nbytes=hit.nbytes,
                         tenant=tenant)
            return hit.value

    def put(self, key: Hashable, value: Any,
            nbytes: Optional[int] = None,
            deps: Optional[FrozenSet[DepTag]] = None,
            version: Optional[int] = None,
            tenant: str = DEFAULT_TENANT) -> Any:
        """Insert (or refresh) ``key``; returns ``value`` for chaining.

        ``deps``/``version`` default through the ``deps_fn``/``version_fn``
        hooks, so ordinary callers never pass them."""
        nb = _nbytes_of(value) if nbytes is None else int(nbytes)
        if deps is None and self.deps_fn is not None:
            deps = self.deps_fn(key)
        if version is None and self.version_fn is not None:
            version = self.version_fn()
        tkey = (tenant, key)
        with self._lock:
            st = self._state(tenant)
            if tkey in self._entries:
                self._evict_one(tkey)
            self._entries[tkey] = _Entry(value, nb, deps, version, tenant)
            self.nbytes += nb
            st.nbytes += nb
            st.entries += 1
            if self.stats is not None:
                self.stats.bump_cache(nb)  # records the peak before any drop
            if st.stats is not None:
                st.stats.bump_cache(nb)
            self._shrink_tenant_to_cap(st, just_added=tkey)
            self._shrink_to_budget(just_added=tkey)
        return value

    def peek(self, key: Hashable, default=None,
             tenant: str = DEFAULT_TENANT):
        """Read a value WITHOUT hit/miss accounting or an LRU touch — the
        delta-maintenance walk reads entries it is about to refresh, which
        must not look like client traffic."""
        with self._lock:
            e = self._entries.get((tenant, key))
            return default if e is None else e.value

    def discard(self, key: Hashable, tenant: str = DEFAULT_TENANT) -> bool:
        """Drop one entry as *stale* (counted under ``invalidated``, not
        ``evictions``); returns whether it was resident."""
        tkey = (tenant, key)
        with self._lock:
            if tkey not in self._entries:
                return False
            self._evict_one(tkey)
            self.invalidated += 1
            self._state(tenant).invalidated += 1
            return True

    def count_delta_updates(self, n: int = 1,
                            tenant: str = DEFAULT_TENANT) -> None:
        """Record ``n`` entries refreshed in place by a delta (the one
        place the ``delta_updated`` counter moves, under the store lock,
        keeping the global and per-tenant slices in step)."""
        with self._lock:
            self.delta_updated += n
            self._state(tenant).delta_updated += n

    def entry_meta(self, key: Hashable, tenant: str = DEFAULT_TENANT
                   ) -> Optional[Tuple[Optional[FrozenSet[DepTag]],
                                       Optional[int]]]:
        """The ``(deps, version)`` stamp of a resident entry (no LRU
        touch, no hit/miss accounting), or ``None`` when absent."""
        with self._lock:
            e = self._entries.get((tenant, key))
            return None if e is None else (e.deps, e.version)

    def keys_snapshot(self, tenant: str = DEFAULT_TENANT) -> List[Hashable]:
        """A stable snapshot of ``tenant``'s resident keys (LRU -> MRU
        order) — what a delta-maintenance walk iterates while individual
        entries come and go underneath it."""
        with self._lock:
            return [k for (t, k) in self._entries if t == tenant]

    # -- eviction -----------------------------------------------------------
    def _evict_one(self, tkey: Tuple[str, Hashable]) -> None:
        e = self._entries.pop(tkey)
        self.nbytes -= e.nbytes
        st = self._tenants.get(e.tenant)
        if st is not None:
            st.nbytes -= e.nbytes
            st.entries -= 1
            if st.stats is not None:
                st.stats.bump_cache(-e.nbytes)
        if self.stats is not None:
            self.stats.bump_cache(-e.nbytes)
        if self.tracer.enabled:
            self.tracer.event("cache.evict", key=tkey[1], nbytes=e.nbytes,
                              tenant=e.tenant)

    def _protected(self, e: _Entry) -> bool:
        """Would evicting ``e`` push its tenant below its reserved floor?"""
        st = self._tenants.get(e.tenant)
        if st is None or st.reserved <= 0:
            return False
        return st.nbytes - e.nbytes < st.reserved

    def _shrink_tenant_to_cap(self, st: _TenantState,
                              just_added: Optional[Tuple[str, Hashable]]
                              ) -> None:
        """Hold one tenant under its own cap by evicting its LRU entries
        (the reserved floor does not shield a tenant from its *own* cap)."""
        if st.cap is None or st.nbytes <= st.cap:
            return
        for tkey in [tk for tk in self._entries if tk[0] == st.tenant]:
            if st.nbytes <= st.cap or st.entries <= 1:
                break
            if tkey == just_added:
                continue
            self._evict_one(tkey)
            self.evictions += 1
            st.evictions += 1
        if (st.nbytes > st.cap and just_added is not None
                and just_added in self._entries):
            # the new entry alone exceeds the tenant cap: admit-then-drop
            self._evict_one(just_added)
            self.dropped += 1
            st.dropped += 1

    def _shrink_to_budget(self, just_added: Optional[Tuple[str, Hashable]]
                          = None) -> None:
        if self.budget_bytes is None or self.nbytes <= self.budget_bytes:
            return
        # one LRU->MRU pass: evict the oldest entries whose tenants stay
        # at/above their reserved floor; reserved residency is a carve-out
        # the global budget cannot reclaim
        for tkey in list(self._entries):
            if self.nbytes <= self.budget_bytes or len(self._entries) <= 1:
                break
            if tkey == just_added:
                # the just-added entry is only reachable once everything
                # older is gone (it sits at the MRU end anyway)
                continue
            e = self._entries[tkey]
            if self._protected(e):
                continue
            self._evict_one(tkey)
            self.evictions += 1
            st = self._tenants.get(tkey[0])
            if st is not None:
                st.evictions += 1
        if (self.nbytes > self.budget_bytes
                and just_added in self._entries
                and not self._protected(self._entries[just_added])):
            # the new entry alone exceeds the shared headroom: admit-then-
            # drop, so peak_bytes reflects its transient residency
            st = self._tenants.get(just_added[0])
            self._evict_one(just_added)
            self.dropped += 1
            if st is not None:
                st.dropped += 1

    def evict_all(self, tenant: Optional[str] = None) -> None:
        """Evict everything (``tenant=None``) or one tenant's entries."""
        with self._lock:
            for tkey in list(self._entries):
                if tenant is not None and tkey[0] != tenant:
                    continue
                st = self._tenants.get(tkey[0])
                self._evict_one(tkey)
                self.evictions += 1
                if st is not None:
                    st.evictions += 1

    def invalidate(self, rels: Optional[Iterable[str]] = None,
                   tenant: Optional[str] = None) -> int:
        """Drop entries made stale by a write to ``rels``.

        Fine-grained: only entries whose dependency set *intersects*
        ``rels`` are dropped — plus entries with unknown deps (``None``),
        conservatively.  Entries over untouched relations keep their
        residency AND their LRU position.  ``rels=None`` drops everything
        (a full refresh).  ``tenant`` limits the sweep to one tenant's
        entries (``None`` sweeps all tenants — single-store callers see
        exactly the old behaviour, since everything is the default
        tenant's).

        Args:
            rels: relationship names touched by the delta, or ``None``.
            tenant: tenant whose entries to sweep, or ``None`` for all.

        Returns:
            Number of entries dropped.

        Usage::

            dropped = cache.invalidate({delta.rel})
        """
        with self._lock:
            if rels is not None:
                rels = frozenset(rels)
            stale = []
            for tkey, e in self._entries.items():
                if tenant is not None and tkey[0] != tenant:
                    continue
                if rels is None or e.deps is None or e.deps & rels:
                    stale.append(tkey)
            for tkey in stale:
                st = self._tenants.get(tkey[0])
                self._evict_one(tkey)
                if st is not None:
                    st.invalidated += 1
            self.invalidated += len(stale)
            return len(stale)

    def info(self) -> dict:
        out = dict(entries=len(self._entries), nbytes=self.nbytes,
                   budget_bytes=self.budget_bytes, hits=self.hits,
                   misses=self.misses, evictions=self.evictions,
                   dropped=self.dropped, invalidated=self.invalidated,
                   delta_updated=self.delta_updated)
        if self._tenants:
            out["tenants"] = self.tenants_info()
        return out


class TenantCache:
    """One tenant's view of a shared :class:`CtCache` — the drop-in
    handle a :class:`~repro_torch.core.engine.CountingEngine` owns in a
    multi-tenant fleet.

    The engine wires ``deps_fn``/``version_fn``/``stats`` onto *this*
    object (exactly as it would onto a private ``CtCache``); resolution
    happens here before delegating, so tenants never clobber each other's
    hooks on the shared store.  All reads/writes/invalidations are scoped
    to the tenant; counters surface the tenant's own slice.

    Usage::

        store = CtCache(budget_bytes=64 << 20)
        store.set_tenant_budget("acme", reserved_bytes=8 << 20)
        eng = CountingEngine(db, cache=store.scoped("acme"))
    """

    def __init__(self, store: CtCache, tenant: str):
        self._store = store
        self.tenant = tenant
        self.deps_fn: Optional[Callable[[Hashable],
                                        Optional[FrozenSet[DepTag]]]] = None
        self.version_fn: Optional[Callable[[], int]] = None

    # -- hook plumbing ------------------------------------------------------
    @property
    def store(self) -> CtCache:
        return self._store

    def _st(self) -> _TenantState:
        return self._store._state(self.tenant)

    @property
    def tracer(self):
        return self._store.tracer

    @tracer.setter
    def tracer(self, value) -> None:
        self._store.tracer = value

    @property
    def stats(self) -> Optional[CostStats]:
        return self._st().stats

    @stats.setter
    def stats(self, value: Optional[CostStats]) -> None:
        self._st().stats = value

    @property
    def budget_bytes(self) -> Optional[int]:
        cap = self._st().cap
        return cap if cap is not None else self._store.budget_bytes

    @property
    def nbytes(self) -> int:
        return self._st().nbytes

    # -- counters (the tenant's slice; writes go through the locked
    # ``count_delta_updates`` below, which keeps the store total in step) ---
    @property
    def hits(self) -> int:
        return self._st().hits

    @property
    def misses(self) -> int:
        return self._st().misses

    @property
    def evictions(self) -> int:
        return self._st().evictions

    @property
    def dropped(self) -> int:
        return self._st().dropped

    @property
    def invalidated(self) -> int:
        return self._st().invalidated

    @property
    def delta_updated(self) -> int:
        return self._st().delta_updated

    def count_delta_updates(self, n: int = 1) -> None:
        self._store.count_delta_updates(n, tenant=self.tenant)

    # -- scoped ops ---------------------------------------------------------
    def __len__(self) -> int:
        return self._store.tenant_len(self.tenant)

    def __contains__(self, key: Hashable) -> bool:
        return self._store.contains(key, tenant=self.tenant)

    def get(self, key: Hashable, default=None):
        return self._store.get(key, default, tenant=self.tenant)

    def put(self, key: Hashable, value: Any,
            nbytes: Optional[int] = None,
            deps: Optional[FrozenSet[DepTag]] = None,
            version: Optional[int] = None) -> Any:
        if deps is None and self.deps_fn is not None:
            deps = self.deps_fn(key)
        if version is None and self.version_fn is not None:
            version = self.version_fn()
        return self._store.put(key, value, nbytes=nbytes, deps=deps,
                               version=version, tenant=self.tenant)

    def peek(self, key: Hashable, default=None):
        return self._store.peek(key, default, tenant=self.tenant)

    def discard(self, key: Hashable) -> bool:
        return self._store.discard(key, tenant=self.tenant)

    def entry_meta(self, key: Hashable):
        return self._store.entry_meta(key, tenant=self.tenant)

    def keys_snapshot(self) -> List[Hashable]:
        return self._store.keys_snapshot(tenant=self.tenant)

    def evict_all(self) -> None:
        self._store.evict_all(tenant=self.tenant)

    def invalidate(self, rels: Optional[Iterable[str]] = None) -> int:
        return self._store.invalidate(rels, tenant=self.tenant)

    def info(self) -> dict:
        out = self._st().info()
        out["tenant"] = self.tenant
        out["budget_bytes"] = self.budget_bytes
        return out
