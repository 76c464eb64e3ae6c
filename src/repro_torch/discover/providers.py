"""Count providers: one duck type that lets :class:`~repro_torch.core.search
.StructureSearch` run its candidate-family floods through any layer of the
counting stack without knowing which one it got.

The provider protocol is deliberately tiny::

    provider.schema                      # the relational schema counted over
    provider.prepare(lattice)            # build CT tables / warm caches
    provider.version()                   # hashable token; changes on writes
    provider.family_ct(point, keep)      # one complete family CT
    provider.family_ct_many(point, ks)   # batched complete family CTs

Three adapters implement it:

* :class:`LocalCounts` — wraps a bare :class:`~repro_torch.core.strategies
  .Strategy` (the in-process oracle path).
* :class:`ServiceCounts` — wraps a :class:`~repro_torch.serve.service
  .CountingService`, so floods go through the batching/coalescing queue
  and share its warm CT cache with every other client.
* :class:`RouterCounts` — wraps a :class:`~repro_torch.serve.router
  .CountingRouter`: per-shard positives merge on the device and the
  Möbius completion runs once at the front-end.

Because contingency-table counts are exact integers in every backend
(below 2^24, where float32 holds them), a family's N_ijk tensor is
*bit-identical* regardless of which adapter produced it — that is what
lets the discovery parity tests demand edge-identical models rather than
score-approximate ones.

``version()`` is the mutability hook: it returns ``("db", v)`` (a
router's: ``("shards", v0, v1, ...)``), so a score memo keyed by
``(version, family)`` composes with the delta pipeline — any committed
:class:`~repro_torch.core.database.FactDelta` moves the token and stale
scores stop being addressable.  A backend serving a named tenant prefixes
its token with the tenant id.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ..core.cache import DEFAULT_TENANT
from ..core.database import RelationalDB
from ..core.strategies import Strategy
from ..core.variables import LatticePoint


def _tenant_token(backend, base: Tuple) -> Tuple:
    """Prefix a version token with the backend's tenant id, so a shared
    score memo keyed by ``(version, family)`` keeps tenants' scores
    disjoint: one tenant's writes move ONLY its own token.  Default-tenant
    backends keep the bare token (single-DB memos are unchanged)."""
    tenant = getattr(backend, "tenant", DEFAULT_TENANT)
    return base if tenant == DEFAULT_TENANT else ("tenant", tenant) + base

__all__ = [
    "LocalCounts",
    "ServiceCounts",
    "RouterCounts",
    "as_count_provider",
]


class LocalCounts:
    """Count provider over a bare in-process :class:`Strategy`.

    This is the oracle path: no queue, no shards — exactly what the
    original local ``StructureSearch`` did.

    Args:
        strategy: any of the four counting strategies.
        db: database to ``prepare`` against; may be omitted when the
            strategy was already prepared elsewhere.
    """

    def __init__(self, strategy: Strategy, db: Optional[RelationalDB] = None):
        self.strategy = strategy
        self._db = db if db is not None else getattr(strategy, "db", None)
        if self._db is None:
            raise ValueError("LocalCounts needs a db or a prepared strategy")
        self.tracer = None

    @property
    def schema(self):
        return self._db.schema

    def prepare(self, lattice: Sequence[LatticePoint]) -> None:
        self.strategy.prepare(self._db, lattice)
        self._db = self.strategy.db

    def version(self) -> Tuple:
        return ("db", self._db.version)

    def family_ct(self, point: LatticePoint, keep):
        return self.strategy.family_ct(point, keep)

    def family_ct_many(self, point: LatticePoint, keeps) -> List:
        return self.strategy.family_ct_many(point, keeps)


class ServiceCounts:
    """Count provider over a running :class:`CountingService`.

    Floods issued by the search loop go through ``complete_many`` — the
    batching queue groups same-signature families, coalesces duplicates
    across concurrent searches, and answers repeats from the service's
    warm CT cache (the ``("fam", atoms, keep)`` namespace is shared with
    the bare strategies, so a cache warmed by one client warms them all).
    """

    def __init__(self, service):
        self.service = service
        self.tracer = getattr(service, "tracer", None)

    @property
    def schema(self):
        return self.service.engine.db.schema

    def prepare(self, lattice: Sequence[LatticePoint]) -> None:
        # The service's engine was planned at construction time; nothing
        # per-lattice to build — completions are computed on demand.
        pass

    def version(self) -> Tuple:
        return _tenant_token(self.service,
                             ("db", self.service.engine.db.version))

    def family_ct(self, point: LatticePoint, keep):
        return self.service.count_complete(point, keep)

    def family_ct_many(self, point: LatticePoint, keeps) -> List:
        return self.service.complete_many([(point, tuple(k)) for k in keeps])


class RouterCounts:
    """Count provider over a :class:`CountingRouter` front-end.

    Each family flood fans out across the database shards; per-shard
    positives merge on the device and the Möbius completion runs once at
    the front-end, so the search loop sees exactly the same integer
    tables a single-database run would.
    """

    def __init__(self, router):
        self.router = router
        self.tracer = getattr(router, "tracer", None)

    @property
    def schema(self):
        return self.router.sdb.schema

    def prepare(self, lattice: Sequence[LatticePoint]) -> None:
        pass

    def version(self) -> Tuple:
        sdb = self.router._snapshot()[0]
        return _tenant_token(
            self.router,
            ("shards",) + tuple(sh.version for sh in sdb.shards))

    def family_ct(self, point: LatticePoint, keep):
        return self.router.count_complete(point, keep)

    def family_ct_many(self, point: LatticePoint, keeps) -> List:
        return self.router.complete_many([(point, tuple(k)) for k in keeps])


def as_count_provider(backend, db: Optional[RelationalDB] = None):
    """Adapt ``backend`` into a count provider.

    Accepts a bare :class:`Strategy` (plus ``db``), a
    :class:`CountingService`, a :class:`CountingRouter`, or any object
    already satisfying the provider protocol (returned unchanged).

    Raises:
        TypeError: ``backend`` fits none of these.
    """
    # Lazy imports keep core importable without the serve layer and avoid
    # an import cycle (serve imports discover for its entry points).
    from ..serve.router import CountingRouter
    from ..serve.service import CountingService

    if isinstance(backend, CountingService):
        return ServiceCounts(backend)
    if isinstance(backend, CountingRouter):
        return RouterCounts(backend)
    if isinstance(backend, Strategy):
        return LocalCounts(backend, db)
    needed = ("schema", "prepare", "version", "family_ct", "family_ct_many")
    if all(hasattr(backend, a) for a in needed):
        return backend
    raise TypeError(f"cannot adapt {type(backend).__name__} into a "
                    f"count provider")
