"""Counting query service of the PyTorch port: signature-bucketed
micro-batching over the planner/executor/cache engine
(:mod:`repro_torch.core`), with cross-database routing when the data is
horizontally partitioned and a multi-tenant registry over one shared pool.

Layering::

    clients (structure search / discovery service / external threads)
        -> TenantRegistry    (many databases, one pool)        tenancy.py
        -> CountingRouter    (shard fan-out, count merging)    router.py
        -> CountingService   (queue, buckets, backpressure)    service.py
        -> execute_bucketed  (shape-signature micro-batches)   batching.py
        -> Executor.positive_batch (stacked plans, K1/K2)      core/executors.py
        -> CtCache           (shared byte-budgeted storage)    core/cache.py

A single-database deployment talks to one :class:`CountingService`
directly; a sharded deployment (:func:`~repro_torch.core.database
.shard_database`) puts one :class:`CountingRouter` in front of one service
per shard, every shard on the router's one device; a multi-tenant fleet
(:class:`TenantRegistry`) puts many logical databases behind ONE shared
executor + byte-budgeted cache store, with per-tenant admission control and
cross-tenant fused dispatch.  Mesh sharding of one database's counting
over the ranks of a ``torch.distributed`` group is the executor
``"sparse_sharded"`` (:mod:`repro_torch.core.distributed`); a router built
with it runs one such executor per shard, all over the one group.
"""

from ..core.executors import plan_stack_key
from .batching import (TableMerger, execute_bucketed, execute_bucketed_multi,
                       execute_complete_bucketed)
from .metrics import (BucketMetrics, RouterMetrics, ServiceMetrics,
                      merge_stats_dicts)
from .router import CountingRouter, NotRoutableError, RouterTicket
from .service import (CountingService, CountTicket, ServiceShutdown,
                      TenantAdmissionError)
from .tenancy import Tenant, TenantRegistry

__all__ = [
    "CountingService", "CountTicket", "ServiceShutdown",
    "CountingRouter", "RouterTicket", "NotRoutableError",
    "Tenant", "TenantRegistry", "TenantAdmissionError",
    "ServiceMetrics", "BucketMetrics", "RouterMetrics",
    "merge_stats_dicts", "TableMerger",
    "execute_bucketed", "execute_bucketed_multi",
    "execute_complete_bucketed", "plan_stack_key",
]
