"""Counting query service of the PyTorch port: signature-bucketed
micro-batching over the planner/executor/cache engine
(:mod:`repro_torch.core`).

Layering::

    clients (structure search / discovery service / external threads)
        -> CountingService   (queue, buckets, backpressure)   service.py
        -> execute_bucketed  (shape-signature micro-batches)  batching.py
        -> Executor.positive_batch (stacked plans, K1/K2)     core/executors.py
        -> CtCache           (shared byte-budgeted storage)   core/cache.py

A single-database deployment talks to one :class:`CountingService`
directly.  Database sharding, the router in front of one service per
shard and the multi-tenant registry are not part of this package yet.
"""

from .batching import execute_bucketed, execute_complete_bucketed
from .metrics import BucketMetrics, ServiceMetrics, merge_stats_dicts
from .service import (CountingService, CountTicket, ServiceShutdown,
                      TenantAdmissionError)

__all__ = [
    "CountingService", "CountTicket", "ServiceShutdown",
    "TenantAdmissionError",
    "ServiceMetrics", "BucketMetrics", "merge_stats_dicts",
    "execute_bucketed", "execute_complete_bucketed",
]
