"""Model discovery over the port's counting stack.

The structure-learning loop (:mod:`repro_torch.core.search`) consumes
family contingency tables; this package makes *where those tables come
from* pluggable — in-process strategy or batching service — and adds the
service-level behaviours that turn one-shot search into a long-running
discovery service: a version-scoped shared score memo,
restart-until-stable consistency against concurrent writes, and selective
delta refresh.
"""

from .providers import LocalCounts, ServiceCounts, as_count_provider
from .service import (DiscoveryMetrics, DiscoveryResult, DiscoveryService,
                      RefreshReport, models_signature)

__all__ = [
    "LocalCounts", "ServiceCounts", "as_count_provider",
    "DiscoveryMetrics", "DiscoveryResult", "DiscoveryService",
    "RefreshReport", "models_signature",
]
