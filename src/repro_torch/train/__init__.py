"""The LM's train and serve steps (:mod:`.step`), the sharding rules of
multi-rank training (:mod:`.sharding`) and the MoE routing monitor over
HYBRID counting (:mod:`.monitor`)."""

from .monitor import routing_ct, routing_db, routing_trace

__all__ = ["routing_ct", "routing_db", "routing_trace"]
