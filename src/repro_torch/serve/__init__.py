"""Serve layer of the PyTorch port: bucketed plan execution.

:func:`execute_bucketed` and :func:`execute_complete_bucketed` bridge
shape-signature micro-batches and the executors' stacked entry point
(:meth:`~repro_torch.core.executors.Executor.positive_batch`).  The
counting service, its metrics and the multi-database paths are not part
of this package yet.
"""

from .batching import execute_bucketed, execute_complete_bucketed

__all__ = ["execute_bucketed", "execute_complete_bucketed"]
