"""Profiler annotations on the device timeline.

:func:`annotate` names a region of host code so that a ``torch.profiler``
trace shows it above the kernels it launched.
"""

from __future__ import annotations

import torch


def annotate(name: str):
    """A context manager marking ``name`` on the profiler timeline
    (``torch.profiler.record_function``).

    Usage::

        with annotate("exec.mobius_batch_fused"):
            out = ops.mobius(x)
    """
    return torch.profiler.record_function(name)
