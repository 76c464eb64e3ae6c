"""Optional ``torch.profiler`` hooks: line device profiles up with spans.

Host-side spans (:mod:`repro_torch.obs.trace`) stop at the launch — the
device timeline in a ``torch.profiler`` trace shows kernel names, not
"which bucket dispatch was this".  Wrapping each dispatch in a
``torch.profiler.record_function`` with the *same name the span uses*
("exec.positive_batch", "exec.mobius_batch") makes the two timelines
joinable by eye in Perfetto or TensorBoard.

Annotations are off by default (they cost a call into the profiler even
when no profiling session is active) and enabled process-wide via
:func:`enable` or the ``REPRO_TORCH_PROFILE`` environment variable (any
value other than ``""`` / ``"0"``).  When off, :func:`annotate` returns a
shared no-op context manager.
"""

from __future__ import annotations

import os

import torch

__all__ = ["annotate", "enable", "disable", "enabled"]


class _NullAnnotation:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL = _NullAnnotation()
_enabled = False


def enable() -> bool:
    """Turn profiler annotations on; returns whether they are on."""
    global _enabled
    _enabled = True
    return _enabled


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def annotate(name: str):
    """A context manager marking ``name`` on the profiler timeline
    (``torch.profiler.record_function``) when enabled, or a shared no-op
    otherwise.

    Usage::

        with annotate("exec.mobius_batch_fused"):
            out = ops.mobius(x)
    """
    if _enabled:
        return torch.profiler.record_function(name)
    return _NULL


if os.environ.get("REPRO_TORCH_PROFILE", "").strip() not in ("", "0"):
    enable()
