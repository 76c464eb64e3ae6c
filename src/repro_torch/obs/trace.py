"""The no-op request tracer the counting core is wired against.

The core layers (executors, engine, cache) hold a ``tracer`` and open spans
around their dispatches; :data:`NULL_TRACER` is the free default whose every
operation does nothing.  The ring-buffered tracer that records spans is not
part of this package yet.
"""

from __future__ import annotations

from typing import Any


class _NullSpan:
    """A span that records nothing: a context manager whose ``set`` is a
    no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def set(self, **attrs: Any) -> None:
        return None


NULL_SPAN = _NullSpan()


class NullTracer:
    """The off switch: every operation is a no-op returning a shared
    object.  ``enabled`` lets the hottest call sites (cache gets) skip
    even the argument packing."""

    enabled = False

    def span(self, name: str, parent=None, **attrs) -> _NullSpan:
        return NULL_SPAN

    def event(self, name: str, parent=None, **attrs) -> None:
        return None


NULL_TRACER = NullTracer()
