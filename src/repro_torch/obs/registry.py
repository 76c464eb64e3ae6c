"""Metrics export: one registry, two render targets (Prometheus text, JSON).

The serve layer already produces rich snapshots (`ServiceMetrics.snapshot`,
`CountingService.stats`, `CtCache.info`); what was missing is a single
place that collects them and renders formats a scraper or a human can
consume.  A :class:`MetricsRegistry` holds named *sources* — callables
returning nested dicts (or objects with a ``snapshot()``/``stats()``
method, or plain dicts) — and flattens them on demand:

* :meth:`collect` → the raw nested dict per source (JSON-able);
* :meth:`to_json` → that, serialised;
* :meth:`prometheus` → flattened ``repro_<source>_<path>`` gauge lines,
  with :class:`~repro_torch.obs.hist.LatencyHistogram` summaries expanded into
  native ``_bucket{le=...}`` / ``_sum`` / ``_count`` series.

Sources are re-evaluated at every collect, so registering a live
service once is enough; snapshots stay point-in-time.
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Union

import torch

from .hist import LatencyHistogram

__all__ = ["MetricsRegistry", "prometheus_lines"]

Source = Union[dict, Callable[[], dict], object]


def _sanitize(name: str) -> str:
    """Prometheus metric names: ``[a-zA-Z_][a-zA-Z0-9_]*``."""
    out = [(c if c.isalnum() or c == "_" else "_") for c in name]
    s = "".join(out)
    return s if s and not s[0].isdigit() else "_" + s


def prometheus_lines(prefix: str, value, lines: List[str]) -> None:
    """Flatten one snapshot value into Prometheus text lines under
    ``prefix``.  Dicts recurse with ``_``-joined keys; lists/tuples index;
    histograms render native bucket series; numbers become gauges;
    strings and ``None`` are skipped (Prometheus has no string samples).
    A one-element tensor counts as the number it holds."""
    value = _scalar(value)
    if isinstance(value, LatencyHistogram):
        for le, cum in value.nonzero_buckets():
            lines.append(f'{prefix}_bucket{{le="{le:g}"}} {cum}')
        lines.append(f'{prefix}_bucket{{le="+Inf"}} {value.count}')
        lines.append(f"{prefix}_sum {value.sum_s:g}")
        lines.append(f"{prefix}_count {value.count}")
    elif isinstance(value, bool):
        lines.append(f"{prefix} {int(value)}")
    elif isinstance(value, (int, float)):
        lines.append(f"{prefix} {value:g}")
    elif isinstance(value, dict):
        # A histogram that went through as_dict() round-trips as a dict of
        # numbers and is flattened like any other nested mapping.
        for k, v in value.items():
            prometheus_lines(f"{prefix}_{_sanitize(str(k))}", v, lines)
    elif isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            prometheus_lines(f"{prefix}_{i}", v, lines)
    # strings / None / arbitrary objects: not representable, skip


def _scalar(value):
    """A one-element tensor as its Python number (a counter read off the
    card, say); anything else unchanged."""
    if isinstance(value, torch.Tensor) and value.numel() == 1:
        return value.item()
    return value


class MetricsRegistry:
    """Named snapshot sources rendered to Prometheus text or JSON.

    Usage::

        reg = MetricsRegistry()
        reg.register("svc", svc.stats)             # callable, re-evaluated
        reg.register("svc0", svc)                  # object with .stats()
        text = reg.prometheus()
        blob = reg.to_json(indent=2)
    """

    def __init__(self):
        self._sources: Dict[str, Source] = {}

    def register(self, name: str, source: Source) -> None:
        """Attach a source under ``name``.  A source may be a dict, a
        zero-arg callable returning a dict, or an object exposing
        ``snapshot()`` or ``stats()``.  Re-registering replaces."""
        self._sources[name] = source

    def unregister(self, name: str) -> None:
        self._sources.pop(name, None)

    def sources(self) -> List[str]:
        return sorted(self._sources)

    @staticmethod
    def _resolve(source: Source) -> dict:
        if callable(source):
            return source()
        for attr in ("stats", "snapshot"):
            fn = getattr(source, attr, None)
            if callable(fn):
                return fn()
        if isinstance(source, dict):
            return source
        raise TypeError(f"unusable metrics source: {source!r}")

    def collect(self) -> Dict[str, dict]:
        """Evaluate every source; returns ``{name: snapshot_dict}``."""
        return {name: self._resolve(src)
                for name, src in sorted(self._sources.items())}

    def to_json(self, indent: int = None) -> str:
        """The collected snapshots as a JSON document."""
        return json.dumps(self.collect(), indent=indent, sort_keys=True,
                          default=_json_default)

    def prometheus(self) -> str:
        """All sources flattened to Prometheus text exposition format,
        metric names ``repro_<source>_<nested_path>``."""
        lines: List[str] = []
        for name, snap in self.collect().items():
            prometheus_lines(f"repro_{_sanitize(name)}", snap, lines)
        return "\n".join(lines) + ("\n" if lines else "")


def _json_default(obj):
    obj = _scalar(obj)
    if isinstance(obj, (bool, int, float)):
        return obj
    if isinstance(obj, LatencyHistogram):
        return obj.as_dict()
    if isinstance(obj, (set, frozenset)):
        return sorted(map(str, obj))
    if hasattr(obj, "as_dict"):
        return obj.as_dict()
    return str(obj)
