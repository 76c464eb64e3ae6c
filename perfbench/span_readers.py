"""What the readers of the program's spans share: the spans a profiled
discovery window recorded, taken from the program's process-wide
profiled tracer (``repro_torch.obs.profile.profiled_tracer``), as
:mod:`perfbench.spans` tuples.

A program without that tracer gives nothing to read (``None``), and so
does a window that recorded no span at all.  A reading raises where the
tracer's ring dropped a span, or where the window's ``discover.run``
roots are not one a discovery (``rec["units"]``).
"""

from __future__ import annotations

from typing import List, Mapping, Optional

from . import spans as sp

#: Spans whose self time is the search's own host work.
SEARCH = ("discover.point", "discover.round")
#: The root span, one a discovery; time under it and under no other span
#: is the part of the idle card the spans do not name.
ROOT = "discover.run"


def window_spans(rec: Mapping) -> Optional[List[sp.Span]]:
    """The profiled tracer's spans in the traced window: those within
    ``rec["device"].window`` on the card, every resident span off it."""
    try:
        from repro_torch.obs import profile
    except ImportError:
        return None
    get = getattr(profile, "profiled_tracer", None)
    if get is None:
        return None
    tracer = get()
    health = tracer.snapshot()
    if health["recorded"] == 0:
        return None
    if health["dropped"]:
        raise RuntimeError(f"the profiled tracer's ring of "
                           f"{health['capacity']} spans dropped "
                           f"{health['dropped']}")
    spans = [(r.span_id, r.parent_id, r.name, round(r.t0 * 1e9),
              round(r.t1 * 1e9), r.attrs) for r in tracer.records()]
    dev = rec.get("device")
    if dev is not None:
        lo, hi = dev.window
        spans = [s for s in spans if s[3] >= lo and s[4] <= hi]
    roots = sum(1 for s in spans if s[2] == ROOT and s[1] is None)
    if roots != rec.get("units"):
        raise RuntimeError(f"the window holds {roots} {ROOT} spans and "
                           f"{rec.get('units')} discoveries")
    return spans


def self_seconds(rec: Mapping, names) -> Optional[float]:
    """Self seconds of the spans named ``names``, per discovery."""
    spans = window_spans(rec)
    if spans is None:
        return None
    return sp.seconds(spans, names, sp.self_ns(spans)) / rec["units"]


def span_seconds(rec: Mapping, names) -> Optional[float]:
    """Seconds of the spans named ``names``, per discovery."""
    spans = window_spans(rec)
    if spans is None:
        return None
    return sp.seconds(spans, names) / rec["units"]


def attr_per_unit(rec: Mapping, name: str, key: str) -> Optional[float]:
    """Attribute ``key`` summed over the spans named ``name``, per
    discovery."""
    spans = window_spans(rec)
    if spans is None:
        return None
    return sp.attr_sum(spans, name, key) / rec["units"]


def idle_by_innermost(rec: Mapping) -> Optional[dict]:
    """The card's idle ns in the traced window by the innermost span open
    (``None``: under no span), from the trace's device events; nothing
    off the card."""
    dev = rec.get("device")
    if dev is None:
        return None
    spans = window_spans(rec)
    if spans is None:
        return None
    idle = sp.gaps([(s, e) for s, e, *_ in dev.device], dev.window)
    return sp.time_by_name(sp.innermost(spans), idle)


def idle_unnamed_pct(rec: Mapping) -> Optional[float]:
    """The share of the window's idle time in which no span but the root
    is open, between roots included, in %."""
    by_name = idle_by_innermost(rec)
    if by_name is None:
        return None
    total = sum(by_name.values())
    if total <= 0:
        return None
    return 100.0 * (by_name.get(None, 0) + by_name.get(ROOT, 0)) / total
