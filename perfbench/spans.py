"""Reading a profiled run's spans: self times, and the span that was
innermost at each instant (what the host was doing while the card sat
idle).

A span is a plain tuple ``(span_id, parent_id, name, start_ns, end_ns,
attrs)`` on the device trace's clock (nanoseconds since the epoch);
``parent_id`` is ``None`` at a root, ``attrs`` a dict or ``None``.  An
interval is ``(start_ns, end_ns)``.  Nothing here imports the program:
:mod:`perfbench.span_readers` takes the spans from it.
"""

from __future__ import annotations

import heapq
from typing import (Dict, Iterable, List, Mapping, Optional, Sequence,
                    Tuple)

Span = Tuple[int, Optional[int], str, int, int, Optional[dict]]
Interval = Tuple[int, int]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of ``intervals`` as sorted, disjoint intervals (empty
    ones dropped)."""
    merged: List[List[int]] = []
    for s, e in sorted(intervals):
        if s >= e:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def gaps(busy: Iterable[Interval], window: Interval) -> List[Interval]:
    """The parts of ``window`` that no interval of ``busy`` covers."""
    lo, hi = window
    out, at = [], lo
    for s, e in union(busy):
        s, e = max(s, lo), min(e, hi)
        if s >= e:
            continue
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


def self_ns(spans: Sequence[Span]) -> Dict[int, int]:
    """Each span's self time: its duration less the union of its
    children's intervals, clipped to it (span id -> ns)."""
    children: Dict[int, List[Interval]] = {}
    for _, parent, _, s, e, _ in spans:
        if parent is not None:
            children.setdefault(parent, []).append((s, e))
    out = {}
    for sid, _, _, s, e, _ in spans:
        covered = sum(min(ce, e) - max(cs, s)
                      for cs, ce in union(children.get(sid, ()))
                      if min(ce, e) > max(cs, s))
        out[sid] = (e - s) - covered
    return out


def innermost(spans: Sequence[Span]) -> List[Tuple[int, int, Optional[str]]]:
    """The time from the first span's start to the last one's end cut
    into ``(start_ns, end_ns, name)`` pieces, ``name`` the innermost span
    open over the piece (the latest started; of two started together,
    the first to end), ``None`` where none is open.  Neighbouring pieces
    of one name are merged."""
    if not spans:
        return []
    by_start = sorted(range(len(spans)), key=lambda i: spans[i][3])
    times = sorted({s[3] for s in spans} | {s[4] for s in spans})
    heap: List[Tuple[int, int, int]] = []
    out: List[List] = []
    k = 0
    for a, b in zip(times, times[1:]):
        while k < len(by_start) and spans[by_start[k]][3] <= a:
            i = by_start[k]
            heapq.heappush(heap, (-spans[i][3], spans[i][4], i))
            k += 1
        while heap and spans[heap[0][2]][4] <= a:
            heapq.heappop(heap)
        name = spans[heap[0][2]][2] if heap else None
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1][1] = b
        else:
            out.append([a, b, name])
    return [(a, b, name) for a, b, name in out]


def time_by_name(pieces: Sequence[Tuple[int, int, Optional[str]]],
                 intervals: Iterable[Interval]) -> Dict[Optional[str], int]:
    """How much of ``intervals`` (say, the card's idle time) lies under
    each name of :func:`innermost`'s ``pieces`` (ns; ``None``: under no
    span, inside or outside the pieces' reach)."""
    out: Dict[Optional[str], int] = {}
    pieces = list(pieces)
    j = 0
    for s, e in union(intervals):
        at = s
        while j < len(pieces) and pieces[j][1] <= s:
            j += 1
        i = j
        while i < len(pieces) and pieces[i][0] < e:
            ps, pe, name = pieces[i]
            lo, hi = max(ps, s), min(pe, e)
            if hi > lo:
                if lo > at:
                    out[None] = out.get(None, 0) + lo - at
                out[name] = out.get(name, 0) + hi - lo
                at = hi
            i += 1
        if e > at:
            out[None] = out.get(None, 0) + e - at
    return out


def named(spans: Sequence[Span], names: Iterable[str]) -> List[Span]:
    wanted = set(names)
    return [s for s in spans if s[2] in wanted]


def seconds(spans: Sequence[Span], names: Iterable[str],
            own: Optional[Mapping[int, int]] = None) -> float:
    """Summed seconds of the spans named ``names``: their durations, or
    their self times where ``own`` (:func:`self_ns`) is given."""
    picked = named(spans, names)
    if own is None:
        return sum(e - s for _, _, _, s, e, _ in picked) / 1e9
    return sum(own[sid] for sid, *_ in picked) / 1e9


def attr_sum(spans: Sequence[Span], name: str, key: str) -> float:
    """The sum of attribute ``key`` over the spans named ``name``."""
    return float(sum((a or {}).get(key, 0) for _, _, n, _, _, a in spans
                     if n == name))
