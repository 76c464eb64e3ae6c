"""Slow-query log: the top-K slowest requests over a threshold.

Percentile histograms (:mod:`repro_torch.obs.hist`) say *that* a p99 exists;
the slow-query log says *which queries it was* — each entry keeps the
span name, duration, and whatever the call site knew (plan signature,
lattice point, complete or positive), so the offender can be replayed.

A bounded min-heap keyed on duration keeps the K slowest seen; offers
under the threshold are one float compare, so the log is safe to feed
from the serve layer's end-to-end observation points unconditionally.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from typing import List, Optional

__all__ = ["SlowQuery", "SlowQueryLog"]


class SlowQuery:
    """One slow request: what it was, how long it took, what the serve
    layer knew about it."""

    __slots__ = ("name", "duration_s", "at", "info")

    def __init__(self, name: str, duration_s: float, at: float, info: dict):
        self.name, self.duration_s, self.at = name, duration_s, at
        self.info = info

    def as_dict(self) -> dict:
        return dict(name=self.name, duration_s=round(self.duration_s, 6),
                    at=round(self.at, 3),
                    info={k: (v if isinstance(v, (int, float, bool,
                                                  type(None))) else str(v))
                          for k, v in self.info.items()})

    def __repr__(self) -> str:       # pragma: no cover - debugging aid
        return (f"SlowQuery({self.name!r}, {self.duration_s * 1e3:.1f}ms, "
                f"{self.info!r})")


class SlowQueryLog:
    """Top-K slowest offers above ``threshold_s``.

    Args:
        threshold_s: durations at or below this are ignored; ``None``
            disables automatic offers (``offer`` returns ``False``) while
            keeping the object around so call sites stay unconditional.
        top_k: how many entries to retain (smallest is evicted first).

    Usage::

        log = SlowQueryLog(threshold_s=0.05, top_k=16)
        log.offer("service.e2e", dt, sig=sig, complete=False)
        for q in log.entries():
            print(q.name, q.duration_s, q.info)
    """

    def __init__(self, threshold_s: Optional[float] = 0.05, top_k: int = 32):
        self.threshold_s = threshold_s
        self.top_k = top_k
        self._heap: List[tuple] = []   # (duration, tiebreak, SlowQuery)
        self._tie = itertools.count()
        self._lock = threading.Lock()
        self.offered = 0
        self.admitted = 0

    def offer(self, name: str, duration_s: float, **info) -> bool:
        """Consider one request; returns whether it was admitted."""
        self.offered += 1
        thr = self.threshold_s
        if thr is None or duration_s <= thr:
            return False
        with self._lock:
            if len(self._heap) >= self.top_k:
                if duration_s <= self._heap[0][0]:
                    return False
                heapq.heappop(self._heap)
            heapq.heappush(self._heap, (duration_s, next(self._tie),
                                        SlowQuery(name, duration_s,
                                                  time.time(), info)))
            self.admitted += 1
        return True

    def entries(self) -> List[SlowQuery]:
        """Retained queries, slowest first."""
        with self._lock:
            return [q for _, _, q in sorted(self._heap, reverse=True)]

    def as_dicts(self) -> List[dict]:
        return [q.as_dict() for q in self.entries()]

    def clear(self) -> None:
        with self._lock:
            self._heap.clear()
        self.offered = self.admitted = 0

    def __len__(self) -> int:
        return len(self._heap)
