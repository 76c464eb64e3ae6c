"""Fixed-bucket log-scale latency histograms (p50/p95/p99 + max).

`CostStats` keeps *totals* per phase; totals hide tails, and the
paper's scalability argument (Fig. 3) is about tails — one pathological
contraction.  A :class:`LatencyHistogram` buckets each observation by the
bit length of its duration in nanoseconds: bucket ``i`` covers
``[2^(i-1), 2^i) ns``, 64 buckets span sub-nanosecond to ~292 years, and
the bucketing is two integer ops.  Percentile queries return the upper
bound of the bucket holding that rank (capped at the true observed max),
so the reported p99 is within 2x of the true p99 by construction.
"""

from __future__ import annotations

from typing import Dict, List

__all__ = ["LatencyHistogram", "N_BUCKETS"]

N_BUCKETS = 64


class LatencyHistogram:
    """Log2-bucketed latency histogram over seconds.

    Usage::

        h = LatencyHistogram()
        h.observe(0.004)                  # 4 ms
        h.percentile(0.99)                # upper bound of the p99 bucket
    """

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self):
        self.counts: List[int] = [0] * N_BUCKETS
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    # -- recording ----------------------------------------------------------
    @staticmethod
    def bucket_of(duration_s: float) -> int:
        """Bucket index for a duration: ``min(bitlen(ns), 63)``."""
        ns = int(duration_s * 1e9)
        if ns <= 0:
            return 0
        return min(ns.bit_length(), N_BUCKETS - 1)

    @staticmethod
    def bucket_upper_s(i: int) -> float:
        """Upper bound of bucket ``i`` in seconds (``2^i`` ns)."""
        return (1 << i) / 1e9

    def observe(self, duration_s: float) -> None:
        self.counts[self.bucket_of(duration_s)] += 1
        self.count += 1
        self.sum_s += duration_s
        if duration_s > self.max_s:
            self.max_s = duration_s

    # -- queries ------------------------------------------------------------
    def percentile(self, q: float) -> float:
        """The ``q``-quantile (``0 < q <= 1``) as the upper bound of the
        bucket containing that rank, capped at the observed max.  Empty
        histograms report 0."""
        if self.count == 0:
            return 0.0
        rank = max(1, int(q * self.count + 0.999999))  # ceil, 1-based
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return min(self.bucket_upper_s(i), self.max_s)
        return self.max_s

    @property
    def mean_s(self) -> float:
        return self.sum_s / self.count if self.count else 0.0

    # -- serialisation --------------------------------------------------------
    def as_dict(self) -> Dict[str, float]:
        """Snapshot summary: count, mean, p50/p95/p99, max (seconds)."""
        return dict(count=self.count,
                    mean_s=round(self.mean_s, 6),
                    p50_s=round(self.percentile(0.50), 6),
                    p95_s=round(self.percentile(0.95), 6),
                    p99_s=round(self.percentile(0.99), 6),
                    max_s=round(self.max_s, 6))

    def __repr__(self) -> str:       # pragma: no cover - debugging aid
        d = self.as_dict()
        return (f"LatencyHistogram(n={d['count']}, p50={d['p50_s']}s, "
                f"p99={d['p99_s']}s, max={d['max_s']}s)")

