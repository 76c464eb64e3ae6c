"""Fixed-bucket log-scale latency histograms (p50/p95/p99 + max).

`CostStats` and `ServiceMetrics` keep *totals* (`exec_s`, `wait_s`);
totals hide tails, and the paper's scalability argument (Fig. 3) is
about tails — one slow batch, one pathological contraction.  A
:class:`LatencyHistogram` buckets each observation by the bit length of
its duration in nanoseconds: bucket ``i`` covers ``[2^(i-1), 2^i) ns``,
64 buckets span sub-nanosecond to ~292 years, and the bucketing is two
integer ops — cheap enough for every queue-wait observation.

Because buckets are *fixed* (no rebalancing, no per-instance state in
the bounds), merging two histograms is element-wise count addition:
exactly associative and commutative, which is what lets
``ServiceMetrics.merged`` roll several services' histograms into one
view's percentiles without bias.  Percentile queries return the upper bound of
the bucket holding that rank (capped at the true observed max), so the
reported p99 is within 2x of the true p99 by construction.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["CountHistogram", "LatencyHistogram", "N_BUCKETS"]

N_BUCKETS = 64


class LatencyHistogram:
    """Log2-bucketed latency histogram over seconds.

    Usage::

        h = LatencyHistogram()
        h.observe(0.004)                  # 4 ms
        h.percentile(0.99)                # upper bound of the p99 bucket
        merged = LatencyHistogram.merged([h1, h2])   # exact count sums
    """

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self, counts: Optional[Sequence[int]] = None,
                 count: int = 0, sum_s: float = 0.0, max_s: float = 0.0):
        self.counts: List[int] = (list(counts) if counts is not None
                                  else [0] * N_BUCKETS)
        if len(self.counts) != N_BUCKETS:
            raise ValueError(f"expected {N_BUCKETS} buckets, "
                             f"got {len(self.counts)}")
        self.count = count
        self.sum_s = sum_s
        self.max_s = max_s

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

    # -- merge / serialisation ---------------------------------------------
    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """In-place element-wise merge (exactly associative); returns self."""
        for i, c in enumerate(other.counts):
            if c:
                self.counts[i] += c
        self.count += other.count
        self.sum_s += other.sum_s
        if other.max_s > self.max_s:
            self.max_s = other.max_s
        return self

    @classmethod
    def merged(cls, many: Iterable["LatencyHistogram"]) -> "LatencyHistogram":
        out = cls()
        for h in many:
            out.merge(h)
        return out

    def copy(self) -> "LatencyHistogram":
        return LatencyHistogram(self.counts, self.count, self.sum_s,
                                self.max_s)

    def as_dict(self) -> Dict[str, float]:
        """Snapshot summary: count, mean, p50/p95/p99, max (seconds)."""
        return dict(count=self.count,
                    mean_s=round(self.mean_s, 6),
                    p50_s=round(self.percentile(0.50), 6),
                    p95_s=round(self.percentile(0.95), 6),
                    p99_s=round(self.percentile(0.99), 6),
                    max_s=round(self.max_s, 6))

    def nonzero_buckets(self) -> List[tuple]:
        """``(upper_bound_s, cumulative_count)`` per occupied bucket —
        the shape Prometheus' ``_bucket{le=...}`` lines need."""
        out, cum = [], 0
        for i, c in enumerate(self.counts):
            if c:
                cum += c
                out.append((self.bucket_upper_s(i), cum))
        return out

    def __eq__(self, other: object) -> bool:
        return (isinstance(other, LatencyHistogram)
                and self.counts == other.counts
                and self.count == other.count)

    def __repr__(self) -> str:       # pragma: no cover - debugging aid
        d = self.as_dict()
        return (f"LatencyHistogram(n={d['count']}, p50={d['p50_s']}s, "
                f"p99={d['p99_s']}s, max={d['max_s']}s)")


class CountHistogram(LatencyHistogram):
    """The same log2-bucketed machinery over dimensionless counts.

    ``observe(n)`` records an integer magnitude (e.g. families re-scored
    per refresh) instead of a duration.  Reusing the latency buckets via
    the nanosecond scaling would shift every observation by 1e9, so the
    count variant buckets the raw value; the merge/percentile algebra is
    inherited unchanged.

    Usage::

        h = CountHistogram()
        h.observe(37)                     # 37 families this refresh
        h.as_dict()["p95"]                # un-suffixed keys: counts, not s
    """

    __slots__ = ()

    @staticmethod
    def bucket_of(value: float) -> int:
        n = int(value)
        if n <= 0:
            return 0
        return min(n.bit_length(), N_BUCKETS - 1)

    @staticmethod
    def bucket_upper_s(i: int) -> float:
        return float(1 << i)

    def as_dict(self) -> Dict[str, float]:
        """Snapshot summary with un-suffixed keys (these are counts)."""
        return dict(count=self.count,
                    mean=round(self.mean_s, 3),
                    p50=round(self.percentile(0.50), 3),
                    p95=round(self.percentile(0.95), 3),
                    p99=round(self.percentile(0.99), 3),
                    max=round(self.max_s, 3))

    def __repr__(self) -> str:       # pragma: no cover - debugging aid
        d = self.as_dict()
        return (f"CountHistogram(n={d['count']}, p50={d['p50']}, "
                f"p99={d['p99']}, max={d['max']})")
