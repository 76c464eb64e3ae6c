"""Service observability: per-signature-bucket latency/throughput plus the
cache hit/miss/eviction counters surfaced from :class:`~repro_torch.core
.cache.CtCache`.

The counting service serves *traffic* rather than one offline run, so its
health is expressed in service terms: how many requests short-circuited on
the cache, how many were coalesced with an identical in-flight request,
how large the signature buckets actually got (batching efficiency), and
what each bucket's execution latency/throughput looks like.  Counters are
mutated from client threads and the dispatcher thread concurrently, so
every mutation goes through :meth:`inc`/``observe_*`` which hold the
instance's lock — plain ``+=`` on a shared counter loses increments under
the thread-switch interleavings a flood produces.

Totals hide tails, so alongside the counters each service keeps
fixed-bucket log-scale :class:`~repro_torch.obs.hist.LatencyHistogram`\\ s
(p50/p95/p99 + max) for queue wait, bucket execution, and end-to-end
latency.  Histogram merge is exactly associative, which is what lets
:meth:`ServiceMetrics.merged` roll several services' histograms into one
view's percentiles without bias.

:meth:`ServiceMetrics.snapshot` is derived from ``dataclasses.fields`` — a
newly added counter appears in dashboards automatically instead of
silently vanishing — and renders one JSON-able dict for dashboards and
benchmarks (histograms as their count/mean/percentile summaries).

On the CUDA card the service synchronises at the end of each batch, so
the execution and end-to-end latencies it records are the card's, not
its launch queue's.
"""

from __future__ import annotations

import dataclasses
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence, Tuple

from ..core.cache import CtCache
from ..obs.hist import LatencyHistogram


def merge_stats_dicts(snaps: Sequence[dict]) -> dict:
    """Deep-merge JSON-able stats dicts: numeric leaves SUM, nested dicts
    recurse, anything else (strings, lists, histogram summaries rendered
    as lists, ``None``) keeps the first occurrence.  Bools are identity
    flags, not counters, so they take first-wins too.

    Nested sub-dicts (a cache's ``info()`` inside a service's stats) are
    merged too, where a flat top-level sum would drop them.

    Args:
        snaps: stats dicts of the same general shape (missing keys fine).

    Returns:
        A fresh merged dict; inputs are not modified.

    Usage::

        agg = merge_stats_dicts([svc.stats()["cache"] for svc in services])
    """
    out: dict = {}
    for snap in snaps:
        for k, v in snap.items():
            if isinstance(v, dict):
                prev = out.get(k)
                out[k] = merge_stats_dicts(
                    [prev, v] if isinstance(prev, dict) else [v])
            elif (isinstance(v, (int, float)) and not isinstance(v, bool)
                  and (k not in out
                       or (isinstance(out[k], (int, float))
                           and not isinstance(out[k], bool)))):
                base = out.get(k, 0)
                out[k] = base + v
            elif k not in out:
                out[k] = v
    return out


@dataclass
class BucketMetrics:
    """One shape-signature bucket's execution statistics (mutated only
    under the owning :class:`ServiceMetrics` lock)."""
    signature: Tuple
    queries: int = 0              # queries executed through this bucket
    batches: int = 0              # positive_batch dispatches issued
    max_batch: int = 0            # largest micro-batch seen
    exec_s: float = 0.0           # total execution wall time

    @property
    def qps(self) -> float:
        return self.queries / self.exec_s if self.exec_s > 0 else 0.0

    def as_dict(self) -> dict:
        return dict(signature=str(self.signature), queries=self.queries,
                    batches=self.batches, max_batch=self.max_batch,
                    exec_s=round(self.exec_s, 6), qps=round(self.qps, 1))


class _LockedMetrics:
    """Shared mutation/snapshot machinery for the metrics dataclasses.

    Fields are partitioned by type: ints/floats sum on merge and appear
    directly in snapshots, :class:`LatencyHistogram` fields merge
    element-wise and snapshot as percentile summaries, and ``_``-prefixed
    fields (the lock) are internal.  Subclasses handle any remaining
    fields (``buckets``) themselves.
    """

    def inc(self, **deltas) -> None:
        """Atomically add ``deltas`` to the named counter fields.

        Usage::

            metrics.inc(requests=1, cache_hits=1)
        """
        with self._lock:
            for name, d in deltas.items():
                setattr(self, name, getattr(self, name) + d)

    @classmethod
    def _numeric_fields(cls):
        return [f.name for f in dataclasses.fields(cls)
                if f.type in ("int", "float", int, float)
                and not f.name.startswith("_")]

    @classmethod
    def _hist_fields(cls):
        return [f.name for f in dataclasses.fields(cls)
                if "LatencyHistogram" in str(f.type)
                and not f.name.startswith("_")]

    def _base_snapshot(self) -> dict:
        """Field-derived snapshot core; caller holds no lock (we take it)."""
        out = {}
        with self._lock:
            for name in self._numeric_fields():
                v = getattr(self, name)
                out[name] = round(v, 6) if isinstance(v, float) else v
            for name in self._hist_fields():
                out[name] = getattr(self, name).as_dict()
        return out


@dataclass
class ServiceMetrics(_LockedMetrics):
    """Aggregate counters for one :class:`~repro_torch.serve.service
    .CountingService` instance."""
    requests: int = 0             # submit()/submit_complete() calls
    complete_requests: int = 0    # submit_complete() calls (also in requests)
    cache_hits: int = 0           # resolved from the CtCache without queueing
    coalesced: int = 0            # merged into an identical in-flight request
    enqueued: int = 0             # entered the request queue
    admitted: int = 0             # passed the tenant admission gate
    shed: int = 0                 # rejected by admission policy "shed"
    rate_limited: int = 0         # over the token-bucket rate (shed or slept)
    throttled: int = 0            # forced drains by admission policy "queue"
    flushes: int = 0              # scheduler drains (any trigger)
    size_flushes: int = 0        # triggered by a bucket hitting max_batch_size
    wait_flushes: int = 0        # triggered by the max_wait deadline
    backpressure_flushes: int = 0  # triggered by in-flight/byte limits
    batches: int = 0              # positive_batch dispatches
    batched_queries: int = 0      # queries that went through a batch dispatch
    mobius_batches: int = 0       # batched negative-phase (Möbius) dispatches
    mobius_stacked: int = 0       # butterfly stacks transformed through them
    mobius_exec_s: float = 0.0    # total batched-transform wall time
    exec_s: float = 0.0           # total bucket execution wall time
    wait_s: float = 0.0           # total queue residency across requests
    deltas: int = 0               # apply_delta() reconciliations
    delta_updated: int = 0        # cache entries refreshed in place
    delta_invalidated: int = 0    # cache entries dropped as stale
    delta_retained: int = 0       # cache entries untouched by deltas
    buckets: Dict[Tuple, BucketMetrics] = field(default_factory=dict)
    queue_wait_hist: LatencyHistogram = field(
        default_factory=LatencyHistogram)   # per-request queue residency
    bucket_exec_hist: LatencyHistogram = field(
        default_factory=LatencyHistogram)   # per-dispatch execution latency
    e2e_hist: LatencyHistogram = field(
        default_factory=LatencyHistogram)   # submit -> result end-to-end
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False, compare=False)

    def observe_mobius(self, n_stacks: int, dt: float) -> None:
        """Record one batched negative-phase dispatch covering
        ``n_stacks`` same-shape butterfly stacks."""
        with self._lock:
            self.mobius_batches += 1
            self.mobius_stacked += n_stacks
            self.mobius_exec_s += dt

    def observe_batch(self, signature: Tuple, n_queries: int,
                      dt: float) -> None:
        with self._lock:
            b = self.buckets.get(signature)
            if b is None:
                b = self.buckets[signature] = BucketMetrics(signature)
            b.queries += n_queries
            b.batches += 1
            b.max_batch = max(b.max_batch, n_queries)
            b.exec_s += dt
            self.batches += 1
            self.batched_queries += n_queries
            self.exec_s += dt
            self.bucket_exec_hist.observe(dt)

    def observe_wait(self, dt: float) -> None:
        with self._lock:
            self.wait_s += dt
            self.queue_wait_hist.observe(dt)

    def observe_e2e(self, dt: float) -> None:
        """Record one request's submit→settle latency."""
        with self._lock:
            self.e2e_hist.observe(dt)

    @property
    def qps(self) -> float:
        return self.batched_queries / self.exec_s if self.exec_s > 0 else 0.0

    @classmethod
    def merged(cls, many: Sequence["ServiceMetrics"]) -> "ServiceMetrics":
        """Roll several services' counters up into one aggregate view.

        Scalar counters and timers sum; latency histograms merge
        element-wise (exactly associative); signature buckets with the
        same signature merge (queries/batches/time sum, ``max_batch``
        takes the max).  The inputs are not modified.

        Args:
            many: the :class:`ServiceMetrics` instances to roll up.

        Returns:
            A fresh aggregate ``ServiceMetrics`` (not registered with any
            service).

        Usage::

            agg = ServiceMetrics.merged([svc.metrics for svc in services])
        """
        out = cls()
        scalar = cls._numeric_fields()
        hists = cls._hist_fields()
        for m in many:
            with m._lock:
                for name in scalar:
                    setattr(out, name, getattr(out, name) + getattr(m, name))
                for name in hists:
                    getattr(out, name).merge(getattr(m, name))
                for sig, b in m.buckets.items():
                    agg = out.buckets.get(sig)
                    if agg is None:
                        agg = out.buckets[sig] = BucketMetrics(sig)
                    agg.queries += b.queries
                    agg.batches += b.batches
                    agg.max_batch = max(agg.max_batch, b.max_batch)
                    agg.exec_s += b.exec_s
        return out

    def snapshot(self, cache: Optional[CtCache] = None) -> dict:
        """One JSON-able health dict covering every dataclass field (new
        counters appear automatically), plus the computed ``qps``; pass
        the engine's cache to include its hit/miss/eviction/dropped
        counters alongside service counters."""
        out = self._base_snapshot()
        out["qps"] = round(self.qps, 1)
        with self._lock:
            out["buckets"] = [b.as_dict() for b in self.buckets.values()]
        if cache is not None:
            out["cache"] = cache.info()
        return out
