"""The port's observability stack, mirrored from
``tests/test_observability.py`` and held to the JAX package's.

* :mod:`repro_torch.obs.hist` — log-bucket percentile histograms whose
  merge is exactly associative/commutative; the same seeded durations and
  counts give the JAX package's buckets, percentiles and summaries.
* :mod:`repro_torch.obs.trace` — ring-buffered request spans: implicit
  same-thread nesting, explicit cross-thread parenting by value,
  retroactive spans, and tree reconstruction equal to the JAX package's
  for the same records.
* :mod:`repro_torch.serve.metrics` — lock-guarded counters stay EXACT
  under a concurrent flood; snapshots are derived from
  ``dataclasses.fields``; ``merged`` is an element-wise sum.
* :mod:`repro_torch.obs.registry` — the same snapshots render to the same
  Prometheus and JSON text as the JAX package's registry, and a torch
  scalar renders as the number it holds.
* :mod:`repro_torch.obs.profile` — a discovery inside a CPU profiler
  records its spans, each within its parent, into the profiled tracer,
  and records none outside one; a span holds the profiler's event of the
  operator inside it (one clock); collections become ``host.gc`` spans.
* End to end on the CPU — a traced service nests every ``service.exec``
  under its ``service.queue`` span, and a traced discovery records its
  search rounds.

The JAX package's five tests that build a ``CountingRouter`` have no
counterpart here: the router is not ported yet (ROADMAP item 11).
"""

import dataclasses
import json
import sys
import threading
import time

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

import repro.obs as jobs
import repro_torch.core as tc
from repro.serve import ServiceMetrics as JaxServiceMetrics
from repro_torch.obs import (CountHistogram, LatencyHistogram,
                             MetricsRegistry, N_BUCKETS, NULL_TRACER,
                             SlowQueryLog, SpanRecord, Tracer, build_trees,
                             default_tracer)
from repro_torch.obs import profile
from repro_torch.obs.trace import NullTracer
from repro_torch.serve import CountingService, ServiceMetrics
from tests.test_serve import flood_db as jax_flood_db
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import to_port

CPU = "cpu"
JOIN_S = 30.0                      # every join and result is bounded


def flood_db(**kw):
    return to_port(jax_flood_db(**kw))


def engine(db, ex="sparse"):
    return tc.CountingEngine(db, ex, tc.CostStats(), device=CPU)


# ------------------------------------------------------------- histogram --

def _random_hist(rng, n=50, scale=0.02):
    h = LatencyHistogram()
    for _ in range(n):
        h.observe(float(rng.uniform(0, scale)))
    return h


def test_histogram_buckets_and_percentiles():
    h = LatencyHistogram()
    assert h.percentile(0.99) == 0.0                 # empty reports zero
    for ms in (1, 1, 1, 1, 1, 1, 1, 1, 1, 100):      # one 100ms straggler
        h.observe(ms / 1e3)
    assert h.count == 10
    assert h.percentile(0.50) <= h.percentile(0.95) <= h.percentile(0.99)
    # the p99 bucket bound is within 2x of the true tail by construction
    assert 0.1 <= h.percentile(0.99) <= 0.2
    assert h.max_s == pytest.approx(0.1)
    d = h.as_dict()
    assert set(d) == {"count", "mean_s", "p50_s", "p95_s", "p99_s", "max_s"}
    # a single observation's percentile is capped at the observed max
    one = LatencyHistogram()
    one.observe(0.003)
    assert one.percentile(0.5) == pytest.approx(0.003)


def test_histogram_bucket_of_bounds():
    assert LatencyHistogram.bucket_of(0.0) == 0
    assert LatencyHistogram.bucket_of(-1.0) == 0
    assert LatencyHistogram.bucket_of(1e12) == N_BUCKETS - 1
    for d in (1e-9, 1e-6, 1e-3, 1.0):
        i = LatencyHistogram.bucket_of(d)
        assert d <= LatencyHistogram.bucket_upper_s(i)


def test_histogram_merge_associative_and_commutative():
    rng = np.random.default_rng(0)
    hs = [_random_hist(rng) for _ in range(4)]
    left = LatencyHistogram()
    for h in hs:
        left.merge(h)
    right = LatencyHistogram()
    for h in reversed(hs):
        right.merge(h)
    nested = LatencyHistogram.merged(
        [LatencyHistogram.merged(hs[:2]), LatencyHistogram.merged(hs[2:])])
    assert left == right == nested
    assert left.count == sum(h.count for h in hs)
    assert left.sum_s == pytest.approx(sum(h.sum_s for h in hs))
    assert left.max_s == max(h.max_s for h in hs)
    for i in range(N_BUCKETS):
        assert left.counts[i] == sum(h.counts[i] for h in hs)
    for h in hs:                                     # inputs untouched
        assert h.count == 50
    assert left.copy() == left and left.copy() is not left


def test_histogram_prometheus_bucket_shape():
    h = LatencyHistogram()
    for ms in (1, 2, 4, 50):
        h.observe(ms / 1e3)
    buckets = h.nonzero_buckets()
    assert buckets[-1][1] == h.count                 # cumulative counts
    uppers = [u for u, _ in buckets]
    assert uppers == sorted(uppers)


def test_histogram_counts_constructor_checks_length():
    h = LatencyHistogram(counts=[1] + [0] * (N_BUCKETS - 1), count=1,
                         sum_s=1e-9, max_s=1e-9)
    assert h.percentile(1.0) == pytest.approx(1e-9)
    with pytest.raises(ValueError):
        LatencyHistogram(counts=[0, 1])


@pytest.mark.parametrize("kind", ["latency", "count"])
def test_histograms_equal_jax(kind):
    """The same seeded observations through both packages' histograms give
    the same buckets, percentiles, summaries and Prometheus buckets."""
    rng = np.random.default_rng(17)
    if kind == "latency":
        values = np.concatenate([rng.uniform(0, 0.02, 200),
                                 rng.exponential(0.5, 50), [0.0, 1e-10]])
        ours, theirs = LatencyHistogram(), jobs.LatencyHistogram()
    else:
        values = np.concatenate([rng.integers(0, 5000, 200),
                                 rng.integers(0, 3, 20), [0, 1 << 40]])
        ours, theirs = CountHistogram(), jobs.CountHistogram()
    for v in values:
        ours.observe(float(v))
        theirs.observe(float(v))
        assert ours.bucket_of(float(v)) == theirs.bucket_of(float(v))
    assert ours.counts == theirs.counts
    for q in (0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert ours.percentile(q) == theirs.percentile(q)
    assert ours.as_dict() == theirs.as_dict()
    assert ours.nonzero_buckets() == theirs.nonzero_buckets()
    halves = [type(ours)(), type(ours)()]
    for i, v in enumerate(values):
        halves[i % 2].observe(float(v))
    assert type(ours).merged(halves) == ours


# ----------------------------------------------------------------- tracer --

def test_tracer_nesting_and_trees():
    tr = Tracer(capacity=64)
    with tr.span("root", mode="fanout") as root:
        ctx = root.context
        with tr.span("child"):
            pass
    tr.record("retro", 0.0, 1.0, parent=ctx, shard=1)
    tr.event("mark", parent=ctx)
    trees = tr.trees()
    assert len(trees) == 1
    (t,) = trees
    assert t["spans"] == 4
    (r,) = t["roots"]
    assert r["name"] == "root" and r["attrs"]["mode"] == "fanout"
    assert {c["name"] for c in r["children"]} == {"child", "retro", "mark"}


def test_tracer_cross_thread_parenting():
    tr = Tracer()
    with tr.span("submit") as sp:
        ctx = sp.context

    def worker():
        t0 = time.perf_counter()
        tr.record("queue", t0, time.perf_counter(), parent=ctx)

    th = threading.Thread(target=worker)
    th.start()
    th.join(JOIN_S)
    assert not th.is_alive()
    recs = tr.records()
    assert len({r.trace_id for r in recs}) == 1      # one trace, two threads
    child = next(r for r in recs if r.name == "queue")
    parent = next(r for r in recs if r.name == "submit")
    assert child.parent_id == parent.span_id
    assert child.thread != parent.thread


def test_tracer_ring_drops_oldest():
    tr = Tracer(capacity=4)
    for i in range(10):
        tr.event(f"e{i}")
    snap = tr.snapshot()
    assert snap["recorded"] == 10
    assert snap["resident"] == 4
    assert snap["dropped"] == 6
    assert [r.name for r in tr.records()] == ["e6", "e7", "e8", "e9"]
    tr.clear()
    assert tr.snapshot()["recorded"] == 0


def test_build_trees_promotes_orphans():
    tr = Tracer(capacity=2)                          # parent falls off
    ctx = tr.record("parent", 0.0, 1.0)
    tr.event("a", parent=ctx)
    tr.event("b", parent=ctx)
    assert [r.name for r in tr.records()] == ["a", "b"]
    trees = build_trees(tr.records())
    (t,) = trees
    assert {r["name"] for r in t["roots"]} == {"a", "b"}


def test_build_trees_equal_jax():
    """The same span records (ids, parents, times, attributes, threads)
    nest into the same trees in both packages, orphans included."""
    rng = np.random.default_rng(5)
    fields = []
    for trace_id in (1, 2, 3):
        ids = list(range(trace_id * 100, trace_id * 100 + 12))
        for n, span_id in enumerate(ids):
            parent = (None if n == 0 else
                      int(rng.choice(ids[:n])) if n < 10 else 999_999)
            t0 = float(rng.uniform(0, 1))
            fields.append((trace_id, span_id, parent, f"s{n % 4}", t0,
                           t0 + float(rng.uniform(0, 0.1)),
                           {"k": n, "sig": ("pos", n)} if n % 3 else None,
                           f"t{n % 2}"))
    order = rng.permutation(len(fields))
    ours = build_trees([SpanRecord(*fields[i]) for i in order])
    theirs = jobs.build_trees([jobs.SpanRecord(*fields[i]) for i in order])
    assert ours == theirs
    assert len(ours) == 3


def test_null_tracer_is_inert():
    tr = NULL_TRACER
    assert not tr.enabled and tr.slow is None
    with tr.span("x", attrs=1) as sp:
        assert sp.context is None
        sp.set(y=2)
    assert tr.record("r", 0.0, 1.0) is None
    assert tr.records() == [] and tr.trees() == []
    assert tr.traces() == {}
    tr.clear()
    assert tr.snapshot()["enabled"] is False


def test_default_tracer_env_knob(monkeypatch):
    monkeypatch.delenv("REPRO_TRACE", raising=False)
    assert default_tracer() is NULL_TRACER
    monkeypatch.setenv("REPRO_TRACE", "0")
    assert default_tracer() is NULL_TRACER
    monkeypatch.setenv("REPRO_TRACE", "4096")
    tr = default_tracer()
    assert isinstance(tr, Tracer) and tr.capacity == 4096
    monkeypatch.setenv("REPRO_TRACE", "on")
    assert default_tracer().capacity == 65536
    monkeypatch.setenv("REPRO_TRACE_SLOW_MS", "10")
    assert default_tracer().slow.threshold_s == pytest.approx(0.01)


def test_service_picks_up_env_tracer(monkeypatch):
    monkeypatch.setenv("REPRO_TRACE", "512")
    db = flood_db(n_rels=2, edges=8)
    eng = engine(db)
    svc = CountingService(eng, max_batch_size=8)
    try:
        assert svc.tracer.enabled and svc.tracer.capacity == 512
        # one tracer instance threaded through engine/executor/cache
        assert eng.tracer is svc.tracer
        assert eng.executor.tracer is svc.tracer
        assert eng.cache.tracer is svc.tracer
        point = tc.build_lattice(db.schema, 1)[0]
        svc.count(point)
        names = {r.name for r in svc.tracer.records()}
        assert "service.queue" in names
        assert "service.exec" in names
        assert svc.stats()["tracer"]["enabled"] is True
    finally:
        svc.shutdown(timeout=JOIN_S)


# --------------------------------------------------------------- slow log --

def test_slow_query_log_keeps_top_k():
    log = SlowQueryLog(threshold_s=0.0, top_k=3)
    for i, ms in enumerate([5, 1, 9, 3, 7]):
        log.offer(f"q{i}", ms / 1e3, shard=i)
    got = [round(q.duration_s * 1e3) for q in log.entries()]
    assert got == [9, 7, 5]                          # slowest first
    assert log.offered == 5 and log.admitted >= 3
    assert log.entries()[0].info["shard"] == 2
    assert all(set(d) == {"name", "duration_s", "at", "info"}
               for d in log.as_dicts())


def test_slow_query_log_threshold_and_disable():
    log = SlowQueryLog(threshold_s=0.05, top_k=4)
    assert not log.offer("fast", 0.01)
    assert log.offer("slow", 0.10)
    assert len(log.entries()) == 1
    off = SlowQueryLog(threshold_s=None)
    assert not off.offer("anything", 99.0)
    assert off.entries() == []


# ---------------------------------------------------------------- metrics --

def test_snapshots_cover_every_dataclass_field():
    """Snapshots are field-derived — a newly added counter cannot silently
    vanish from dashboards — and name the JAX package's counters."""
    svc_snap = ServiceMetrics().snapshot()
    for f in dataclasses.fields(ServiceMetrics):
        if not f.name.startswith("_"):
            assert f.name in svc_snap, f.name
    # histograms snapshot as percentile summaries
    assert svc_snap["queue_wait_hist"]["count"] == 0
    assert svc_snap == JaxServiceMetrics().snapshot()


def test_metrics_inc_exact_under_concurrent_flood():
    """Client and dispatcher threads collide on the counters; ``inc`` must
    be exact."""
    m = ServiceMetrics()
    n_threads, n_iter = 8, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                      # force interleavings
    try:
        def worker():
            for _ in range(n_iter):
                m.inc(requests=1, enqueued=1)
                m.observe_wait(1e-6)
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(JOIN_S)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert m.requests == n_threads * n_iter
    assert m.enqueued == n_threads * n_iter
    assert m.queue_wait_hist.count == n_threads * n_iter


def test_service_metrics_merged_is_elementwise_sum():
    """``merged`` equals the element-wise sum over every numeric field,
    histogram, and signature bucket (where ``max_batch`` takes the max,
    not the sum)."""
    rng = np.random.default_rng(3)
    many = []
    for i in range(3):
        m = ServiceMetrics()
        for name in ServiceMetrics._numeric_fields():
            m.inc(**{name: int(rng.integers(0, 50))})
        for _ in range(int(rng.integers(5, 25))):
            m.observe_wait(float(rng.uniform(0, 0.01)))
            m.observe_e2e(float(rng.uniform(0, 0.05)))
        m.observe_batch(("sig", i % 2), int(rng.integers(1, 9)), 0.001)
        m.observe_mobius(int(rng.integers(1, 9)), 0.002)
        many.append(m)
    agg = ServiceMetrics.merged(many)
    for name in ServiceMetrics._numeric_fields():
        assert getattr(agg, name) == pytest.approx(
            sum(getattr(m, name) for m in many)), name
    for name in ServiceMetrics._hist_fields():
        assert getattr(agg, name) == LatencyHistogram.merged(
            getattr(m, name) for m in many), name
    for sig, b in agg.buckets.items():
        parts = [m.buckets[sig] for m in many if sig in m.buckets]
        assert b.queries == sum(p.queries for p in parts)
        assert b.batches == sum(p.batches for p in parts)
        assert b.exec_s == pytest.approx(sum(p.exec_s for p in parts))
        assert b.max_batch == max(p.max_batch for p in parts)
    for m in many:                                   # inputs untouched
        assert m is not agg


# --------------------------------------------------------------- registry --

def test_registry_prometheus_and_json_rendering():
    m = ServiceMetrics()
    m.inc(requests=3, cache_hits=1)
    m.observe_wait(0.002)
    reg = MetricsRegistry()
    reg.register("svc", m.snapshot)                  # callable source
    reg.register("hists", lambda: {"queue_wait": m.queue_wait_hist})
    reg.register("plain", {"up": True, "shards": [1, 2]})
    assert reg.sources() == ["hists", "plain", "svc"]
    text = reg.prometheus()
    assert "repro_svc_requests 3" in text
    assert "repro_svc_cache_hits 1" in text
    assert "repro_svc_queue_wait_hist_p99_s" in text   # flattened summary
    assert 'repro_hists_queue_wait_bucket{le="+Inf"} 1' in text
    assert "repro_hists_queue_wait_count 1" in text    # native histogram
    assert "repro_plain_up 1" in text
    assert "repro_plain_shards_1 2" in text
    data = json.loads(reg.to_json(indent=2))
    assert data["svc"]["requests"] == 3
    assert data["hists"]["queue_wait"]["count"] == 1
    reg.unregister("plain")
    assert "repro_plain_up" not in reg.prometheus()


def test_registry_rejects_unusable_source():
    reg = MetricsRegistry()
    reg.register("bad", 42)
    with pytest.raises(TypeError):
        reg.collect()


def _snapshot_pair(hist_cls, metrics_cls):
    """One seeded snapshot built from either package's classes."""
    rng = np.random.default_rng(29)
    m = metrics_cls()
    m.inc(requests=7, cache_hits=2, coalesced=1)
    h = hist_cls()
    for v in rng.uniform(0, 0.03, 40):
        m.observe_wait(float(v))
        m.observe_e2e(2 * float(v))
        h.observe(float(v))
    m.observe_batch(("pos", (("attr", 3),)), 5, 0.004)
    return dict(svc=m.snapshot(), hist=h, nested={
        "a": {"b": [1, 2.5, {"c": 3}], "s": "skip", "n": None},
        "flag": False, "big": 1.5e12, "set": {"x", "y"}})


def test_registry_text_equal_jax():
    """Equal snapshots registered in both packages' registries render to
    identical Prometheus and JSON text."""
    ours = _snapshot_pair(LatencyHistogram, ServiceMetrics)
    theirs = _snapshot_pair(jobs.LatencyHistogram, JaxServiceMetrics)
    regs = (MetricsRegistry(), jobs.MetricsRegistry())
    for reg, snap in zip(regs, (ours, theirs)):
        for name, src in snap.items():
            reg.register(name, (lambda s=src: {"v": s}))
    assert regs[0].prometheus() == regs[1].prometheus()
    assert regs[0].to_json() == regs[1].to_json()
    assert regs[0].to_json(indent=2) == regs[1].to_json(indent=2)


def test_registry_renders_torch_scalars_as_numbers():
    """A counter read off the device as a one-element tensor renders as
    the number it holds, where the JAX registry takes a Python number."""
    reg, ref = MetricsRegistry(), jobs.MetricsRegistry()
    reg.register("dev", {"launches": torch.tensor(12),
                         "busy_s": torch.tensor([0.25]),
                         "ok": torch.tensor(True)})
    ref.register("dev", {"launches": 12, "busy_s": 0.25, "ok": True})
    assert reg.prometheus() == ref.prometheus()
    assert reg.to_json() == ref.to_json()


# ---------------------------------------------------------------- profile --

#: Spans a HYBRID discovery on the sparse executor records.
DISCOVERY_SPANS = {"discover.run", "strategy.prepare", "precount.point",
                   "exec.hop", "exec.host_ids", "exec.upload", "exec.root",
                   "discover.point", "discover.round", "strategy.fetch",
                   "strategy.prefetch", "mobius.negative", "mobius.blocks",
                   "exec.mobius_batch_fused", "search.score"}


def _profiled_discoveries(n):
    """``n`` HYBRID discoveries inside a CPU profiler; their searches and
    the profiled tracer's spans."""
    import repro_torch.core.search as search_mod
    made = []

    class Kept(search_mod.StructureSearch):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    db = to_port(jax_mixed_db())
    tracer = profile.profiled_tracer()
    tracer.clear()
    plain, search_mod.StructureSearch = search_mod.StructureSearch, Kept
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            for _ in range(n):
                strategy = tc.make_strategy("HYBRID", executor="sparse",
                                            device=CPU)
                tc.discover_model(db, strategy, device=CPU)
                assert not strategy.tracer.enabled      # unwired after
    finally:
        search_mod.StructureSearch = plain
    return made, tracer


def test_profiled_discovery_records_its_spans():
    searches, tracer = _profiled_discoveries(2)
    records = tracer.records()
    assert tracer.snapshot()["dropped"] == 0
    roots = [r for r in records if r.parent_id is None
             and r.name != "host.gc"]
    assert [r.name for r in roots] == ["discover.run"] * 2
    assert all(r.attrs["strategy"] == "HYBRID" and r.attrs["points"] > 0
               for r in roots)
    assert DISCOVERY_SPANS <= {r.name for r in records}
    by_id = {r.span_id: r for r in records}
    for r in records:                  # every span within its parent
        if r.parent_id is not None:
            parent = by_id[r.parent_id]
            assert parent.t0 <= r.t0 <= r.t1 <= parent.t1, (parent, r)
            assert parent.trace_id == r.trace_id
    for root, search in zip(roots, searches):
        rounds = [r for r in records if r.trace_id == root.trace_id
                  and r.name == "discover.round"]
        assert sum(r.attrs["scored"] for r in rounds) \
            == search.families_scored
    for r in records:
        if r.name == "exec.hop":
            assert r.attrs["kernel"] in ("K1", "K2") and r.attrs["edges"] > 0
        if r.name == "exec.upload":
            assert r.attrs["bytes"] > 0
        if r.name == "mobius.negative":
            assert r.attrs["families"] >= r.attrs.get("groups", 0)


def test_discovery_records_nothing_without_a_profiler():
    """Outside a profiler session, and in its warm-up step, a discovery
    leaves the profiled tracer's ring empty."""
    from torch.profiler import ProfilerActivity, schedule
    db = to_port(jax_mixed_db())
    tracer = profile.profiled_tracer()
    tracer.clear()
    strategy = tc.make_strategy("HYBRID", executor="sparse", device=CPU)
    tc.discover_model(db, strategy, device=CPU)
    assert not profile.profiling()
    assert strategy.engine.executor.tracer is NULL_TRACER
    with torch.profiler.profile(
            activities=[ProfilerActivity.CPU],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        tc.discover_model(db, tc.make_strategy("HYBRID", device=CPU),
                          device=CPU)
        prof.step()
    assert tracer.records() == [] and tracer.snapshot()["recorded"] == 0


def test_span_clock_is_the_profiler_trace_clock():
    """A CPU operator's event in the profiler's trace falls within the
    span around it (live and retroactive), within 1 ms."""
    tracer = Tracer()
    x = torch.ones(4096)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("around"):
            x.add(1)
        t0 = time.perf_counter()
        x.mul(3)
        tracer.record("after", t0, time.perf_counter())
    spans = {r.name: r for r in tracer.records()}
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    for op, name in (("aten::add", "around"), ("aten::mul", "after")):
        ev, span = events[op], spans[name]
        start = ev.start_ns() / 1e9
        end = (ev.start_ns() + ev.duration_ns()) / 1e9
        assert span.t0 - 1e-3 <= start <= end <= span.t1 + 1e-3, (op, span)


def test_gc_spans_name_collections():
    import gc
    tracer = profile.profiled_tracer()
    tracer.clear()
    before = list(gc.callbacks)
    with tracer.span("work"), profile.gc_spans(tracer):
        gc.collect()
    assert gc.callbacks == before
    gcs = [r for r in tracer.records() if r.name == "host.gc"]
    assert gcs and gcs[-1].attrs["generation"] == 2
    work = [r for r in tracer.records() if r.name == "work"][0]
    assert gcs[-1].parent_id == work.span_id
    with profile.gc_spans(Tracer()), profile.gc_spans(NULL_TRACER):
        assert gc.callbacks == before          # other tracers: no hook
    tracer.clear()


# ------------------------------------------------------------ end to end --

def _assert_trace_integrity(records):
    """Every recorded span closed, and parents precede their children."""
    by_id = {r.span_id: r for r in records}
    for r in records:
        assert r.t1 >= r.t0, r
        if r.parent_id is not None and r.parent_id in by_id:
            parent = by_id[r.parent_id]
            assert parent.trace_id == r.trace_id
            assert parent.t0 <= r.t0 + 1e-9, (parent, r)


def test_traced_service_nests_exec_under_queue():
    """Every ``service.exec`` span hangs off its query's ``service.queue``
    span (the check ``chip_smoke.py`` phase 14 makes on the card), client
    trace contexts carry across the queue, and executor dispatch spans
    nest inside the batch that caused them."""
    db = to_port(jax_mixed_db())
    lattice = tc.build_lattice(db.schema, 2)
    tracer = Tracer(capacity=1 << 14, slow_threshold_s=0.0)
    svc = CountingService(engine(db), max_batch_size=4, tracer=tracer)
    with tracer.span("client.request") as root:
        tickets = [svc.submit(p, trace_ctx=root.context) for p in lattice]
    completes = svc.complete_many([(p, None) for p in lattice[:3]])
    for t in tickets:
        t.result(timeout=JOIN_S)
    assert len(completes) == 3
    records = tracer.records()
    _assert_trace_integrity(records)
    by_id = {r.span_id: r for r in records}
    execs = [r for r in records if r.name == "service.exec"]
    assert len(execs) == len(lattice) + 3
    for r in execs:
        assert by_id[r.parent_id].name == "service.queue"
    queues = [r for r in records if r.name == "service.queue"]
    assert sum(by_id.get(q.parent_id) is not None
               and by_id[q.parent_id].name == "client.request"
               for q in queues) == len(lattice)
    names = {r.name for r in records}
    assert {"batch.dispatch", "exec.positive_batch", "cache.miss"} <= names
    assert svc.stats()["tracer"]["slow_queries"]      # threshold 0: logged


def test_traced_discovery_records_rounds_and_turns_off():
    db = to_port(jax_mixed_db())
    tracer = Tracer(capacity=1 << 15)
    svc = CountingService(engine(db), tracer=tracer)
    res = svc.discovery(max_chain_length=2).discover()
    rounds = [r for r in tracer.records() if r.name == "discover.round"]
    assert rounds
    snap = svc.stats()["discovery"]
    assert snap["rounds"] == len(rounds)
    assert snap["round_hist"]["count"] == len(rounds)
    # the rounds' count leaves out each point's first scoring pass, which
    # precedes its first round (as in the JAX package)
    assert 0 < snap["families_scored"] < res.families_scored
    svc.set_tracer(NULL_TRACER)
    tracer.clear()
    svc.count(tc.build_lattice(db.schema, 1)[0])
    assert tracer.records() == []                    # fully unwired
    for part in (svc, svc.engine, svc.engine.executor, svc.engine.cache):
        assert isinstance(part.tracer, NullTracer)
        assert not part.tracer.enabled
