"""The port's counting router over a sharded database, mirrored from the
in-process half of ``tests/test_distributed_counting.py``, the router
tests of ``tests/test_observability.py`` and the router legs of
``tests/test_discovery.py``, and held to the JAX package's router.

* Merged answers: every routable point's table equals the single
  database's bit for bit — one query at a time, in floods, under
  concurrent clients, through the fan-out fast path (the reassembled
  view), the fused drain flush, the per-shard fallback and the overlapped
  per-ticket merge; the router's result cache, coalescing, invalidation
  and LRU trim; not-routable queries refused before any work.
* Complete tables (positive fan-out + front-end Möbius join) equal every
  strategy's on the single database, with device merges and without.
* Writes through the router (fenced across the shards), a refresh of
  router discovery, and online rebalancing (``split_shard``): untouched
  shards keep their caches, answers stay the same.
* Tracing: the span trees router submit -> shard queue -> bucket
  execution -> merge -> cache install, exact counters under a mixed
  read/write flood, and tracing turned off again.
* Discovery through the router equals local and served discovery.
* Parity: the same queries through the JAX ``CountingRouter`` and the
  port's give tables equal bit for bit and equal routing counters; the
  JAX router's discovery scoring with the port's BDeu learns the port's
  models and scores exactly.

Every ``join`` and ``result`` has a timeout, so a fault fails a test
instead of hanging the run.
"""

import dataclasses
import json
import sys
import threading

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.core.search as jsearch
import repro_torch.core as tc
import repro_torch.core.bdeu as tbdeu
from repro.serve import CountingRouter as JaxRouter
from repro_torch.discover import (DiscoveryService, RouterCounts,
                                  as_count_provider, models_signature)
from repro_torch.kernels import ops
from repro_torch.obs import (NULL_TRACER, MetricsRegistry, NullTracer,
                             Tracer, build_trees)
from repro_torch.serve import (CountingRouter, CountingService,
                               RouterMetrics, TableMerger)
from repro_torch.serve.router import NotRoutableError
from tests.test_counting_core import tiny_db as jax_tiny_db
from tests.test_mutations import fresh_pairs
from tests.test_serve import flood_db as jax_flood_db
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import point_to_port, to_port

CPU = "cpu"
WAIT_S = 60.0                      # every join and result is bounded
SCORE_TOL = 1e-3


def mixed_db(seed: int = 0):
    return to_port(jax_mixed_db(seed))


def flood_db(**kw):
    return to_port(jax_flood_db(**kw))


def router(sdb, executor="sparse", **kw):
    return CountingRouter(sdb, executor=executor, device=CPU, **kw)


def engine(db, ex="sparse"):
    return tc.CountingEngine(db, ex, tc.CostStats(), device=CPU)


def routable(sdb, lattice):
    out = []
    for p in lattice:
        try:
            sdb.route(p)
            out.append(p)
        except NotRoutableError:
            pass
    return out


def fanout_points(sdb, lattice):
    return [p for p in routable(sdb, lattice) if sdb.route(p)[0] == "fanout"]


def bad_point():
    return tc.LatticePoint((tc.Atom("R0", tc.Var("A", 1), tc.Var("B", 0)),
                            tc.Atom("R2", tc.Var("A", 0), tc.Var("C", 0))))


def join_all(threads):
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a thread hung"


def assert_equal(got, want, msg=""):
    assert got.vars == want.vars, msg
    np.testing.assert_array_equal(got.counts.numpy(), want.counts.numpy(),
                                  err_msg=str(msg))


def force_host_merge(r):
    """Disable both fused merge paths on THIS router: count_many takes the
    per-shard service submits and flush() one concurrent svc.flush() per
    shard, so answers come through the per-ticket merge."""
    r._count_many_fanout = lambda *a, **k: None
    r._fused_groups = lambda *a, **k: None


def completable(sdb, lattice):
    """Routable points whose every butterfly positive sub-query is
    routable too (what a complete table needs)."""
    out = []
    for p in routable(sdb, lattice):
        keep = tuple(p.all_ct_vars(sdb.schema, include_rind=True))
        try:
            for sp, _ in tc.positive_queries(p, keep, use_butterfly=True):
                sdb.route(sp)
        except NotRoutableError:
            continue
        out.append(p)
    return out


# ----------------------------------------------------------- merged answers --

@pytest.mark.parametrize("n_shards", [2, 3])
def test_router_merges_to_single_db_answer(n_shards):
    db = mixed_db()
    sdb = tc.shard_database(db, n_shards)
    r = router(sdb)
    eng = engine(db)
    points = routable(sdb, tc.build_lattice(db.schema, 2))
    assert points
    for point in points:
        assert_equal(r.count(point), eng.contract(point, None), point)
    snap = r.stats()
    assert snap["router"]["requests"] == len(points)
    assert snap["router"]["fanout_requests"] >= 1
    assert snap["router"]["single_shard_requests"] >= 1
    assert snap["aggregate"]["requests"] >= len(points)


def test_router_count_many_batches_per_shard():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb, "dense", max_batch_size=32)
    eng = engine(db, "dense")
    queries = [(p, None) for p in routable(
        sdb, tc.build_lattice(db.schema, 2))] * 3   # repeats coalesce/hit
    for (p, _), tab in zip(queries, r.count_many(queries)):
        assert_equal(tab, eng.contract(p, None), p)
    agg, rt = r.stats()["aggregate"], r.stats()["router"]
    assert agg["batched_queries"] >= 1
    assert (rt["cache_hits"] + rt["coalesced"]
            + agg["cache"]["hits"] + agg["coalesced"]) >= 1


def test_router_mixed_flood_concurrent_clients():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb, max_batch_size=4, metrics=RouterMetrics())
    points = routable(sdb, tc.build_lattice(db.schema, 2))
    eng = engine(db)
    ref = {p: eng.contract(p, None) for p in points}
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(6):
            p = points[int(rng.integers(len(points)))]
            try:
                assert_equal(r.submit(p).result(WAIT_S), ref[p], p)
            except Exception as e:          # surface in the main thread
                errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    join_all(threads)
    assert not errors, errors
    snap = r.stats()
    assert snap["router"]["requests"] == 24
    assert snap["router"]["merged_tables"] >= 1
    assert len(snap["shards"]) == 2


def test_router_count_many_prevalidates_mixed_list():
    db = mixed_db()
    r = router(tc.shard_database(db, 2, root_etype="A"))
    good = tc.build_lattice(db.schema, 1)[0]
    with pytest.raises(NotRoutableError):
        r.count_many([(good, None), (bad_point(), None)])
    assert r.pending() == 0
    assert r.stats()["aggregate"]["enqueued"] == 0


def test_router_result_cache_and_coalescing():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb)
    fanout = fanout_points(sdb, tc.build_lattice(db.schema, 2))[0]
    t1 = r.submit(fanout)
    t2 = r.submit(fanout)
    assert t2 is t1                                 # coalesced
    r.flush()
    tab1 = t1.result(WAIT_S)
    np.testing.assert_array_equal(t2.result(WAIT_S).counts.numpy(),
                                  tab1.counts.numpy())
    rt = r.stats()["router"]
    assert rt["coalesced"] == 1
    assert rt["merged_tables"] == 2                 # merged exactly once
    before = r.stats()["aggregate"]["requests"]
    t3 = r.submit(fanout)
    assert t3.done
    np.testing.assert_array_equal(t3.result(WAIT_S).counts.numpy(),
                                  tab1.counts.numpy())
    snap = r.stats()
    assert snap["router"]["cache_hits"] == 1
    assert snap["aggregate"]["requests"] == before  # no shard touched
    assert snap["router"]["merged_tables"] == 2


def test_router_cache_disabled_and_lru_trim():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    points = routable(sdb, tc.build_lattice(db.schema, 2))
    off = router(sdb, cache_entries=0)
    off.count(points[0])
    off.count(points[0])
    assert off.stats()["router"]["cache_hits"] == 0
    tiny = router(sdb, cache_entries=1)
    tiny.count(points[0])
    tiny.count(points[1])                           # evicts points[0]
    assert len(tiny._results) == 1
    tiny.count(points[0])                           # miss -> recompute
    assert tiny.stats()["router"]["cache_hits"] == 0
    small = router(sdb, cache_result_bytes=1)       # every table too big
    small.count(points[0])
    assert len(small._results) == 0


def test_router_invalidate_keeps_stale_results_out():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb)
    p = routable(sdb, tc.build_lattice(db.schema, 2))[0]
    t = r.submit(p)
    r.invalidate()                        # data "refreshed" mid-flight
    assert t.result(WAIT_S) is not None   # waiters settle fine …
    assert len(r._results) == 0           # … but stale data is not cached
    r.count(p)
    assert len(r._results) == 1


def test_router_metrics_rollup_counts_not_routable():
    r = router(tc.shard_database(mixed_db(), 2, root_etype="A"))
    with pytest.raises(NotRoutableError):
        r.submit(bad_point())
    snap = r.stats()["router"]
    assert snap["not_routable"] == 1 and snap["requests"] == 1


# ------------------------------------------------- device merges and fusion --

@pytest.mark.parametrize("sname", ["HYBRID", "ONDEMAND", "PRECOUNT",
                                   "TUPLEID"])
def test_merge_parity_device_host_single_db_per_strategy(sname):
    """Device merge == host merge == the single-database strategy's
    complete family tables, bit for bit."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    sdb = tc.shard_database(db, 2)
    st = tc.make_strategy(sname, executor="sparse", device=CPU)
    st.prepare(db, lattice)
    queries = [(p, tuple(p.all_ct_vars(db.schema, include_rind=True)))
               for p in completable(sdb, lattice)]
    assert queries
    want = [st.family_ct(p, k) for p, k in queries]
    dev, host = router(sdb), router(sdb)
    force_host_merge(host)
    for r in (dev, host):
        for (p, _), tab, ref in zip(queries, r.complete_many(queries),
                                    want):
            assert_equal(tab, ref, f"{sname} {p}")
    assert dev.stats()["router"]["device_merges"] >= 1
    assert host.stats()["router"]["fused_dispatches"] == 0
    assert host.stats()["router"]["merged_tables"] >= 1


def test_count_many_fanout_fast_path_bypasses_services():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb)
    eng = engine(db)
    points = fanout_points(sdb, tc.build_lattice(db.schema, 2))
    assert len(points) >= 2
    queries = [(p, None) for p in points]
    for (p, _), tab in zip(queries, r.count_many(queries)):
        assert_equal(tab, eng.contract(p, None), p)
    rt, agg = r.stats()["router"], r.stats()["aggregate"]
    assert rt["fused_dispatches"] >= 1
    assert rt["device_merges"] >= 1
    assert rt["fanout_requests"] == len(points)
    assert rt["merged_tables"] == len(points) * 2
    assert agg["enqueued"] == 0                     # services bypassed
    r.invalidate()
    before = r.stats()["router"]["fused_dispatches"]
    dup = r.count_many(queries + queries)
    np.testing.assert_array_equal(dup[0].counts.numpy(),
                                  dup[len(points)].counts.numpy())
    rt = r.stats()["router"]
    assert rt["coalesced"] >= len(points)
    assert rt["fused_dispatches"] >= before + 1
    before = rt["fused_dispatches"]
    r.count_many(queries)
    rt = r.stats()["router"]
    assert rt["cache_hits"] >= len(points)
    assert rt["fused_dispatches"] == before         # nothing re-evaluated
    assert r.submit(points[0]).done


def test_fused_flush_serves_submitted_tickets():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb, max_batch_size=64)
    eng = engine(db)
    points = fanout_points(sdb, tc.build_lattice(db.schema, 2))
    tickets = [r.submit(p) for p in points]
    r.flush()
    for p, t in zip(points, tickets):
        assert_equal(t.result(WAIT_S), eng.contract(p, None), p)
    snap = r.stats()
    assert snap["router"]["fused_dispatches"] >= 1
    assert snap["aggregate"]["batches"] >= 2
    assert snap["aggregate"]["batched_queries"] >= 2 * len(points)
    assert snap["aggregate"]["cache"]["entries"] >= 1
    # the shard caches hold each shard's own partial table
    for p in points:
        for e in r.engines:
            key = ("pos", e.executor.name, p.atoms, e.plan(p, None).keep)
            assert_equal(e.cache.peek(key), e.contract(p, None), p)


def test_fused_flush_launches_once_per_hop_step_for_all_shards():
    """The fused flush evaluates every shard's plans as one group: as many
    K1/K2 calls as one shard's evaluation of the same plans."""
    db = flood_db()
    sdb = tc.shard_database(db, 3)
    plans_points = fanout_points(sdb, tc.build_lattice(db.schema, 1))
    r = router(sdb, max_batch_size=64)
    one = engine(sdb.shards[0])
    ops.reset_counts()
    one.executor.positive_batch(one.db, [one.plan(p, None)
                                         for p in plans_points])
    alone = dict(ops.PLAIN_CALLS)
    ops.reset_counts()
    tickets = [r.submit(p) for p in plans_points]
    r.flush()
    for t in tickets:
        t.result(WAIT_S)
    assert r.stats()["router"]["fused_dispatches"] >= 1
    for k in ("segsum_ones", "segsum_rows"):
        assert ops.PLAIN_CALLS[k] == alone[k], k


def test_fused_flush_falls_back_on_misaligned_queues():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb, max_batch_size=64)
    eng = engine(db)
    points = fanout_points(sdb, tc.build_lattice(db.schema, 2))
    services = r._snapshot()[1]
    t_router = r.submit(points[0])
    t_direct = services[0].submit(points[1])   # shard 0's queue is longer
    r.flush()
    assert_equal(t_router.result(WAIT_S), eng.contract(points[0], None))
    assert_equal(t_direct.result(WAIT_S),
                 r.engines[0].contract(points[1], None))
    assert r.stats()["router"]["fused_dispatches"] == 0


def test_partial_overlapped_merge_under_staggered_shards():
    db = mixed_db()
    sdb = tc.shard_database(db, 3)
    r = router(sdb, max_batch_size=64)
    force_host_merge(r)
    eng = engine(db)
    p = fanout_points(sdb, tc.build_lattice(db.schema, 2))[0]
    t = r.submit(p)
    services = r._snapshot()[1]
    services[0].flush()                      # two shards settle early …
    services[1].flush()
    tab = t.result(WAIT_S)                   # … the third flushes in wait
    assert_equal(tab, eng.contract(p, None))
    rt = r.stats()["router"]
    assert rt["partial_merges"] >= 1
    assert rt["merged_tables"] == 3
    key = (p.atoms, r.engines[0].plan(p, None).keep)
    assert r._results[key] is tab            # cached zero-copy


def test_table_merger_sums_by_shape():
    db = mixed_db()
    sdb = tc.shard_database(db, 3)
    points = fanout_points(sdb, tc.build_lattice(db.schema, 2))
    engines = [engine(s) for s in sdb.shards]
    per_query = [[e.contract(p, None) for e in engines] for p in points]
    merged, dispatches = TableMerger().merge_tables(per_query)
    assert dispatches == len({t[0].counts.shape for t in per_query})
    for p, tab in zip(points, merged):
        assert_equal(tab, engine(db).contract(p, None), p)
    assert TableMerger().reduce_arrays([per_query[0][0].counts]) \
        is per_query[0][0].counts


def test_fanout_fast_path_concurrent_with_deltas():
    """The fan-out fast path linearizes against apply_delta: every flood
    answer equals the single database at SOME insert prefix."""
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb)
    points = [p for p in fanout_points(sdb, tc.build_lattice(db.schema, 2))
              if any(a.rel == "R1" for a in p.atoms)][:3]
    assert points
    present = set(zip(db.relations["R1"].src.tolist(),
                      db.relations["R1"].dst.tolist()))
    inserts = [(s, d) for s in range(7) for d in range(6)
               if (s, d) not in present][:2]
    prefixes = []
    for i in range(len(inserts) + 1):
        ref_db = mixed_db()
        for s, d in inserts[:i]:
            ref_db.insert_facts("R1", [s], [d], None)
        eng = engine(ref_db)
        prefixes.append({p: eng.contract(p, None).counts.numpy()
                         for p in points})
    errors = []

    def flood():
        try:
            for _ in range(4):
                r.invalidate()
                tabs = r.count_many([(p, None) for p in points])
                got = {p: t.counts.numpy() for p, t in zip(points, tabs)}
                assert any(all(np.array_equal(got[p], pref[p])
                               for p in points) for pref in prefixes), \
                    "a flood observed a torn (mixed-delta) answer"
        except Exception as e:                   # pragma: no cover
            errors.append(e)

    def writer():
        try:
            for s, d in inserts:
                r.apply_delta("R1", [s], [d], None)
        except Exception as e:                   # pragma: no cover
            errors.append(e)

    ts = [threading.Thread(target=flood), threading.Thread(target=writer)]
    for t in ts:
        t.start()
    join_all(ts)
    assert not errors, errors


def test_failed_shard_batch_settles_tickets_with_the_error():
    """A shard whose batch raises settles every ticket waiting on it with
    that error: no waiter hangs, the in-flight slot is released, and the
    next submit retries."""
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    r = router(sdb)
    force_host_merge(r)
    p = fanout_points(sdb, tc.build_lattice(db.schema, 2))[0]
    ex = r.engines[1].executor

    def broken(*a, **k):
        raise RuntimeError("shard 1 lost its device")

    ex.positive_batch = broken
    t = r.submit(p)
    with pytest.raises(RuntimeError, match="shard 1"):
        t.result(WAIT_S)
    assert not r._inflight
    del ex.positive_batch
    assert_equal(r.count(p), engine(db).contract(p, None))


def test_router_needs_a_card_unless_asked_for_the_cpu():
    sdb = tc.shard_database(mixed_db(), 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            CountingRouter(sdb, executor="sparse")
    # the mesh-sharded executor: one instance a shard (one rank here)
    rs = CountingRouter(sdb, executor="sparse_sharded", device=CPU)
    try:
        assert {type(e.executor) for e in rs.engines} == \
            {tc.ShardedSparseExecutor}
        assert len({id(e.executor) for e in rs.engines}) == len(rs.engines)
        p = tc.build_lattice(sdb.shards[0].schema, 1)[0]
        assert_equal(rs.count(p), router(sdb).count(p))
    finally:
        rs.shutdown(timeout=60)
    r = router(sdb)
    assert {e.device.type for e in r.engines} == {"cpu"}


# ------------------------------------------------------ writes and rebalance --

def test_router_writes_reconcile_only_owning_shards():
    """A partitioned insert reaches only the shards that own its edges
    (the others' reports are ``None`` and their caches untouched); a
    replicated insert reaches every shard; answers equal the written
    single database."""
    jdb = jax_mixed_db()
    db, ref = to_port(jdb), to_port(jdb)
    sdb = tc.shard_database(db, 3, root_etype="A")
    r = router(sdb)
    lattice = tc.build_lattice(db.schema, 2)
    points = routable(sdb, lattice)
    r.count_many([(p, None) for p in points])
    rng = np.random.default_rng(4)
    src, dst = fresh_pairs(ref, "R0", 1, rng)
    attrs = {"e0": np.array([1], np.int32)}
    owner = int(sdb.shard_of_ids(src)[0])
    sizes = [len(e.cache) for e in r.engines]
    reports = r.insert_facts("R0", src, dst, attrs)
    ref.insert_facts("R0", src, dst, attrs)
    assert [rep is None for rep in reports] == [s != owner
                                                for s in range(3)]
    for s, e in enumerate(r.engines):
        if s != owner:
            assert len(e.cache) == sizes[s]
    src2, dst2 = fresh_pairs(ref, "R1", 2, rng)
    reports = r.insert_facts("R1", src2, dst2, None)
    ref.insert_facts("R1", src2, dst2, None)
    assert all(rep is not None for rep in reports)
    eng = engine(ref)
    for p, tab in zip(points, r.count_many([(p, None) for p in points])):
        assert_equal(tab, eng.contract(p, None), p)
    assert r.stats()["router"]["deltas"] == 2


def test_rebalance_keeps_untouched_shards_and_answers():
    db = mixed_db()
    sdb = tc.shard_database(db, 3)
    r = router(sdb)
    lattice = tc.build_lattice(db.schema, 2)
    queries = [(p, tuple(p.all_ct_vars(db.schema, include_rind=True)))
               for p in completable(sdb, lattice)]
    before = r.complete_many(queries)
    hot = max(range(3), key=sdb.partitioned_rows)
    kept = {s: (r.engines[s], r.engines[s].cache.keys_snapshot())
            for s in range(3) if s != hot}
    assert all(keys for _, keys in kept.values())
    new = r.rebalance(hot)
    assert new == 3 and r.n_shards == 4
    for s, (eng, keys) in kept.items():
        assert r.engines[s] is eng                  # same stack, same cache
        assert eng.cache.keys_snapshot() == keys
    after = r.complete_many(queries)
    for (p, _), a, b in zip(queries, after, before):
        assert_equal(a, b, p)
    assert r.stats()["router"]["rebalances"] == 1
    st = tc.make_strategy("HYBRID", executor="sparse", device=CPU)
    st.prepare(db, lattice)
    for (p, k), a in zip(queries, after):
        assert_equal(a, st.family_ct(p, k), p)
    db2 = mixed_db()
    r2 = router(tc.shard_database(db2, 2), rebalance_rows=10)
    rng = np.random.default_rng(9)
    src, dst = fresh_pairs(db2, "R0", 3, rng)
    r2.insert_facts("R0", src, dst, {"e0": np.zeros(3, np.int32)})
    assert r2.n_shards > 2                          # split on write


# ------------------------------------------------------------------ tracing --

def test_router_metrics_snapshot_covers_every_field():
    snap = RouterMetrics().snapshot()
    for f in dataclasses.fields(RouterMetrics):
        if not f.name.startswith("_"):
            assert f.name in snap, f.name
    assert snap["merge_hist"]["p99_s"] == 0.0


def test_router_metrics_merge_and_e2e_histograms():
    m = RouterMetrics()
    m.observe_merge(0.002)
    m.observe_e2e(0.004)
    snap = m.snapshot()
    assert snap["merge_hist"]["count"] == 1
    assert snap["e2e_hist"]["count"] == 1
    assert snap["e2e_hist"]["max_s"] == pytest.approx(0.004)


def _assert_trace_integrity(records):
    by_id = {r.span_id: r for r in records}
    for r in records:
        assert r.t1 >= r.t0, r
        if r.parent_id is not None and r.parent_id in by_id:
            parent = by_id[r.parent_id]
            assert parent.trace_id == r.trace_id
            assert parent.t0 <= r.t0 + 1e-9, (parent, r)


def test_traced_sharded_flood_reconstructs_span_trees():
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    tracer = Tracer(capacity=1 << 14, slow_threshold_s=0.0)
    r = router(sdb, max_batch_size=8, tracer=tracer)
    points = routable(sdb, tc.build_lattice(db.schema, 2))
    tickets = [r.submit(p) for p in points]
    for t in tickets:
        t.result(WAIT_S)
    records = tracer.records()
    _assert_trace_integrity(records)
    assert {"router.submit", "service.queue", "service.exec",
            "router.merge", "router.cache_install"} <= {
        rec.name for rec in records}
    roots = [n for t in build_trees(records) for n in t["roots"]
             if n["name"] == "router.submit"
             and n["attrs"].get("mode") == "fanout"]
    assert roots
    for root in roots:
        kids = {c["name"] for c in root["children"]}
        assert {"service.queue", "router.merge",
                "router.cache_install"} <= kids, kids
        queues = [c for c in root["children"]
                  if c["name"] == "service.queue"]
        assert len(queues) == 2                      # one per shard
        assert any(g["name"] == "service.exec"
                   for q in queues for g in q["children"])
        merge = next(c for c in root["children"]
                     if c["name"] == "router.merge")
        assert merge["attrs"]["straggler_shard"] in (0, 1)
        assert merge["attrs"]["path"] == "overlapped"
    snap = r.stats()
    assert snap["router"]["e2e_hist"]["count"] >= len(roots)
    assert snap["router"]["merge_hist"]["count"] >= 1
    assert snap["aggregate"]["queue_wait_hist"]["count"] >= 1
    assert snap["aggregate"]["bucket_exec_hist"]["count"] >= 1
    assert snap["tracer"]["slow_queries"]
    r.count(points[0])
    assert any(rec.name == "router.submit"
               and (rec.attrs or {}).get("mode") == "cache_hit"
               for rec in tracer.records())
    reg = MetricsRegistry()
    reg.register("router", r.stats)
    text = reg.prometheus()
    assert "repro_router_router_e2e_hist_p99_s" in text
    assert "repro_router_aggregate_queue_wait_hist_p50_s" in text
    assert "repro_router_tracer_recorded" in text
    assert json.loads(reg.to_json())["router"]["router"]["requests"] == \
        len(points) + 1


def test_traced_mixed_read_write_flood_counters_exact():
    db, ref_db = mixed_db(), mixed_db()
    sdb = tc.shard_database(db, 2)
    tracer = Tracer(capacity=1 << 15)
    r = router(sdb, max_batch_size=4, tracer=tracer)
    points = routable(sdb, tc.build_lattice(db.schema, 2))
    n_readers, n_reads, n_writes = 4, 6, 3
    errors = []

    def reader(seed):
        rng = np.random.default_rng(seed)
        for _ in range(n_reads):
            try:
                r.submit(points[int(rng.integers(len(points)))]).result(
                    WAIT_S)
            except Exception as e:                   # pragma: no cover
                errors.append(e)

    def writer():
        rng = np.random.default_rng(99)
        for _ in range(n_writes):
            rel = sorted(db.relations)[int(rng.integers(3))]
            src, dst = fresh_pairs(ref_db, rel, 1, rng)
            attrs = {a.name: rng.integers(0, a.card, size=1).astype(np.int32)
                     for a in ref_db.relations[rel].type.attrs}
            try:
                r.insert_facts(rel, src, dst, attrs)
                ref_db.insert_facts(rel, src, dst, attrs)
            except Exception as e:                   # pragma: no cover
                errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=reader, args=(s,))
                   for s in range(n_readers)]
        threads.append(threading.Thread(target=writer))
        for t in threads:
            t.start()
        join_all(threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    snap = r.stats()
    assert snap["router"]["requests"] == n_readers * n_reads
    assert snap["router"]["deltas"] == n_writes
    _assert_trace_integrity(tracer.records())
    names = {rec.name for rec in tracer.records()}
    assert "engine.apply_delta" in names and "router.submit" in names
    eng = engine(ref_db)
    for p in points:
        assert_equal(r.count(p), eng.contract(p, None), p)


def test_count_many_fanout_fast_path_is_traced():
    db = flood_db(n_rels=3, edges=16)
    sdb = tc.shard_database(db, 2)
    tracer = Tracer(capacity=4096)
    r = router(sdb, tracer=tracer)
    points = fanout_points(sdb, tc.build_lattice(db.schema, 1))
    assert points
    r.count_many([(p, None) for p in points])
    assert r.stats()["router"]["fused_dispatches"] >= 1
    records = tracer.records()
    _assert_trace_integrity(records)
    roots = [n for t in build_trees(records) for n in t["roots"]
             if n["attrs"].get("mode") == "fanout_fused"]
    assert roots and all(
        any(c["name"] == "router.merge"
            and c["attrs"]["path"] == "fanout_fused"
            for c in n["children"]) for n in roots)


def test_tracing_can_be_turned_off_again():
    db = flood_db(n_rels=2, edges=8)
    sdb = tc.shard_database(db, 2)
    tracer = Tracer(capacity=256)
    r = router(sdb, tracer=tracer)
    points = routable(sdb, tc.build_lattice(db.schema, 1))
    r.count(points[0])
    assert tracer.records()
    r.set_tracer(NULL_TRACER)
    tracer.clear()
    r.count(points[-1])
    assert tracer.records() == []
    for svc in r.services:
        assert isinstance(svc.tracer, NullTracer)
        assert not svc.tracer.enabled


# --------------------------------------------------------------- discovery --

def _oracle(db):
    models, _ = tc.discover_model(
        db, tc.make_strategy("ONDEMAND", device=CPU), max_chain_length=2,
        device=CPU)
    return models_signature(models), sum(m.score for m in models.values())


def test_sharded_router_discovery_matches_oracle():
    db = to_port(jax_tiny_db(0))
    sig, score = _oracle(db)
    r = router(tc.shard_database(to_port(jax_tiny_db(0)), 2))
    res = r.discovery().discover()
    assert res.signature() == sig
    assert res.score == pytest.approx(score, abs=SCORE_TOL)
    assert r.discovery() is r.discovery()
    assert r.stats()["discovery"]["discoveries"] == 1
    provider = as_count_provider(r)
    assert isinstance(provider, RouterCounts)
    assert provider.version() == ("shards", 0, 0)


def test_all_backends_agree_exactly():
    results = {
        "local": DiscoveryService(tc.make_strategy("HYBRID", device=CPU),
                                  db=to_port(jax_tiny_db(1))).discover(),
        "served": DiscoveryService(CountingService(engine(
            to_port(jax_tiny_db(1))))).discover(),
        "sharded": DiscoveryService(router(tc.shard_database(
            to_port(jax_tiny_db(1)), 2))).discover(),
    }
    sigs = {k: v.signature() for k, v in results.items()}
    assert sigs["local"] == sigs["served"] == sigs["sharded"]
    scores = [v.score for v in results.values()]
    assert max(scores) - min(scores) < SCORE_TOL


def test_router_refresh_matches_a_fresh_router():
    """A write through the router, then ``refresh``: the models of a
    fresh router discovery on the written store, some families kept."""
    jdb = jax_tiny_db(2)
    db = to_port(jdb)
    r = router(tc.shard_database(db, 2))
    d = r.discovery()
    d.discover()
    rng = np.random.default_rng(7)
    src, dst = fresh_pairs(db, "Reg", 3, rng)
    grade = rng.integers(0, 2, size=3).astype(np.int32)
    r.insert_facts("Reg", src, dst, {"grade": grade})
    rep = d.refresh("Reg")
    fresh_db = to_port(jdb)
    fresh_db.insert_facts("Reg", src, dst, {"grade": grade})
    fresh = router(tc.shard_database(fresh_db, 2)).discovery().discover()
    assert rep.result.signature() == fresh.signature()
    assert rep.result.score == fresh.score
    assert rep.retained > 0 and rep.rescored < rep.total_families


# ----------------------------------------------------- the two packages ----

def _port_scorer(stack, ess=1.0):
    return tbdeu.bdeu_score_batch(torch.from_numpy(np.array(stack)),
                                  ess).numpy()


ROUTER_COUNTERS = ("requests", "fanout_requests", "single_shard_requests",
                   "merged_tables", "not_routable", "cache_hits",
                   "coalesced", "complete_requests")


@pytest.mark.parametrize("name,n", [("tiny", 2), ("mixed", 3),
                                    ("UW", 2)])
def test_router_tables_equal_jax(name, n):
    """The same floods through the JAX router and the port's: every
    positive and complete table bit for bit, and equal routing counters."""
    if name == "tiny":
        jdb = jax_tiny_db(0)
    elif name == "mixed":
        jdb = jax_mixed_db(1)
    else:
        jdb = jc.paper_benchmark_db(name, seed=0, scale=0.1)
    jsdb = jc.shard_database(jdb, n)
    tsdb = tc.shard_database(to_port(jdb), n)
    jr, tr = JaxRouter(jsdb, executor="sparse"), router(tsdb)
    lattice = [p for p in jc.build_lattice(jdb.schema, 2)
               if _jax_routable(jsdb, p)]
    pos = [(p, None) for p in lattice]
    jt = jr.count_many(pos)
    tt = tr.count_many([(point_to_port(p), None) for p in lattice])
    for p, j, t in zip(lattice, jt, tt):
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts),
                                      err_msg=str(p))
    comp = [p for p in lattice if _jax_completable(jsdb, p)]
    jq = [(p, tuple(p.all_ct_vars(jdb.schema, include_rind=True)))
          for p in comp]
    tq = [(point_to_port(p), tuple(point_to_port(p).all_ct_vars(
        tsdb.schema, include_rind=True))) for p in comp]
    for p, j, t in zip(comp, jr.complete_many(jq), tr.complete_many(tq)):
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts),
                                      err_msg=str(p))
    js, ts = jr.stats()["router"], tr.stats()["router"]
    for k in ROUTER_COUNTERS:
        assert ts[k] == js[k], k


def _jax_routable(jsdb, p):
    try:
        jsdb.route(p)
        return True
    except jc.NotRoutableError:
        return False


def _jax_completable(jsdb, p):
    from repro.core.mobius import positive_queries
    keep = tuple(p.all_ct_vars(jsdb.schema, include_rind=True))
    return all(_jax_routable(jsdb, sp)
               for sp, _ in positive_queries(p, keep, use_butterfly=True))


def test_router_discovery_equals_jax(monkeypatch):
    """The JAX router's discovery, scoring with the port's BDeu (the two
    packages' float32 BDeu bits part at near ties; ROADMAP C), learns the
    port's router's models and scores exactly, with equal routing and
    discovery counters."""
    monkeypatch.setattr(jsearch, "bdeu_score_batch", _port_scorer)
    jdb = jax_tiny_db(2)
    jr = JaxRouter(jc.shard_database(jdb, 2), executor="sparse")
    tr = router(tc.shard_database(to_port(jdb), 2))
    jres = jr.discovery().discover()
    tres = tr.discovery().discover()
    assert tres.signature() == jres.signature()
    assert tres.score == jres.score
    assert tres.families_scored == jres.families_scored
    js, ts = jr.stats(), tr.stats()
    for k in ROUTER_COUNTERS:
        assert ts["router"][k] == js["router"][k], k
    for k in ("discoveries", "restarts", "rounds", "families_scored"):
        assert ts["discovery"][k] == js["discovery"][k], k
