"""The port's counting service, mirrored from the service tests of
``tests/test_serve.py`` and held to the JAX package's service.

* Scheduler: cache short-circuit, coalescing, the size trigger,
  backpressure, concurrent clients, complete-CT queries batched in both
  phases, the dispatcher thread's deadline, shutdown (drain or fail), and
  the metrics snapshot — each as the JAX package's test has it, on the
  port's oracle and tables.
* Admission and rate limits on one service (``tests/test_tenancy.py``'s
  single-service cases), the token bucket, ``merge_stats_dicts``.
* Fenced writes: queries racing ``apply_delta`` see a pre- or post-write
  answer, never a torn one; the asyncio surface.
* Parity: the same queries through the JAX ``CountingService`` and the
  port's give tables equal bit for bit and equal ``requests``,
  ``coalesced``, ``cache_hits`` and ``batches``.
* ONDEMAND's ``family_ct_many`` prefetches through ``Strategy.service()``
  (as the JAX package's does), with unchanged tables.
* The kernel wrappers' counters stay exact when many threads call them.

Every ``join`` and ``result`` has a timeout, so a fault fails a test
instead of hanging the run.
"""

import asyncio
import sys
import threading
import time

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.serve import CountingService as JaxService
from repro_torch.core.engine import OnDemandPositives
from repro_torch.core.oracle import oracle_ct
from repro_torch.kernels import ops
from repro_torch.serve import (CountingService, ServiceMetrics,
                               ServiceShutdown, TenantAdmissionError,
                               merge_stats_dicts)
from repro_torch.serve.service import _TokenBucket
from tests.test_mutations import fresh_pairs
from tests.test_serve import flood_db as jax_flood_db
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import keep_to_port, point_to_port, to_port

CPU = "cpu"
EXECUTORS = sorted(tc.EXECUTORS)
WAIT_S = 30.0                      # every join and result is bounded


def flood_db(**kw):
    return to_port(jax_flood_db(**kw))


def mixed_db(seed: int = 0):
    return to_port(jax_mixed_db(seed))


def engine(db, ex="sparse"):
    return tc.CountingEngine(db, ex, tc.CostStats(), device=CPU)


def lattice_of(db, length):
    return tc.build_lattice(db.schema, length)


def wait_done(ticket, seconds=5.0):
    deadline = time.perf_counter() + seconds
    while not ticket.done and time.perf_counter() < deadline:
        time.sleep(0.005)                  # NO submit, NO flush
    return ticket.done


def join_all(threads):
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a client thread hung"


def positive_oracle(db, p):
    return oracle_ct(db, p, p.all_ct_vars(db.schema, include_rind=False),
                     require_positive=True)


# ------------------------------------------------------------- scheduler ----

def test_service_cache_short_circuit_and_coalescing():
    db = flood_db()
    svc = CountingService(engine(db), max_batch_size=16)
    points = lattice_of(db, 1)
    t1 = svc.submit(points[0])
    t2 = svc.submit(points[0])          # identical in-flight -> coalesced
    svc.flush()
    np.testing.assert_array_equal(t1.result(WAIT_S).counts.numpy(),
                                  t2.result(WAIT_S).counts.numpy())
    assert svc.metrics.coalesced == 1
    t3 = svc.submit(points[0])          # now resident -> short-circuit
    assert t3.done
    assert svc.metrics.cache_hits == 1


def test_service_sink_and_client_coalesce_still_caches():
    """A client coalescing onto an in-flight sink submission (policy
    prefetch) must still get the result cached under the client key."""
    db = flood_db()
    eng = engine(db)
    svc = CountingService(eng, max_batch_size=16)
    point = lattice_of(db, 1)[0]
    absorbed = []
    svc.submit(point, None, sink=lambda p, k, tab: absorbed.append(tab))
    t = svc.submit(point, None)               # client rides the same entry
    svc.flush()
    assert len(absorbed) == 1                 # the sink got its copy
    keep = eng.plan(point, None).keep
    key = ("pos", eng.executor.name, point.atoms, keep)
    assert key in eng.cache                   # …and the client key is warm
    t2 = svc.submit(point, None)
    assert t2.done and svc.metrics.cache_hits == 1
    np.testing.assert_array_equal(t.result(WAIT_S).counts.numpy(),
                                  t2.result(WAIT_S).counts.numpy())


def test_rows_counted_shared_between_service_and_policy():
    """ct_rows accounting is per distinct artefact even when the service
    and a policy compute the same key (engine-level rows_counted set)."""
    db = flood_db()
    eng = engine(db)
    svc = CountingService(eng)
    point = lattice_of(db, 1)[0]
    keep = eng.plan(point, None).keep
    svc.count(point, keep)
    rows_after_service = eng.stats.ct_rows
    assert rows_after_service > 0
    for key in eng.cache.keys_snapshot():     # force the policy to recompute
        eng.cache.discard(key)
    assert len(eng.cache) == 0
    OnDemandPositives(eng).positive(point, keep)
    assert eng.stats.ct_rows == rows_after_service


def test_service_size_trigger_dispatches_bucket():
    db = flood_db()
    eng = engine(db)
    svc = CountingService(eng, max_batch_size=3)
    points = lattice_of(db, 1)                # 5 same-signature queries
    tickets = [svc.submit(p) for p in points]
    assert svc.metrics.size_flushes >= 1      # fired at the 3rd submit
    assert svc.pending() < len(points)
    svc.flush()
    for p, t in zip(points, tickets):
        ref = eng.executor.positive(db, eng.plan(p, None))
        np.testing.assert_array_equal(t.result(WAIT_S).counts.numpy(),
                                      ref.counts.numpy())


def test_service_backpressure_bounds_queue():
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=64, max_in_flight=2)
    for p in lattice_of(db, 2):
        svc.submit(p)
    assert svc.pending() <= 2
    assert svc.metrics.backpressure_flushes >= 1
    svc.flush()


def test_service_byte_backpressure_counts_table_bytes():
    """The byte bound prices a pending query at its table's float32 bytes
    (the port's ``engine.dtype`` is a ``torch.dtype``)."""
    db = mixed_db()
    eng = engine(db)
    points = lattice_of(db, 2)
    sizes = [eng.plan(p, None).out_shape for p in points]
    want = [int(np.prod(s)) * 4 for s in sizes]
    svc = CountingService(eng, max_pending_bytes=10 ** 9)
    assert [svc._estimate_bytes(eng.plan(p, None)) for p in points] == want
    tight = CountingService(engine(db), max_pending_bytes=min(want))
    for p in points:
        tight.submit(p)
    assert tight.metrics.backpressure_flushes >= 1
    tight.flush()


def test_service_concurrent_clients():
    """Several client threads flooding one service get correct answers."""
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=4)
    points = lattice_of(db, 2)
    ref = {p: engine(db).contract(p, None).counts.numpy() for p in points}
    errors = []

    def client(seed):
        rng = np.random.default_rng(seed)
        for _ in range(6):
            p = points[int(rng.integers(len(points)))]
            try:
                tab = svc.count(p)
                np.testing.assert_array_equal(tab.counts.numpy(), ref[p])
            except Exception as e:          # surface in the main thread
                errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(4)]
    for t in threads:
        t.start()
    join_all(threads)
    assert not errors
    snap = svc.stats()
    assert snap["requests"] == 24
    assert snap["cache"]["hits"] >= 1       # repeats served from the cache


# ------------------------------------------------- complete-CT serving ----

@pytest.mark.parametrize("ex", EXECUTORS)
def test_service_complete_many_matches_complete_ct(ex):
    """Complete-CT queries through the service (batched positive AND
    negative phases) == per-query complete_ct."""
    db = mixed_db()
    svc = CountingService(engine(db, ex), max_batch_size=16)
    lattice = lattice_of(db, 2)
    queries = [(p, None) for p in lattice]
    tabs = svc.complete_many(queries)
    ref = OnDemandPositives(engine(db, ex))
    for (p, _), tab in zip(queries, tabs):
        keep = tuple(p.all_ct_vars(db.schema, include_rind=True))
        want = tc.complete_ct(p, keep, ref)
        assert tab.vars == want.vars
        np.testing.assert_array_equal(tab.counts.numpy(),
                                      want.counts.numpy(),
                                      err_msg=f"{ex} {p}")
    snap = svc.stats()
    assert snap["complete_requests"] == len(queries)
    assert snap["requests"] == len(queries)


def test_service_complete_flood_batches_negative_phase():
    """A same-signature complete-CT flood runs ONE batched transform
    dispatch, not one per family."""
    db = flood_db()
    svc = CountingService(engine(db), max_batch_size=16)
    points = lattice_of(db, 1)                 # 5 same-shape k=1 queries
    keeps = [tuple(v for v in p.all_ct_vars(db.schema, include_rind=True)
                   if v.kind != "edge") for p in points]
    tabs = svc.complete_many(list(zip(points, keeps)))
    snap = svc.stats()
    assert snap["mobius_batches"] == 1
    assert snap["mobius_stacked"] == len(points)
    ref = OnDemandPositives(engine(db))
    for p, keep, tab in zip(points, keeps, tabs):
        want = tc.complete_ct(p, keep, ref)
        np.testing.assert_array_equal(tab.counts.numpy(),
                                      want.counts.numpy())
    # resident now: a repeat short-circuits on the family cache
    t = svc.submit_complete(points[0], keeps[0])
    assert t.done and svc.metrics.cache_hits >= 1


def test_service_complete_coalesces_and_buckets_separately():
    """Identical in-flight complete queries coalesce; complete and
    positive queries with the same point never share a bucket."""
    db = flood_db()
    svc = CountingService(engine(db), max_batch_size=16)
    point = lattice_of(db, 1)[0]
    keep = tuple(point.all_ct_vars(db.schema, include_rind=False))
    c1 = svc.submit_complete(point, keep)
    c2 = svc.submit_complete(point, keep)      # identical -> coalesced
    p1 = svc.submit(point, keep)               # same axes, positive query
    assert svc.metrics.coalesced == 1
    assert svc.pending() == 2                  # complete + positive entries
    svc.flush()
    np.testing.assert_array_equal(c1.result(WAIT_S).counts.numpy(),
                                  c2.result(WAIT_S).counts.numpy())
    # k=0 complete over attrs-only axes counts ALL groundings (the
    # indicator is summed out), not just the positive ones
    assert c1.result(WAIT_S).total() >= p1.result(WAIT_S).total()


# --------------------------------------------------- dispatcher thread ----

def test_dispatcher_fires_max_wait_without_submit():
    """max_wait_s fires with NO subsequent submit — the dispatcher thread
    drains the queue on its own."""
    db = flood_db()
    eng = engine(db)
    svc = CountingService(eng, max_batch_size=64, max_wait_s=0.05,
                          dispatcher=True)
    try:
        assert svc.running
        point = lattice_of(db, 1)[0]
        ticket = svc.submit(point)
        assert not ticket.done                 # below every other trigger
        assert wait_done(ticket), "dispatcher never fired the deadline"
        assert svc.metrics.wait_flushes >= 1
        ref = eng.executor.positive(db, eng.plan(point, None))
        np.testing.assert_array_equal(ticket.result(WAIT_S).counts.numpy(),
                                      ref.counts.numpy())
    finally:
        svc.shutdown(timeout=WAIT_S)
    assert not svc.running


def test_dispatcher_start_idempotent_and_rearms_on_submit():
    db = flood_db()
    svc = CountingService(engine(db), max_wait_s=0.02)
    try:
        svc.start()
        first = svc._dispatcher_thread
        assert svc.start() is svc              # idempotent
        assert svc._dispatcher_thread is first
        tickets = [svc.submit(p) for p in lattice_of(db, 1)[:2]]
        assert all(wait_done(t) for t in tickets)
    finally:
        svc.shutdown(timeout=WAIT_S)


def test_dispatcher_survives_failed_batch():
    """A batch that raises (e.g. a client sink throws) fails its own
    waiters but must NOT kill the dispatcher thread."""
    db = flood_db()
    svc = CountingService(engine(db), max_wait_s=0.02, dispatcher=True)
    try:
        points = lattice_of(db, 1)
        boom = svc.submit(points[0], None,
                          sink=lambda p, k, t: (_ for _ in ()).throw(
                              RuntimeError("sink boom")))
        assert wait_done(boom)
        with pytest.raises(RuntimeError, match="sink boom"):
            boom.result(timeout=1.0)
        assert svc.running                     # the dispatcher survived …
        ok = svc.submit(points[1])
        assert wait_done(ok)                   # … and still fires deadlines
    finally:
        svc.shutdown(timeout=WAIT_S)


# ------------------------------------------------------------ shutdown ----

def test_shutdown_drains_pending_waiters():
    db = flood_db()
    eng = engine(db)
    svc = CountingService(eng, max_batch_size=64, max_wait_s=10.0,
                          dispatcher=True)
    points = lattice_of(db, 1)
    tickets = [svc.submit(p) for p in points]
    assert svc.pending() == len(points)
    svc.shutdown(timeout=WAIT_S)               # drain=True executes them
    for p, t in zip(points, tickets):
        assert t.done
        ref = eng.executor.positive(db, eng.plan(p, None))
        np.testing.assert_array_equal(t.result(WAIT_S).counts.numpy(),
                                      ref.counts.numpy())


def test_shutdown_fails_pending_waiters_cleanly():
    """Shutdown with queries pending must propagate a clean error to every
    waiter — no ticket may hang."""
    db = flood_db()
    svc = CountingService(engine(db), max_batch_size=64, max_wait_s=10.0,
                          dispatcher=True)
    points = lattice_of(db, 1)
    tickets = [svc.submit(p) for p in points]
    assert svc.pending() == len(points)
    # one waiter is already parked on the raw completion event when the
    # shutdown lands — it must be signalled, not left hanging
    parked = {}

    def park(t):
        parked["signalled"] = t._entry.event.wait(5.0)

    th = threading.Thread(target=park, args=(tickets[0],))
    th.start()
    svc.shutdown(drain=False, timeout=WAIT_S)
    join_all([th])
    assert parked["signalled"]
    results = {}

    def waiter(i, t):
        try:
            results[i] = t.result(timeout=5.0)
        except BaseException as e:             # noqa: BLE001 — recording
            results[i] = e

    threads = [threading.Thread(target=waiter, args=(i, t))
               for i, t in enumerate(tickets)]
    for w in threads:
        w.start()
    join_all(threads)
    for i in range(len(tickets)):
        assert isinstance(results[i], ServiceShutdown)
    with pytest.raises(ServiceShutdown):       # and new submits are refused
        svc.submit(points[0])
    svc.shutdown()                             # idempotent
    with pytest.raises(ServiceShutdown):
        svc.start()


def test_service_metrics_snapshot_shape():
    db = flood_db()
    svc = CountingService(engine(db), metrics=ServiceMetrics())
    svc.count_many([(p, None) for p in lattice_of(db, 1)])
    snap = svc.stats()
    assert snap["batched_queries"] == 5
    assert snap["buckets"] and snap["buckets"][0]["queries"] == 5
    assert {"hits", "misses", "evictions", "dropped"} <= set(snap["cache"])
    assert snap["tenant"] == "default"
    assert snap["bucket_exec_hist"]["count"] == snap["batches"]
    assert snap["e2e_hist"]["count"] == snap["enqueued"]


def test_max_batch_size_must_be_positive():
    db = flood_db()
    with pytest.raises(ValueError):
        CountingService(engine(db), max_batch_size=0)
    with pytest.raises(ValueError):
        CountingService(engine(db), admission_policy="drop")


# ------------------------------------------------------------ admission ----

def test_token_bucket_refill_with_injected_clock():
    t = [0.0]
    b = _TokenBucket(2, 1.0, clock=lambda: t[0])
    assert b.acquire() == 0.0
    assert b.acquire() == 0.0
    wait = b.acquire()                     # drained: 0.5s until one token
    assert wait == pytest.approx(0.5)
    t[0] += wait
    assert b.acquire() == 0.0              # refilled exactly on schedule
    with pytest.raises(ValueError):
        _TokenBucket(0, 1.0)
    with pytest.raises(ValueError):
        _TokenBucket(1, 0.0)


def test_merge_stats_dicts_semantics():
    a = {"n": 1, "nested": {"x": 2.5, "deep": {"k": 1}}, "name": "a",
         "flag": True}
    b = {"n": 2, "nested": {"x": 1.5, "deep": {"k": 3}, "only_b": 1},
         "name": "b", "flag": False}
    out = merge_stats_dicts([a, b])
    assert out["n"] == 3
    assert out["nested"]["x"] == 4.0
    assert out["nested"]["deep"]["k"] == 4
    assert out["nested"]["only_b"] == 1
    assert out["name"] == "a"              # non-numeric: first wins
    assert out["flag"] is True             # bools are not counters
    assert merge_stats_dicts([]) == {}


def test_admission_shed_bounds_the_queue():
    """Over ``admission_max`` pending queries, ``"shed"`` refuses the new
    query; coalescing and cache hits cost no slot."""
    db = flood_db()
    svc = CountingService(engine(db), max_batch_size=64, admission_max=3,
                          admission_policy="shed")
    pts = lattice_of(db, 1)
    tickets = [svc.submit(p) for p in pts[:3]]
    with pytest.raises(TenantAdmissionError):
        svc.submit(pts[3])
    tickets.append(svc.submit(pts[0]))     # coalesces: free
    svc.flush()
    for t in tickets:
        assert t.result(WAIT_S) is not None
    assert svc.count(pts[1]) is not None   # cache hit: free
    st = svc.stats()
    assert st["shed"] == 1 and st["admitted"] == 3
    assert st["coalesced"] == 1 and st["cache_hits"] == 1


def test_admission_queue_policy_holds_depth_at_bound():
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=64, admission_max=2,
                          admission_policy="queue")
    pts = lattice_of(db, 2)
    tickets = []
    for p in pts:
        tickets.append(svc.submit(p))
        assert svc.pending() <= 2
    svc.flush()
    assert svc.stats()["throttled"] > 0
    for t, p in zip(tickets, pts):
        np.testing.assert_array_equal(t.result(WAIT_S).counts.numpy(),
                                      positive_oracle(db, p))


def test_rate_limit_sheds_then_queue_policy_sleeps():
    db = flood_db()
    pts = lattice_of(db, 1)
    shed = CountingService(engine(db), rate_limit=(3, 3600.0),
                           admission_policy="shed")
    for p in pts[:3]:
        shed.submit(p)
    with pytest.raises(TenantAdmissionError):
        shed.submit(pts[3])
    shed.submit(pts[0])                    # coalesces: no token burned
    shed.flush()
    st = shed.stats()
    assert st["rate_limited"] == 1 and st["shed"] == 1
    assert st["admitted"] == 3
    queue = CountingService(engine(db), rate_limit=(2, 0.25),
                            admission_policy="queue")
    t0 = time.monotonic()
    tickets = [queue.submit(p) for p in pts[:4]]
    waited = time.monotonic() - t0
    queue.flush()
    for t, p in zip(tickets, pts):
        np.testing.assert_array_equal(t.result(WAIT_S).counts.numpy(),
                                      positive_oracle(db, p))
    assert queue.stats()["rate_limited"] >= 2
    assert queue.stats()["shed"] == 0
    assert waited >= 0.1


# ------------------------------------------------------- fenced writes ----

def test_service_apply_delta_fences_and_serves_fresh():
    """Mutations through the service are atomic w.r.t. the query stream:
    concurrent clients always observe a consistent pre- or post-delta
    answer, never a torn one."""
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=4)
    lattice = lattice_of(db, 2)
    states = {}                                  # version -> oracle answers
    rng = np.random.default_rng(6)

    def snapshot_oracle():
        states[db.version] = {p: positive_oracle(db, p) for p in lattice}

    snapshot_oracle()
    errors, observations = [], []
    stop = threading.Event()

    def client(seed):
        r = np.random.default_rng(seed)
        while not stop.is_set():
            p = lattice[int(r.integers(len(lattice)))]
            try:
                observations.append((p, svc.count(p).counts.numpy()))
            except Exception as e:               # pragma: no cover
                errors.append(e)

    threads = [threading.Thread(target=client, args=(s,)) for s in range(3)]
    for t in threads:
        t.start()
    try:
        for _ in range(4):
            rel = ("R0", "R1", "R2")[int(rng.integers(3))]
            src, dst = fresh_pairs(db, rel, 2, rng)
            attrs = {a.name: rng.integers(0, a.card, size=2).astype(np.int32)
                     for a in db.relations[rel].type.attrs}
            svc.apply_delta(mutate=lambda: db.insert_facts(rel, src, dst,
                                                           attrs))
            snapshot_oracle()
    finally:
        stop.set()
        join_all(threads)
    assert not errors, errors[:2]
    assert observations
    for p, got in observations:                  # consistent pre- or
        assert any(np.array_equal(got, s[p])     # post-delta answer,
                   for s in states.values()), (p, got)  # never torn
    assert svc.stats()["deltas"] == 4
    for p in lattice:
        np.testing.assert_array_equal(svc.count(p).counts.numpy(),
                                      states[db.version][p])


def test_fenced_write_conveniences_reconcile_the_cache():
    """``insert_facts`` / ``delete_facts`` / ``update_attrs`` write and
    reconcile as one step: the warm cache then answers as a recount."""
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=8)
    lattice = lattice_of(db, 2)
    svc.count_many([(p, None) for p in lattice])
    svc.complete_many([(p, None) for p in lattice])
    rng = np.random.default_rng(8)
    src, dst = fresh_pairs(db, "R0", 2, rng)
    reports = [svc.insert_facts("R0", src, dst, {"e0": np.array(
        [0, 1], np.int32)})]
    tab = db.relations["R1"]
    reports.append(svc.delete_facts("R1", tab.src[:2].copy(),
                                    tab.dst[:2].copy()))
    reports.append(svc.update_attrs("A", np.array([1, 4], np.int32),
                                    {"a0": np.array([2, 0], np.int32)}))
    assert svc.insert_facts("R0", [], [], {"e0": []}) is None
    assert all(r is not None for r in reports)
    snap = svc.stats()
    assert snap["deltas"] == 3
    assert snap["delta_updated"] == sum(r.updated for r in reports)
    assert snap["delta_invalidated"] == sum(r.invalidated for r in reports)
    fresh = engine(db)
    ref = OnDemandPositives(fresh)
    for p in lattice:
        np.testing.assert_array_equal(svc.count(p).counts.numpy(),
                                      positive_oracle(db, p))
        keep = tuple(p.all_ct_vars(db.schema, include_rind=True))
        np.testing.assert_array_equal(
            svc.count_complete(p).counts.numpy(),
            tc.complete_ct(p, keep, ref).counts.numpy())


# ------------------------------------------------------- asyncio surface ----

def test_async_flood_matches_oracle():
    db = mixed_db()
    svc = CountingService(engine(db), max_batch_size=16, max_wait_s=0.003,
                          dispatcher=True)
    lattice = lattice_of(db, 2)
    want = {p: positive_oracle(db, p) for p in lattice}
    ref = OnDemandPositives(engine(db))
    cwant = {p: tc.complete_ct(p, p.all_ct_vars(db.schema, include_rind=True),
                               ref) for p in lattice}

    async def flood():
        pos = [svc.acount(p) for p in lattice * 8]
        com = [svc.acomplete(p) for p in lattice]
        return await asyncio.wait_for(asyncio.gather(*(pos + com)), WAIT_S)

    try:
        tabs = asyncio.run(flood())
    finally:
        svc.shutdown(timeout=WAIT_S)
    n_pos = len(lattice) * 8
    for p, t in zip(lattice * 8, tabs[:n_pos]):
        np.testing.assert_array_equal(t.counts.numpy(), want[p])
    for p, t in zip(lattice, tabs[n_pos:]):
        np.testing.assert_array_equal(t.counts.numpy(),
                                      cwant[p].counts.numpy())
    snap = svc.stats()
    assert snap["requests"] == n_pos + len(lattice)
    assert snap["enqueued"] < snap["requests"]


def test_async_without_dispatcher_falls_back():
    db = mixed_db()
    svc = CountingService(engine(db))
    p = lattice_of(db, 1)[0]

    async def one():
        return await asyncio.wait_for(svc.acount(p), WAIT_S)

    np.testing.assert_array_equal(asyncio.run(one()).counts.numpy(),
                                  positive_oracle(db, p))


# ------------------------------------------------ parity with the JAX one --

@pytest.mark.parametrize("ex", EXECUTORS)
def test_service_equals_jax_service(ex):
    """The same query stream through the JAX package's service and the
    port's: every table bit for bit, and equal request, coalescing,
    cache-hit and batch counts."""
    jdb = jax_mixed_db()
    tdb = to_port(jdb)
    jlat = jc.build_lattice(jdb.schema, 2)
    tlat = [point_to_port(p) for p in jlat]
    jsvc = JaxService(jc.CountingEngine(jdb, ex, jc.CostStats()),
                      max_batch_size=3)
    tsvc = CountingService(engine(tdb, ex), max_batch_size=3)

    def drive(svc, lat, keep_of):
        tabs = []
        tickets = [svc.submit(p) for p in lat + lat[:4]]   # coalesces
        svc.flush()
        tabs += [t.result(WAIT_S) for t in tickets]
        tabs += svc.count_many([(p, None) for p in lat])    # cache hits
        tabs += svc.complete_many([(p, None) for p in lat])
        point = lat[-1]
        keep = keep_of(point)
        tabs += svc.complete_many([(point, keep), (point, keep[:2])])
        return tabs

    jtabs = drive(jsvc, jlat, lambda p: tuple(
        p.all_ct_vars(jdb.schema, include_rind=True)))
    ttabs = drive(tsvc, tlat, lambda p: tuple(
        p.all_ct_vars(tdb.schema, include_rind=True)))
    assert len(jtabs) == len(ttabs)
    for jt, tt in zip(jtabs, ttabs):
        assert tt.vars == keep_to_port(jt.vars)
        np.testing.assert_array_equal(tt.counts.numpy(),
                                      np.asarray(jt.counts))
    js, ts = jsvc.stats(), tsvc.stats()
    for k in ("requests", "complete_requests", "coalesced", "cache_hits",
              "enqueued", "batches", "batched_queries", "mobius_stacked",
              "flushes", "size_flushes"):
        assert ts[k] == js[k], k


# ------------------------------------------------- C.2: prefetch service --

@pytest.mark.parametrize("ex", EXECUTORS)
def test_ondemand_family_ct_many_prefetches_through_the_service(ex):
    """``family_ct_many`` warms ONDEMAND's positives through
    ``Strategy.service()`` (a lazy service over the strategy's engine),
    as the JAX package's does: the service takes requests and batches,
    and the tables equal per-family ``family_ct`` and the JAX package's
    ``family_ct_many``, bit for bit."""
    jdb = jax_mixed_db()
    tdb = to_port(jdb)
    jlat = jc.build_lattice(jdb.schema, 2)
    tlat = [point_to_port(p) for p in jlat]
    rng = np.random.default_rng(7)
    pool = list(jlat[-1].all_ct_vars(jdb.schema, include_rind=True))
    keeps = [tuple(pool)]
    for _ in range(5):
        pick = rng.choice(len(pool), size=rng.integers(1, len(pool) + 1),
                          replace=False)
        keeps.append(tuple(pool[i] for i in sorted(pick)))
    js = jc.make_strategy("ONDEMAND", executor=ex)
    js.prepare(jdb, jlat)
    want = js.family_ct_many(jlat[-1], keeps)
    ref = tc.make_strategy("ONDEMAND", executor=ex, device=CPU)
    ref.prepare(tdb, tlat)
    single = [ref.family_ct(tlat[-1], keep_to_port(k)) for k in keeps]
    st = tc.make_strategy("ONDEMAND", executor=ex, device=CPU)
    st.prepare(tdb, tlat)
    assert st._service is None                 # built on first use
    got = st.family_ct_many(tlat[-1], [keep_to_port(k) for k in keeps])
    svc = st.service()
    assert svc is st.service() and svc.engine is st.engine
    snap = svc.stats()
    assert snap["requests"] > 0 and snap["batches"] > 0
    assert snap["enqueued"] == snap["requests"]  # every prefetch a miss
    assert not hasattr(st, "prefetch")
    for g, s, w in zip(got, single, want):
        np.testing.assert_array_equal(g.counts.numpy(), s.counts.numpy())
        np.testing.assert_array_equal(g.counts.numpy(), np.asarray(w.counts))
    assert snap["requests"] == js.service().stats()["requests"]


# ------------------------------------------------- counters across threads --

def test_kernel_counters_exact_across_threads():
    """Eight threads calling a wrapper at once: every plain call is
    counted, none lost to a torn read-modify-write."""
    seg = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    w = torch.ones(4, dtype=torch.float32)
    n_threads, n_iter = 8, 1500
    ops.reset_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                  # force interleavings
    try:
        def worker():
            for _ in range(n_iter):
                ops.segsum_ones(seg, w, 4)
        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for t in threads:
            t.start()
        join_all(threads)
    finally:
        sys.setswitchinterval(old)
    assert ops.PLAIN_CALLS["segsum_ones"] == n_threads * n_iter
    assert sum(ops.LAUNCHES.values()) == 0
    ops.reset_counts()
    assert ops.PLAIN_CALLS["segsum_ones"] == 0
    # the count moves under the counters' lock: while it is held, a
    # wrapper call waits for it instead of touching the count
    with ops._COUNT_LOCK:
        th = threading.Thread(target=ops.segsum_ones, args=(seg, w, 4))
        th.start()
        th.join(0.2)
        assert th.is_alive()
        assert ops.PLAIN_CALLS["segsum_ones"] == 0
    join_all([th])
    assert ops.PLAIN_CALLS["segsum_ones"] == 1
    ops.reset_counts()
