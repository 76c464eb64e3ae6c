"""The port's multi-tenant registry, mirrored from ``tests/test_tenancy.py``
(its 14 tests) and held to the JAX package's registry.

* Cache: a flooding tenant can spend the shared budget's slack but never
  evict a neighbour below its reserved floor; a tenant over its cap
  evicts its own entries, not a neighbour's.
* Admission and rate limits per tenant (shed and queue policies), the
  token bucket.
* Counts: a tenant's positive and complete tables, and its discovery, are
  bit-identical with and without a neighbour's flood and writes.
* Dispatch: cross-tenant ``count_many`` equals per-tenant serial
  execution bit for bit, with fewer K1/K2 calls than the tenants one
  after another (same-shape plans of different tenants share one
  evaluation); a sharded tenant is served by its router.
* Stats: per-tenant and aggregate snapshots cover every
  ``ServiceMetrics`` field; the default-tenant shim is unchanged.
* Parity: the same fleet and flood through the JAX ``TenantRegistry`` and
  the port's give equal tables and per-tenant counters.

Every ``result`` is bounded, so a fault fails a test instead of hanging.
"""

import dataclasses
import time

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.serve import TenantRegistry as JaxRegistry
from repro_torch.core.strategies import STRATEGIES
from repro_torch.kernels import ops
from repro_torch.serve import (CountingService, ServiceMetrics,
                               ServiceShutdown, TenantAdmissionError,
                               TenantRegistry, merge_stats_dicts)
from tests.test_tenancy import fleet_db as jax_fleet_db
from tests.test_tenancy import fleet_schema as jax_fleet_schema
from tests.test_torch_data import point_to_port, to_port

CPU = "cpu"
WAIT_S = 60.0


def fleet_db(seed, n_rels=5, edges: int = 24):
    return to_port(jax_fleet_db(jax_fleet_schema(n_rels), seed, edges))


def points(schema, max_len: int = 2):
    return [p for p in tc.build_lattice(schema, max_len) if p.atoms]


def fresh_edges(db, rel, n: int = 2):
    """``n`` (src, dst, attrs) edges NOT yet present in ``db``'s rel."""
    tab = db.relations[rel]
    have = tab.pair_set()
    pairs = [(s, d)
             for s in range(db.entities[tab.type.src].size)
             for d in range(db.entities[tab.type.dst].size)
             if (s, d) not in have][:n]
    assert len(pairs) == n
    src = np.array([p[0] for p in pairs])
    dst = np.array([p[1] for p in pairs])
    attrs = {a.name: np.arange(n) % a.card for a in tab.type.attrs}
    return src, dst, attrs


def make_registry(tenants, n_rels=5, executor="dense", **tenant_kw):
    """One registry, one db per (tenant_id, seed) pair, one schema."""
    reg = TenantRegistry(executor=executor, device=CPU)
    for tid, seed in tenants:
        reg.add_tenant(tid, fleet_db(seed, n_rels), **tenant_kw.get(tid, {}))
    return reg


def assert_equal(got, want):
    assert got.vars == want.vars
    np.testing.assert_array_equal(got.counts.numpy(), want.counts.numpy())


def kernel_calls():
    return sum(ops.PLAIN_CALLS[k] for k in ("segsum_ones", "segsum_rows"))


# ------------------------------------------------------- fused dispatch --

@pytest.mark.parametrize("executor", ["dense", "sparse"])
def test_cross_tenant_batched_equals_per_tenant_serial(executor):
    tenants = [("a", 0), ("b", 1), ("c", 2)]
    reg = make_registry(tenants, executor=executor)
    pts = points(reg.tenant("a").db.schema)
    queries = [(tid, p, None) for tid, _ in tenants for p in pts]
    ops.reset_counts()
    tabs = reg.count_many(queries)
    fused = kernel_calls()
    serial = 0
    for i, (tid, seed) in enumerate(tenants):
        svc = make_registry([(tid, seed)], executor=executor) \
            .tenant(tid).service
        ops.reset_counts()
        refs = svc.count_many([(p, None) for p in pts])
        serial += kernel_calls()
        for j, ref in enumerate(refs):
            assert_equal(tabs[i * len(pts) + j], ref)
    # same-shape plans of different tenants shared their evaluations
    assert 0 < fused < serial
    st = reg.stats()
    assert st["aggregate"]["batches"] >= 1
    for tid, _ in tenants:
        assert st["tenants"][tid]["batched_queries"] == len(pts)


@pytest.mark.parametrize("strat", sorted(STRATEGIES))
def test_complete_parity_vs_strategy_oracle_under_flood(strat):
    """B's complete tables through the registry equal the bare strategy's
    bit for bit, even while tenant A floods the shared pool."""
    db_b = fleet_db(7, 3)
    pts = points(db_b.schema)
    oracle = tc.make_strategy(strat, device=CPU)
    oracle.prepare(db_b, pts)
    reg = TenantRegistry(executor="dense", device=CPU)
    reg.add_tenant("a", fleet_db(3, 3))
    reg.add_tenant("b", fleet_db(7, 3))
    reg.count_many([("a", p, None) for p in pts] * 2)
    for p in pts:
        keep = p.all_ct_vars(db_b.schema, include_rind=True)
        assert_equal(reg.count_complete("b", p, keep),
                     oracle.family_ct(p, keep))


# ------------------------------------------------------- cache isolation --

def test_flood_cannot_evict_neighbour_below_reserved_floor():
    reg = make_registry([("a", 0), ("b", 1)])
    pts = points(reg.tenant("a").db.schema)
    for p in pts:
        reg.count("b", p)
    b_warm = reg.cache.tenants_info()["b"]["nbytes"]
    assert b_warm > 0
    reg.set_tenant_budget("b", reserved_bytes=b_warm)
    reg.cache.budget_bytes = b_warm + b_warm // 2
    for _ in range(3):
        reg.count_many([("a", p, None) for p in pts])
        reg.tenant("a").service.engine.cache.invalidate()
    info = reg.cache.tenants_info()
    assert reg.cache.evictions > 0, "flood produced no cache pressure"
    assert info["b"]["nbytes"] >= b_warm
    hits = reg.tenant("b").service.metrics.snapshot()["cache_hits"]
    reg.count("b", pts[0])
    assert reg.tenant("b").service.metrics.snapshot()["cache_hits"] == \
        hits + 1


def test_tenant_cap_evicts_own_lru_not_neighbours():
    reg = make_registry([("a", 0), ("b", 1)])
    pts = points(reg.tenant("a").db.schema)
    for p in pts:
        reg.count("b", p)
    b_bytes = reg.cache.tenants_info()["b"]["nbytes"]
    reg.set_tenant_budget("a", cap_bytes=max(64, b_bytes // 4))
    reg.count_many([("a", p, None) for p in pts])
    info = reg.cache.tenants_info()
    assert info["a"]["nbytes"] <= max(64, b_bytes // 4) or \
        info["a"]["entries"] <= 1
    assert info["b"]["nbytes"] == b_bytes


# ---------------------------------------------------------- admission --

def test_admission_shed_bounds_flooder_and_spares_neighbour():
    reg = make_registry([("a", 0), ("b", 1)],
                        a={"admission_max": 3, "admission_policy": "shed"})
    pts = points(reg.tenant("a").db.schema)
    svc_a, svc_b = reg.tenant("a").service, reg.tenant("b").service
    tickets = []
    with svc_a.defer_drains(), svc_b.defer_drains():
        for p in pts[:3]:
            tickets.append(svc_a.submit(p))
        with pytest.raises(TenantAdmissionError):
            svc_a.submit(pts[3])
        for p in pts:
            tickets.append(svc_b.submit(p))
    reg.flush_all()
    for t in tickets:
        assert t.result(WAIT_S) is not None
    sa = svc_a.stats()
    assert sa["shed"] >= 1 and sa["admitted"] == 3
    assert svc_b.stats()["shed"] == 0


def test_admission_queue_policy_holds_depth_at_bound():
    reg = make_registry([("a", 0)],
                        a={"admission_max": 2, "admission_policy": "queue"})
    pts = points(reg.tenant("a").db.schema)
    svc = reg.tenant("a").service
    tickets = []
    with svc.defer_drains():               # admission still overrides this
        for p in pts:
            tickets.append(svc.submit(p))
            assert svc.pending() <= 2
    svc.flush()
    assert svc.stats()["throttled"] > 0
    ref = make_registry([("a", 0)]).tenant("a").service
    for t, p in zip(tickets, pts):
        assert_equal(t.result(WAIT_S), ref.count(p))


# --------------------------------------------------------- rate limiting --

def test_token_bucket_refill_with_injected_clock():
    from repro_torch.serve.service import _TokenBucket
    t = [0.0]
    b = _TokenBucket(2, 1.0, clock=lambda: t[0])
    assert b.acquire() == 0.0
    assert b.acquire() == 0.0
    wait = b.acquire()
    assert wait == pytest.approx(0.5)
    t[0] += wait
    assert b.acquire() == 0.0


def test_rate_limit_sheds_flooder_and_spares_neighbour():
    reg = make_registry([("a", 0), ("b", 1)],
                        a={"rate_limit": (3, 3600.0),
                           "admission_policy": "shed"})
    pts = points(reg.tenant("a").db.schema)
    svc_a, svc_b = reg.tenant("a").service, reg.tenant("b").service
    tickets = []
    with svc_a.defer_drains(), svc_b.defer_drains():
        for p in pts[:3]:
            tickets.append(svc_a.submit(p))
        with pytest.raises(TenantAdmissionError):
            svc_a.submit(pts[3])
        tickets.append(svc_a.submit(pts[0]))     # coalesces: no token
        for p in pts:
            tickets.append(svc_b.submit(p))
    reg.flush_all()
    for t in tickets:
        assert t.result(WAIT_S) is not None
    assert svc_a.count(pts[1]) is not None       # a cache hit is free
    sa, sb = svc_a.stats(), svc_b.stats()
    assert sa["rate_limited"] >= 1 and sa["shed"] >= 1
    assert sa["admitted"] == 3
    assert sb["rate_limited"] == 0 and sb["shed"] == 0


def test_rate_limit_queue_policy_sleeps_then_serves():
    reg = make_registry([("a", 0)],
                        a={"rate_limit": (2, 0.25),
                           "admission_policy": "queue"})
    pts = points(reg.tenant("a").db.schema)
    svc = reg.tenant("a").service
    t0 = time.monotonic()
    tickets = [svc.submit(p) for p in pts[:4]]
    waited = time.monotonic() - t0
    svc.flush()
    ref = make_registry([("a", 0)]).tenant("a").service
    for t, p in zip(tickets, pts):
        assert_equal(t.result(WAIT_S), ref.count(p))
    assert svc.stats()["rate_limited"] >= 2
    assert svc.stats()["shed"] == 0
    assert waited >= 0.1


# ------------------------------------------------- noisy-neighbour counts --

def test_neighbour_counts_bit_identical_under_flood_and_writes():
    quiet = make_registry([("b", 7)], n_rels=3)
    pts = points(quiet.tenant("b").db.schema)
    ref = [quiet.tenant("b").service.count(p) for p in pts]
    noisy = make_registry([("a", 3), ("b", 7)], n_rels=3)
    noisy.count_many([("a", p, None) for p in pts])
    src, dst, attrs = fresh_edges(noisy.tenant("a").db, "R0")
    noisy.apply_delta("a", "R0", src, dst, attrs)
    for p, r in zip(pts, ref):
        assert_equal(noisy.count("b", p), r)
    hits0 = noisy.tenant("b").service.metrics.snapshot()["cache_hits"]
    for p in pts:
        noisy.count("b", p)
    hits1 = noisy.tenant("b").service.metrics.snapshot()["cache_hits"]
    assert hits1 - hits0 == len(pts)


def test_discovery_shared_memo_is_tenant_disjoint():
    reg = make_registry([("a", 3), ("b", 7)], n_rels=3)
    res_b = reg.discovery("b").discover()
    quiet = make_registry([("b", 7)], n_rels=3)
    assert res_b.score == quiet.discovery("b").discover().score
    reg.discovery("a").discover()

    def b_keys():
        return {k for k in reg._score_memo if k[0][:2] == ("tenant", "b")}

    keys_before = b_keys()
    assert keys_before
    src, dst, attrs = fresh_edges(reg.tenant("a").db, "R0")
    reg.apply_delta("a", "R0", src, dst, attrs)
    reg.discovery("a").discover()
    assert b_keys() == keys_before
    assert reg.discovery("b").discover().score == res_b.score


# ------------------------------------------------------------- stats --

def test_registry_stats_cover_every_service_metrics_field():
    reg = make_registry([("a", 0), ("b", 1)], n_rels=3)
    pts = points(reg.tenant("a").db.schema)
    reg.count_many([(tid, p, None) for tid in ("a", "b") for p in pts])
    st = reg.stats()
    for tid in ("a", "b"):
        for f in dataclasses.fields(ServiceMetrics):
            if not f.name.startswith("_"):
                assert f.name in st["tenants"][tid], (tid, f.name)
                assert f.name in st["aggregate"], f.name
    assert st["aggregate"]["cache"]["hits"] == sum(
        st["tenants"][t]["cache"]["hits"] for t in ("a", "b"))
    assert st["aggregate"]["enqueued"] == sum(
        st["tenants"][t]["enqueued"] for t in ("a", "b"))
    assert set(st["cache"]["tenants"]) >= {"a", "b"}


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
    assert out["name"] == "a"
    assert out["flag"] is True
    assert merge_stats_dicts([]) == {}


def test_default_tenant_shim_unchanged():
    """A bare service is the degenerate single-tenant fleet: tenant
    stamped "default", no admission gate; a bare cache's entries are the
    default tenant's."""
    db = fleet_db(0, 2)
    svc = CountingService(tc.CountingEngine(db, device=CPU))
    st = svc.stats()
    assert st["tenant"] == "default"
    assert st["shed"] == 0 and st["throttled"] == 0
    p = points(db.schema)[0]
    assert svc.count(p) is not None
    cache = svc.engine.cache
    assert set(cache.tenants_info()) == {"default"}
    assert cache.keys_snapshot() == cache.keys_snapshot("default")


# -------------------------------------------- sharded tenants, both packages --

def test_sharded_tenant_served_by_its_router():
    """A ``ShardedDatabase`` tenant gets a router on the registry's shared
    executor; its tables equal its unsharded database's, and the fleet
    shuts down every shard service."""
    reg = make_registry([("a", 0)], executor="sparse")
    sharded = fleet_db(1)
    reg.add_tenant("s", tc.shard_database(fleet_db(1), 2))
    t = reg.tenant("s")
    assert t.router is not None and t.service is None
    assert all(e.executor is reg.executor for e in t.router.engines)
    pts = points(sharded.schema, 1)
    tabs = reg.count_many([(tid, p, None) for tid in ("a", "s")
                           for p in pts])
    eng = tc.CountingEngine(sharded, "sparse", device=CPU)
    for p, tab in zip(pts, tabs[len(pts):]):
        assert_equal(tab, eng.contract(p, None))
    with pytest.raises(ValueError):
        reg.add_tenant("s", fleet_db(2))
    reg.shutdown()
    for svc in t.router.services:
        with pytest.raises(ServiceShutdown):
            svc.submit(pts[0])


def test_registry_equals_jax():
    """The same fleet and mixed-tenant flood through the JAX registry and
    the port's: tables bit for bit, equal per-tenant request, cache-hit
    and coalesce counters, and equal complete tables."""
    schema = jax_fleet_schema(3)
    tenants = [("a", 0), ("b", 1)]
    jreg = JaxRegistry(executor="sparse")
    treg = TenantRegistry(executor="sparse", device=CPU)
    for tid, seed in tenants:
        jreg.add_tenant(tid, jax_fleet_db(schema, seed))
        treg.add_tenant(tid, to_port(jax_fleet_db(schema, seed)))
    jpts = [p for p in jc.build_lattice(schema, 2) if p.atoms]
    tpts = [point_to_port(p) for p in jpts]
    jt = jreg.count_many([(tid, p, None) for tid, _ in tenants
                          for p in jpts] * 2)
    tt = treg.count_many([(tid, p, None) for tid, _ in tenants
                          for p in tpts] * 2)
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    for (jp, tp) in zip(jpts, tpts):
        jk = jp.all_ct_vars(schema, include_rind=True)
        tk = tp.all_ct_vars(treg.tenant("b").db.schema, include_rind=True)
        np.testing.assert_array_equal(
            treg.count_complete("b", tp, tk).counts.numpy(),
            np.asarray(jreg.count_complete("b", jp, jk).counts))
    js, ts = jreg.stats(), treg.stats()
    for tid, _ in tenants:
        for k in ("requests", "cache_hits", "coalesced", "enqueued",
                  "batched_queries", "complete_requests"):
            assert ts["tenants"][tid][k] == js["tenants"][tid][k], (tid, k)
    for k in ("entries", "nbytes", "hits", "misses"):
        assert ts["cache"][k] == js["cache"][k], k
