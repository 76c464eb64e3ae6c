"""The port's four counting strategies × two executors against the oracle
and the JAX package, and its byte-budgeted cache under eviction."""

import itertools

import jax  # noqa: F401
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
from repro.core.oracle import oracle_ct
from tests.test_counting_core import tiny_db
from tests.test_engine_equivalence import random_db, random_keeps
from tests.test_torch_data import keep_to_port, point_to_port, to_port

CPU = "cpu"
COMBOS = list(itertools.product(sorted(tc.STRATEGIES), ("dense", "sparse")))
STAT_KEYS = ("joins", "rows_scanned", "ct_rows", "ct_cells")


@pytest.mark.parametrize("sname,ex", COMBOS)
def test_strategies_match_oracle_and_jax(sname, ex):
    jdb = tiny_db(0)
    tdb = to_port(jdb)
    lattice = jc.build_lattice(jdb.schema, 2)
    point = lattice[-1]
    keeps = random_keeps(np.random.default_rng(3), point, jdb.schema) + [()]
    js = jc.make_strategy(sname, executor=ex)
    js.prepare(jdb, lattice)
    ts = tc.make_strategy(sname, executor=ex, device=CPU)
    ts.prepare(tdb, [point_to_port(p) for p in lattice])
    tp = point_to_port(point)
    many = ts.family_ct_many(tp, [keep_to_port(k) for k in keeps])
    want_many = js.family_ct_many(point, keeps)
    for keep, got, want in zip(keeps, many, want_many):
        one = ts.family_ct(tp, keep_to_port(keep))
        assert got.vars == keep_to_port(keep) == one.vars
        oracle = oracle_ct(jdb, point, keep)
        np.testing.assert_array_equal(got.counts.numpy(), oracle)
        np.testing.assert_array_equal(one.counts.numpy(), oracle)
        np.testing.assert_array_equal(got.counts.numpy(),
                                      np.asarray(want.counts))
    jst, tst = js.stats.as_dict(), ts.stats.as_dict()
    for k in STAT_KEYS[:3]:
        assert tst[k] == jst[k], k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_schemas_match_oracle(seed):
    jdb = random_db(seed)
    tdb = to_port(jdb)
    lattice = jc.build_lattice(jdb.schema, 2)
    point = lattice[-1]
    keeps = random_keeps(np.random.default_rng(seed + 100), point,
                         jdb.schema)
    oracles = [oracle_ct(jdb, point, keep) for keep in keeps]
    for sname, ex in COMBOS:
        st = tc.make_strategy(sname, executor=ex, device=CPU)
        st.prepare(tdb, [point_to_port(p) for p in lattice])
        for keep, want in zip(keeps, oracles):
            got = st.family_ct(point_to_port(point), keep_to_port(keep))
            np.testing.assert_array_equal(
                got.counts.numpy(), want,
                err_msg=f"{sname}/{ex} keep={[str(v) for v in keep]}")


@pytest.mark.parametrize("ex", ("dense", "sparse"))
def test_tight_budget_eviction_keeps_answers(ex):
    """An eviction-forcing budget changes no answer; the cache accounting
    matches the JAX package's entry for entry."""
    jdb = random_db(7)
    tdb = to_port(jdb)
    lattice = jc.build_lattice(jdb.schema, 2)
    point = lattice[-1]
    keeps = random_keeps(np.random.default_rng(7), point, jdb.schema, n=5)
    budget = 4096
    js = jc.make_strategy("HYBRID", executor=ex, cache_budget_bytes=budget)
    js.prepare(jdb, lattice)
    ts = tc.make_strategy("HYBRID", executor=ex, cache_budget_bytes=budget,
                          device=CPU)
    ts.prepare(tdb, [point_to_port(p) for p in lattice])
    free = tc.make_strategy("HYBRID", executor=ex, device=CPU)
    free.prepare(tdb, [point_to_port(p) for p in lattice])
    for keep in keeps + keeps[::-1]:
        tk = keep_to_port(keep)
        got = ts.family_ct(point_to_port(point), tk)
        np.testing.assert_array_equal(
            got.counts.numpy(), free.family_ct(point_to_port(point),
                                               tk).counts.numpy())
        np.testing.assert_array_equal(
            got.counts.numpy(), np.asarray(js.family_ct(point, keep).counts))
    cache = ts.engine.cache
    assert cache.nbytes <= budget or len(cache) <= 1
    assert ts.stats.cache_bytes == cache.nbytes
    assert ts.stats.peak_bytes >= ts.stats.cache_bytes
    assert cache.evictions > 0
    jinfo = js.engine.cache.info()
    for k, v in cache.info().items():
        assert v == jinfo[k], k
    for k in STAT_KEYS:
        assert ts.stats.as_dict()[k] == js.stats.as_dict()[k], k


def test_cache_invalidate_and_deps():
    tdb = to_port(tiny_db(1))
    st = tc.make_strategy("HYBRID", executor="sparse", device=CPU)
    lattice = tc.build_lattice(tdb.schema, 2)
    st.prepare(tdb, lattice)
    cache = st.engine.cache
    n = len(cache)
    assert n == len(lattice)
    dropped = cache.invalidate({"Reg"})
    assert dropped == sum(1 for p in lattice if "Reg" in p.rels)
    assert len(cache) == n - dropped
    assert cache.invalidated == dropped
    assert st.stats.cache_bytes == cache.nbytes
