"""The port's batched positive dispatch (``Executor.positive_batch``,
``serve.batching``) against its own unbatched path and the JAX package.

Counts are integers in float32 below 2^24, so every comparison here is
exact (``assert_array_equal``, ``torch.equal``: tolerance 0): a stacked
group is one flattened evaluation whose sums are the unbatched sums in
another order.
"""

import itertools

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core import executors as jex
from repro.core import synth_db
from repro.core.plan import compile_plan as jax_compile_plan
from repro_torch.core import executors as tex
from repro_torch.core.engine import OnDemandPositives
from repro_torch.core.mobius import complete_ct
from repro_torch.core.strategies import _project_wide
from repro_torch.kernels import ops
from repro_torch.serve import execute_bucketed, execute_complete_bucketed
from tests.test_serve import att, flood_db, mixed_db
from tests.test_torch_data import (edges_of, keep_to_port, point_to_port,
                                   to_port)

CPU = "cpu"
EXECUTORS = ("dense", "sparse")


def _keeps(rng, pool, n=3):
    keeps = [tuple(pool), ()]
    for _ in range(n):
        k = int(rng.integers(1, len(pool) + 1))
        pick = rng.choice(len(pool), size=k, replace=False)
        keeps.append(tuple(pool[i] for i in sorted(pick)))
    return keeps


def _plans(jdb, length, seed=0, rind=False, n=3):
    """JAX plans over ``jdb``'s lattice (every point, full and random
    keeps) and the same queries compiled by the port on ``to_port(jdb)``."""
    tdb = to_port(jdb)
    rng = np.random.default_rng(seed)
    jplans, tplans = [], []
    for point in jc.build_lattice(jdb.schema, length):
        pool = list(point.all_ct_vars(jdb.schema, include_rind=rind))
        for keep in _keeps(rng, pool, n):
            jplans.append(jax_compile_plan(jdb.schema, point, keep))
            tplans.append(tc.compile_plan(tdb.schema, point_to_port(point),
                                          keep_to_port(keep)))
    return tdb, jplans, tplans


def _equal_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.vars == w.vars
        assert torch.equal(g.counts, w.counts)


def ragged_db(edges=(17, 23, 30, 32), seed=0):
    """Same-shape relationships whose edge counts differ inside one
    bucket (32): one stack group whose edge lists differ in length."""
    ents = (jc.EntityType("A", 10, (att("a0", 3), att("a1", 2))),
            jc.EntityType("B", 8, (att("b0", 3),)))
    rels = tuple(jc.Relationship(f"R{i}", "A", "B", (att(f"e{i}", 3),))
                 for i in range(len(edges)))
    return synth_db(jc.Schema(ents, rels),
                    {f"R{i}": e for i, e in enumerate(edges)}, seed=seed)


# --------------------------------------------------------- stack keys ----

@pytest.mark.parametrize("name,scale", [("UW", 1.0), ("IMDb", 0.01)])
def test_stack_keys_equal_jax(name, scale):
    jdb = jc.paper_benchmark_db(name, 0, scale=scale)
    tdb, jplans, tplans = _plans(jdb, 2)
    for jp, tp in zip(jplans, tplans):
        assert tex.plan_stack_key(tdb, tp) == jex.plan_stack_key(jdb, jp)


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 32, 33, 1000])
def test_edge_bucket_equals_jax(n):
    assert tex._edge_bucket(n) == jex._edge_bucket(n)


# ----------------------------------------------------- positive_batch ----

@pytest.mark.parametrize("ex,length", itertools.product(EXECUTORS, (1, 3)))
def test_positive_batch_identical_to_positive_and_jax(ex, length):
    """A flood of stack-compatible plans (chains of 3 take the
    dense-message hop): bit for bit against the port's ``positive`` and
    the JAX package's ``positive_batch``."""
    jdb = flood_db()
    tdb, jplans, tplans = _plans(jdb, length, seed=length)
    groups = {}
    for p in tplans:
        groups.setdefault(tex.plan_stack_key(tdb, p), []).append(p)
    assert max(map(len, groups.values())) >= 4           # real stacking
    x = tc.make_executor(ex, device=CPU)
    want = [x.positive(tdb, p) for p in tplans]
    ops.reset_counts()
    got = x.positive_batch(tdb, tplans)
    batched = sum(ops.PLAIN_CALLS.values())
    _equal_tables(got, want)
    jax_got = jex.EXECUTORS[ex]().positive_batch(jdb, jplans)
    for g, j in zip(got, jax_got):
        assert g.vars == keep_to_port(j.vars)
        np.testing.assert_array_equal(g.counts.numpy(), np.asarray(j.counts))
    ops.reset_counts()
    for p in tplans:
        x.positive(tdb, p)
    assert batched < sum(ops.PLAIN_CALLS.values())      # fewer segment sums


@pytest.mark.parametrize("ex", EXECUTORS)
def test_positive_batch_mixed_signatures(ex):
    jdb = mixed_db()
    tdb, _, tplans = _plans(jdb, 2, seed=5)
    assert len(tc.group_by_signature(tplans, key="shape")) > 1
    x = tc.make_executor(ex, device=CPU)
    _equal_tables(x.positive_batch(tdb, tplans),
                  [x.positive(tdb, p) for p in tplans])


@pytest.mark.parametrize("ex", EXECUTORS)
def test_batch_accounting_matches_unbatched(ex):
    tdb, _, tplans = _plans(flood_db(), 2, seed=2)
    x = tc.make_executor(ex, device=CPU)
    ref, got = tc.CostStats(), tc.CostStats()
    for p in tplans:
        x.positive(tdb, p, ref)
    x.positive_batch(tdb, tplans, got)
    assert (got.joins, got.rows_scanned, got.ct_cells) == \
        (ref.joins, ref.rows_scanned, ref.ct_cells)


@pytest.mark.parametrize("ex,length", itertools.product(EXECUTORS, (1, 2)))
def test_ragged_edges_in_one_bucket_do_not_leak(ex, length):
    """Plans whose edge counts differ inside one bucket stack together;
    each plan's edges must land in its own segment space, whatever the
    lengths of its neighbours' edge lists."""
    jdb = ragged_db()
    tdb, jplans, tplans = _plans(jdb, length, seed=9)
    singles = [p for p in tplans if len(p.point.atoms) == 1]
    assert len({tex.plan_stack_key(tdb, p) for p in singles}) < len(singles)
    assert len({tdb.relations[r].num_edges for r in tdb.relations}) == 4
    x = tc.make_executor(ex, device=CPU)
    _equal_tables(x.positive_batch(tdb, tplans),
                  [x.positive(tdb, p) for p in tplans])


@pytest.mark.parametrize("ex", EXECUTORS)
def test_int32_split_gives_unbatched_tables(ex, monkeypatch):
    """A group whose stacked segment spaces would pass int32 is cut into
    the largest sub-batches that fit (here a limit of two plans' spaces:
    sub-batches of 2, 2 and 1); one plan over the limit still raises."""
    tdb, _, tplans = _plans(flood_db(), 1, seed=4)
    x = tc.make_executor(ex, device=CPU)
    group = [p for p in tplans
             if tex.plan_stack_key(tdb, p) == tex.plan_stack_key(tdb,
                                                                 tplans[0])]
    group = (group * 3)[:5]
    space = x._stack_space(tdb, group[0])
    want = [x.positive(tdb, p) for p in group]
    sizes = []
    evaluate = x._evaluate

    def spy(db, plans, stats):
        sizes.append(len(plans))
        return evaluate(db, plans, stats)

    monkeypatch.setattr(x, "_evaluate", spy)
    monkeypatch.setattr(tex, "_INT32_LIMIT", 2 * space + 1)
    _equal_tables(x.positive_batch(tdb, group), want)
    assert sizes == [2, 2, 1]
    if ex == "sparse":
        monkeypatch.setattr(tex, "_INT32_LIMIT", space - 1)
        with pytest.raises(OverflowError):
            x.positive(tdb, group[0])
        with pytest.raises(OverflowError):
            x.positive_batch(tdb, group)


@pytest.mark.parametrize("ex", EXECUTORS)
def test_group_tables_own_their_storage(ex):
    """A stacked group's tables are copies out of the group's result, so
    that a cached table does not keep its whole group alive."""
    tdb, _, tplans = _plans(flood_db(), 1)
    key = tex.plan_stack_key(tdb, tplans[0])
    group = [p for p in tplans if tex.plan_stack_key(tdb, p) == key]
    assert len(group) >= 3
    tabs = tc.make_executor(ex, device=CPU).positive_batch(tdb, group)
    ptrs = {t.counts.untyped_storage().data_ptr() for t in tabs}
    assert len(ptrs) == len(tabs)
    for t in tabs:
        assert (t.counts.untyped_storage().nbytes()
                == t.counts.numel() * t.counts.element_size())


def twin_db(seed=0):
    """Two entity types of one size and the same attribute cards (A, A1),
    each related to B by as many edges: plans over ``R(A, B)`` and ``S(A1,
    B)`` share a stack key but read different tables."""
    ents = (jc.EntityType("A", 12, (att("a0", 3), att("a1", 2))),
            jc.EntityType("A1", 12, (att("c0", 3), att("c1", 2))),
            jc.EntityType("B", 9, (att("b0", 3),)))
    rels = (jc.Relationship("R", "A", "B", (att("r0", 3),)),
            jc.Relationship("S", "A1", "B", (att("s0", 3),)))
    return synth_db(jc.Schema(ents, rels), {"R": 40, "S": 40}, seed=seed)


@pytest.mark.parametrize("ex", EXECUTORS)
def test_equal_size_entity_types_stack_with_their_own_tables(ex):
    tdb, _, tplans = _plans(twin_db(), 1, seed=3)
    by_key = {}
    for p in tplans:
        by_key.setdefault(tex.plan_stack_key(tdb, p), set()).add(
            p.point.atoms[0].rel)
    assert any(len(rels) == 2 for rels in by_key.values())
    x = tc.make_executor(ex, device=CPU)
    _equal_tables(x.positive_batch(tdb, tplans),
                  [x.positive(tdb, p) for p in tplans])


# ------------------------------------------------------------ serve ----

class _Metrics:
    def __init__(self):
        self.batches, self.mobius = [], []

    def observe_batch(self, sig, n, dt):
        self.batches.append(n)

    def observe_mobius(self, n, dt):
        self.mobius.append(n)


@pytest.mark.parametrize("ex,cap", itertools.product(EXECUTORS, (None, 2)))
def test_execute_bucketed_equals_positive(ex, cap):
    tdb, _, tplans = _plans(mixed_db(), 2, seed=6)
    x = tc.make_executor(ex, device=CPU)
    metrics = _Metrics()
    got = execute_bucketed(x, tdb, tplans, max_batch_size=cap,
                           metrics=metrics)
    _equal_tables(got, [x.positive(tdb, p) for p in tplans])
    sizes = [len(v) for v in tc.group_by_signature(tplans).values()]
    step = cap or max(sizes)
    assert metrics.batches == [min(step, n - s) for n in sizes
                               for s in range(0, n, step)]


@pytest.mark.parametrize("ex", EXECUTORS)
def test_execute_complete_bucketed_equals_complete_ct(ex):
    tdb = to_port(mixed_db())
    engine = tc.CountingEngine(tdb, ex, tc.CostStats(), device=CPU)
    lattice = tc.build_lattice(tdb.schema, 2)
    queries = [(p, tuple(p.all_ct_vars(tdb.schema, include_rind=True)))
               for p in lattice]
    metrics = _Metrics()
    tabs = execute_complete_bucketed(engine, OnDemandPositives(engine),
                                     queries, engine.stats,
                                     max_batch_size=16, metrics=metrics)
    ref = OnDemandPositives(tc.CountingEngine(tdb, ex, tc.CostStats(),
                                              device=CPU))
    _equal_tables(tabs, [complete_ct(p, keep, ref) for p, keep in queries])
    assert metrics.batches and metrics.mobius
    assert engine.stats.time_positive > 0 and engine.stats.time_negative > 0


def _family_keeps(db, point, seed, n):
    pool = list(point.all_ct_vars(db.schema, include_rind=True))
    rng = np.random.default_rng(seed)
    keeps = [tuple(pool)]
    for _ in range(n):
        k = rng.integers(1, len(pool) + 1)
        pick = rng.choice(len(pool), size=k, replace=False)
        keeps.append(tuple(pool[i] for i in sorted(pick)))
    return keeps


@pytest.mark.parametrize("sname,ex", itertools.product(("ONDEMAND", "HYBRID"),
                                                       EXECUTORS))
def test_family_ct_many_equals_family_ct(sname, ex, monkeypatch):
    """``family_ct_many`` prefetches through ``execute_bucketed`` (the
    stacked path) and answers as per-query ``family_ct`` does; HYBRID
    under a budget that evicts reaches ``positive_batch`` too.  (Its
    parity with the JAX package's ``family_ct_many`` is
    ``tests/test_torch_strategies.py``'s.)"""
    tdb = to_port(mixed_db())
    lattice = tc.build_lattice(tdb.schema, 2)
    keeps = _family_keeps(tdb, lattice[-1], 7, 5)
    budget = 2048 if sname == "HYBRID" else None
    ref = tc.make_strategy(sname, executor=ex, device=CPU)
    ref.prepare(tdb, lattice)
    want = [ref.family_ct(lattice[-1], k) for k in keeps]
    calls = []
    batch = tex.Executor.positive_batch

    def spy(self, db, plans, stats=None):
        calls.append(len(plans))
        return batch(self, db, plans, stats)

    monkeypatch.setattr(tex.Executor, "positive_batch", spy)
    st = tc.make_strategy(sname, executor=ex, device=CPU,
                          cache_budget_bytes=budget)
    st.prepare(tdb, lattice)
    got = st.family_ct_many(lattice[-1], keeps)
    assert calls and sum(calls) > 0
    _equal_tables(got, want)


@pytest.mark.parametrize("ex", EXECUTORS)
def test_mixed_signature_flood_under_tight_budget(ex):
    """A mixed-signature flood against a cache too small to hold the
    working set still answers every query exactly."""
    tdb = to_port(mixed_db())
    lattice = tc.build_lattice(tdb.schema, 2)
    point = lattice[-1]
    keeps = _family_keeps(tdb, point, 3, 11)
    ref = tc.make_strategy("ONDEMAND", executor=ex, device=CPU)
    ref.prepare(tdb, lattice)
    want = [ref.family_ct(point, k) for k in keeps]
    st = tc.make_strategy("ONDEMAND", executor=ex, device=CPU,
                          cache_budget_bytes=4096)
    st.prepare(tdb, lattice)
    _equal_tables(st.family_ct_many(point, keeps), want)
    cache = st.engine.cache
    assert cache.nbytes <= 4096 or len(cache) <= 1
    assert st.stats.cache_bytes == cache.nbytes


# ------------------------------------------------------ the slice whole ----

@pytest.fixture(scope="module")
def uw_models():
    db = tc.paper_benchmark_db("UW", 0, scale=0.25)
    out = {}
    for sname, ex in itertools.product(("HYBRID", "ONDEMAND", "PRECOUNT"),
                                       EXECUTORS):
        models, st = tc.discover_model(
            db, tc.make_strategy(sname, executor=ex, device=CPU),
            device=CPU)
        out[sname, ex] = (edges_of(models), st.stats.as_dict())
    return out


@pytest.mark.parametrize("sname,ex", itertools.product(("ONDEMAND",
                                                        "PRECOUNT"),
                                                       EXECUTORS))
def test_strategies_learn_hybrids_models_on_uw(uw_models, sname, ex):
    edges, stats = uw_models[sname, ex]
    assert edges == uw_models["HYBRID", ex][0]
    assert stats["joins"] > 0


#: the relative difference that PRECOUNT's families and HYBRID's may show
#: in cells past 2^24, where float32 rounds counts: 64 units in the last
#: place (chip_smoke.py holds the card's PRECOUNT run to the same bound)
ROUNDING_PAST_2_24 = 2.0 ** -18


class _NoPositives:
    """A planted fault: a positive provider that finds no grounding where
    a relationship holds, so a negative phase over it subtracts nothing."""

    def __init__(self, provider):
        self.provider = provider

    def hist(self, var, keep):
        return self.provider.hist(var, keep)

    def positive(self, point, keep):
        t = self.provider.positive(point, keep)
        return tc.CtTable(t.vars, torch.zeros_like(t.counts))


def _past_2_24(a, b):
    """The largest relative difference between two tables in the cells
    past 2^24, and whether any cell below it differs."""
    a, b = a.double(), b.double()
    big = torch.maximum(a.abs(), b.abs())
    diff = a != b
    low = bool((diff & (big < 2 ** 24)).any())
    high = diff & (big >= 2 ** 24)
    return (float(((a - b).abs() / big)[high].max()) if high.any()
            else 0.0), low


def _exact_projection(vars_, counts, keep):
    """A table's projection onto ``keep`` in float64 numpy (exact: the
    cells are integers, and so are their sums below 2^53)."""
    drop = tuple(i for i, v in enumerate(vars_) if v not in keep)
    cur = [v for v in vars_ if v in keep]
    out = np.asarray(counts, dtype=np.float64).sum(axis=drop)
    return np.transpose(out, [cur.index(v) for v in keep])


def test_precount_rounds_only_above_2_24_as_jax_does():
    """PRECOUNT projects each family from a point's complete table; HYBRID
    runs a Möbius join over projected positives.  Counts past 2^24 (the
    groundings where a relationship does not hold: 8e9 at a 2-atom point of
    IMDb at scale 0.02) are not exact in float32.  Here:

    * the complete tables (the negative phase's output) equal the JAX
      package's bit for bit, and each PRECOUNT family equals the exact
      projection of JAX's complete table, rounded once, bit for bit;
    * the port's HYBRID equals JAX's HYBRID bit for bit;
    * PRECOUNT and HYBRID agree bit for bit below 2^24, and past it within
      ``ROUNDING_PAST_2_24`` (both in the port and, below 2^24, in the JAX
      package, whose two strategies round past 2^24 apart as well);
    * a negative phase that subtracts no positive count (``_NoPositives``)
      differs from HYBRID by more than that bound past 2^24, in the cells
      it leaves nonzero."""
    jdb = jc.paper_benchmark_db("IMDb", 0, scale=0.02)
    tdb = to_port(jdb)
    jlattice = jc.build_lattice(jdb.schema, 2)
    lattice = [point_to_port(p) for p in jlattice]
    port = {n: tc.make_strategy(n, executor="sparse", device=CPU)
            for n in ("HYBRID", "PRECOUNT")}
    ref = {n: jc.make_strategy(n, executor="sparse")
           for n in ("HYBRID", "PRECOUNT")}
    for n in port:
        port[n].prepare(tdb, lattice)
        ref[n].prepare(jdb, jlattice)
    rng = np.random.default_rng(0)
    port_rounded = jax_rounded = 0
    worst = planted = 0.0
    for jp, tp in zip(jlattice, lattice):
        full = port["PRECOUNT"]._complete_full(tp)
        jfull = ref["PRECOUNT"]._complete_full(jp)
        assert full.vars == keep_to_port(jfull.vars)
        np.testing.assert_array_equal(full.counts.numpy(),
                                      np.asarray(jfull.counts))
        faulty = complete_ct(tp, full.vars,
                             _NoPositives(port["PRECOUNT"].provider))
        pool = list(jp.all_ct_vars(jdb.schema, include_rind=True))
        for _ in range(6):
            pick = rng.choice(len(pool), size=int(rng.integers(1, 4)),
                              replace=False)
            keep = tuple(pool[i] for i in sorted(pick))
            a, b = (port[n].family_ct(tp, keep_to_port(keep))
                    for n in ("HYBRID", "PRECOUNT"))
            assert a.vars == b.vars == keep_to_port(keep)
            np.testing.assert_array_equal(
                b.counts.numpy(),
                _exact_projection(jfull.vars, jfull.counts,
                                  keep).astype(np.float32))
            rel, low = _past_2_24(a.counts, b.counts)
            assert not low
            worst = max(worst, rel)
            port_rounded += bool((a.counts != b.counts).any())
            ja, jb = (np.asarray(ref[n].family_ct(jp, keep).counts)
                      for n in ("HYBRID", "PRECOUNT"))
            np.testing.assert_array_equal(a.counts.numpy(), ja)
            _, low = _past_2_24(torch.from_numpy(np.array(ja)),
                                torch.from_numpy(np.array(jb)))
            assert not low
            jax_rounded += not np.array_equal(ja, jb)
            # the fault empties every block where a relationship holds:
            # past 2^24, read the negative phase proper it leaves
            f = _project_wide(faulty, keep_to_port(keep)).counts
            planted = max(planted,
                          _past_2_24(a.counts[f != 0], f[f != 0])[0])
    assert port_rounded > 0 and jax_rounded > 0
    assert worst <= ROUNDING_PAST_2_24 < planted
