"""The port's database sharding and its multi-database executor paths,
held to the JAX package's.

* ``shard_database``: the partition invariants of
  ``tests/test_distributed_counting.py`` (every partitioned edge on one
  shard, replicated and entity tables shared), its argument checks and the
  oversized-replication heuristic; and on the same seeded databases the
  JAX package's and the port's shards hold the same arrays, the same root
  type, partitioned set and bucket map.
* ``ShardedDatabase.route``: the same decision for every lattice point in
  both packages, and the not-routable case.
* ``split_shard`` and the sharded writes: the same shard contents and
  delta patterns as the JAX package's.
* The multi-database executor paths (``positive_batch_multi``,
  ``positive_stacked_merged``, ``positive_fanout_merged``,
  ``fanout_stack_key``): bit for bit each database alone, the JAX
  package's tables, and a fan-out merge the single database's table.
"""

import warnings

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest

import repro.core as jc
import repro_torch.core as tc
import repro_torch.core.executors as tex
from repro.core import executors as jex
from repro_torch.kernels import ops
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import point_to_port, to_port

CPU = "cpu"
EXECUTORS = sorted(tc.EXECUTORS)
# the JAX package's "sparse_sharded" stacks plans under vmap over a mesh of
# every visible device and fails once a test in the process has made more
# than one (its _reduce_by_code turns a traced code into numpy,
# src/repro/core/distributed.py:393); the port's sharded executor is held
# to the JAX single-device one in tests/test_torch_distributed.py
JAX_EXECUTORS = ("dense", "sparse")


def mixed_db(seed: int = 0):
    return to_port(jax_mixed_db(seed))


def both(name, seed=0, scale=1.0):
    jdb = jc.paper_benchmark_db(name, seed=seed, scale=scale)
    return jdb, tc.paper_benchmark_db(name, seed=seed, scale=scale)


def bad_point(pkg):
    """Two partitioned atoms meeting root type ``A`` at different
    variables: per-shard counts are not additive."""
    return pkg.LatticePoint((pkg.Atom("R0", pkg.Var("A", 1), pkg.Var("B", 0)),
                             pkg.Atom("R2", pkg.Var("A", 0),
                                      pkg.Var("C", 0))))


def assert_db_equal(jdb, tdb):
    assert jdb.version == tdb.version
    for name, jt in jdb.relations.items():
        tt = tdb.relations[name]
        np.testing.assert_array_equal(tt.src, jt.src)
        np.testing.assert_array_equal(tt.dst, jt.dst)
        assert set(tt.attrs) == set(jt.attrs)
        for a in jt.attrs:
            np.testing.assert_array_equal(tt.attrs[a], jt.attrs[a])
    for name, je in jdb.entities.items():
        for a, col in je.attrs.items():
            np.testing.assert_array_equal(tdb.entities[name].attrs[a], col)


def assert_sharded_equal(jsdb, tsdb):
    assert tsdb.root_etype == jsdb.root_etype
    assert tsdb.partitioned == jsdb.partitioned
    assert (tsdb.n_buckets, tsdb.bucket_map) == (jsdb.n_buckets,
                                                 jsdb.bucket_map)
    assert tsdb.n_shards == jsdb.n_shards
    for js, ts in zip(jsdb.shards, tsdb.shards):
        assert_db_equal(js, ts)


def equal_tables(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.vars == w.vars
        np.testing.assert_array_equal(g.counts.numpy(), w.counts.numpy())


def routable(sdb, lattice):
    out = []
    for p in lattice:
        try:
            sdb.route(p)
            out.append(p)
        except tc.NotRoutableError:
            pass
    return out


# ---------------------------------------------------- partition invariants --

def test_shard_database_partition_invariants():
    db = mixed_db()
    sdb = tc.shard_database(db, 3)
    assert sdb.n_shards == 3
    assert sdb.root_etype == "A"            # most-incident entity type
    assert sdb.partitioned == {"R0", "R2"}  # A-incident rels; R1 replicated
    for name, tab in db.relations.items():
        if name in sdb.partitioned:
            parts = [s.relations[name] for s in sdb.shards]
            assert sum(p.num_edges for p in parts) == tab.num_edges
            got = sorted((int(a), int(b)) for p in parts
                         for a, b in zip(p.src, p.dst))
            assert got == sorted((int(a), int(b))
                                 for a, b in zip(tab.src, tab.dst))
        else:
            for s in sdb.shards:
                assert s.relations[name] is tab      # replicated, shared
    for s in sdb.shards:
        s.validate()
        for ename, etab in s.entities.items():       # entities replicated
            assert etab is db.entities[ename]


def test_shard_database_rejects_bad_args():
    db = mixed_db()
    with pytest.raises(ValueError):
        tc.shard_database(db, 0)
    with pytest.raises(ValueError):
        tc.shard_database(db, 2, root_etype="nope")
    with pytest.raises(ValueError):
        tc.shard_database(db, 4, n_buckets=3)


@pytest.mark.parametrize("name,n", [("UW", 2), ("UW", 3), ("Mondial", 4),
                                    ("mixed", 3)])
def test_shards_equal_jax(name, n):
    """The same seeded database sharded by both packages: the same root
    type, partitioned set, bucket map and shard arrays."""
    if name == "mixed":
        jdb = jax_mixed_db()
        tdb = mixed_db()
    else:
        jdb, tdb = both(name)
    assert_sharded_equal(jc.shard_database(jdb, n),
                         tc.shard_database(tdb, n))
    np.testing.assert_array_equal(
        tc.shard_database(tdb, n).shard_of_ids(np.arange(50)),
        jc.shard_database(jdb, n).shard_of_ids(np.arange(50)))


@pytest.mark.parametrize("mode", ["warn", "error", "ignore"])
def test_oversized_replication_as_jax(mode):
    """A replicated table over ``max_replicated_bytes`` warns, refuses or
    passes in both packages alike."""
    jdb, tdb = jax_mixed_db(), mixed_db()
    outs = []
    for pkg, db in ((jc, jdb), (tc, tdb)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                pkg.shard_database(db, 2, root_etype="A",
                                   max_replicated_bytes=8,
                                   on_oversized_replicated=mode)
                raised = False
            except ValueError:
                raised = True
        outs.append((raised, [str(w.message) for w in caught
                              if issubclass(w.category, ResourceWarning)]))
    assert outs[0] == outs[1]
    assert outs[1][0] == (mode == "error")
    assert bool(outs[1][1]) == (mode == "warn")


# ---------------------------------------------------------------- routing --

def test_route_decisions():
    db = mixed_db()
    sdb = tc.shard_database(db, 2, root_etype="A")
    modes = {str(p): sdb.route(p) for p in tc.build_lattice(db.schema, 2)}
    assert modes["R1(B0,C0)"][0] == "single"        # only replicated tables
    assert modes["R0(A0,B0)"] == ("fanout", None)   # one partitioned atom
    assert modes["R0(A0,B0)&R2(A0,C0)"] == ("fanout", None)  # shared A0
    mode, shard = modes["R1(B0,C0)"]
    assert 0 <= shard < 2


def test_route_rejects_incoherent_partition_vars():
    sdb = tc.shard_database(mixed_db(), 2, root_etype="A")
    with pytest.raises(tc.NotRoutableError):
        sdb.route(bad_point(tc))


@pytest.mark.parametrize("name,n,length", [("UW", 2, 2), ("Mondial", 3, 2),
                                           ("mixed", 2, 3)])
def test_routes_equal_jax(name, n, length):
    jdb, tdb = ((jax_mixed_db(), mixed_db()) if name == "mixed"
                else both(name))
    jsdb, tsdb = jc.shard_database(jdb, n), tc.shard_database(tdb, n)
    for p in jc.build_lattice(jdb.schema, length):
        try:
            want = jsdb.route(p)
        except jc.NotRoutableError:
            with pytest.raises(tc.NotRoutableError):
                tsdb.route(point_to_port(p))
            continue
        assert tsdb.route(point_to_port(p)) == want, str(p)


# -------------------------------------------------------- split and writes --

def test_split_shard_moves_only_that_shard():
    jdb, tdb = both("UW")
    jsdb, tsdb = jc.shard_database(jdb, 2), tc.shard_database(tdb, 2)
    hot = max(range(2), key=tsdb.partitioned_rows)
    assert hot == max(range(2), key=jsdb.partitioned_rows)
    jsplit, tsplit = jsdb.split_shard(hot), tsdb.split_shard(hot)
    assert_sharded_equal(jsplit, tsplit)
    assert tsplit.n_shards == 3
    cold = 1 - hot
    assert tsplit.shards[cold] is tsdb.shards[cold]  # untouched: same object
    for name in tsdb.partitioned:                    # rows conserved
        assert (tsplit.shards[hot].relations[name].num_edges
                + tsplit.shards[2].relations[name].num_edges
                == tsdb.shards[hot].relations[name].num_edges)
    with pytest.raises(IndexError):
        tsdb.split_shard(5)
    one = tc.shard_database(tdb, 2, n_buckets=2)
    with pytest.raises(ValueError):
        one.split_shard(0)


def test_sharded_writes_equal_jax():
    """An insert and a delete into a partitioned relation, one into a
    replicated one and an attribute write: the same per-shard delta
    pattern (``None`` where a shard took nothing), the same edges and the
    same shard contents as the JAX package's."""
    jdb, tdb = jax_mixed_db(), mixed_db()
    jsdb = jc.shard_database(jdb, 3, root_etype="A")
    tsdb = tc.shard_database(tdb, 3, root_etype="A")
    rng = np.random.default_rng(3)
    r0 = jdb.relations["R0"]
    have = set(zip(r0.src.tolist(), r0.dst.tolist()))
    fresh = [(s, d) for s in range(9) for d in range(7)
             if (s, d) not in have][:5]
    src = np.array([s for s, _ in fresh])
    dst = np.array([d for _, d in fresh])
    e0 = rng.integers(0, 2, size=len(fresh))
    r1 = jdb.relations["R1"]
    writes = [
        ("insert_facts", ("R0", src, dst, {"e0": e0})),
        ("delete_facts", ("R0", r0.src[:3].copy(), r0.dst[:3].copy())),
        ("delete_facts", ("R1", r1.src[:2].copy(), r1.dst[:2].copy())),
        ("update_attrs", ("B", np.array([1, 4]), {"b0": np.array([3, 0])})),
    ]
    for op, args in writes:
        jd = getattr(jsdb, op)(*args)
        td = getattr(tsdb, op)(*args)
        assert [d is None for d in td] == [d is None for d in jd], op
        for j, t in zip(jd, td):
            if j is None:
                continue
            assert (t.old_version, t.new_version) == (j.old_version,
                                                      j.new_version)
            if op == "update_attrs":
                np.testing.assert_array_equal(t.rows, j.rows)
            else:
                np.testing.assert_array_equal(t.src, j.src)
                np.testing.assert_array_equal(t.dst, j.dst)
        assert_sharded_equal(jsdb, tsdb)


# ------------------------------------------------ multi-database executors --

def fanout_plans(sdb, length):
    """Plans of the points of ``length`` that ``sdb`` routes fan-out."""
    eng = tc.CountingEngine(sdb.shards[0], "sparse", device=CPU)
    return [eng.plan(p, None) for p in tc.build_lattice(sdb.schema, length)
            if p in routable(sdb, [p]) and sdb.route(p)[0] == "fanout"]


@pytest.mark.parametrize("ex", EXECUTORS)
def test_positive_batch_multi_equals_each_db_alone(ex):
    """Plans of several databases of one schema in one call: each table
    bit for bit its own database's, joins and rows accounted per item as
    each database alone, and one launch per hop step for a group that
    spans the databases."""
    dbs = [mixed_db(s) for s in (0, 1, 2)]
    x = tc.make_executor(ex, device=CPU)
    eng = tc.CountingEngine(dbs[0], ex, device=CPU)
    plans = [eng.plan(p, None) for p in tc.build_lattice(dbs[0].schema, 2)]
    items = [(db, p) for p in plans for db in dbs]
    stats = [tc.CostStats() for _ in items]
    got = x.positive_batch_multi([d for d, _ in items],
                                 [p for _, p in items], stats)
    alone_stats = [tc.CostStats() for _ in items]
    want = [x.positive(d, p, st)
            for (d, p), st in zip(items, alone_stats)]
    equal_tables(got, want)
    for a, b in zip(stats, alone_stats):
        assert (a.joins, a.rows_scanned, a.ct_cells) == (
            b.joins, b.rows_scanned, b.ct_cells)
    # one group of three databases: as many launches as one database
    p = plans[-1]
    ops.reset_counts()
    x.positive(dbs[0], p)
    one = sum(ops.PLAIN_CALLS[k] for k in ("segsum_ones", "segsum_rows"))
    ops.reset_counts()
    x.positive_batch_multi(dbs, [p] * 3)
    three = sum(ops.PLAIN_CALLS[k] for k in ("segsum_ones", "segsum_rows"))
    assert len({tex.plan_stack_key(db, p) for db in dbs}) == 1
    assert three == one


@pytest.mark.parametrize("ex", JAX_EXECUTORS)
def test_positive_batch_multi_equals_jax(ex):
    jdbs = [jax_mixed_db(s) for s in (0, 1)]
    tdbs = [to_port(d) for d in jdbs]
    jeng = jc.CountingEngine(jdbs[0], ex, jc.CostStats())
    teng = tc.CountingEngine(tdbs[0], ex, device=CPU)
    points = jc.build_lattice(jdbs[0].schema, 2)
    jplans = [jeng.plan(p, None) for p in points for _ in jdbs]
    tplans = [teng.plan(point_to_port(p), None) for p in points for _ in tdbs]
    jst = [jc.CostStats() for _ in jplans]
    tst = [tc.CostStats() for _ in tplans]
    jt = jeng.executor.positive_batch_multi(jdbs * len(points), jplans, jst)
    tt = teng.executor.positive_batch_multi(tdbs * len(points), tplans, tst)
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t.counts.numpy(), np.asarray(j.counts))
    for a, b in zip(jst, tst):
        assert (a.joins, a.rows_scanned, a.ct_cells) == (
            b.joins, b.rows_scanned, b.ct_cells)


@pytest.mark.parametrize("ex", EXECUTORS)
@pytest.mark.parametrize("n", [2, 3])
def test_fanout_merges_equal_single_db(ex, n):
    """``positive_stacked_merged`` (per-shard tables and their sum) and
    ``positive_fanout_merged`` (one evaluation on the reassembled view)
    against the unsharded database, bit for bit, for every routable
    fan-out point."""
    db = mixed_db()
    sdb = tc.shard_database(db, n)
    x = tc.make_executor(ex, device=CPU)
    plans = fanout_plans(sdb, 2)
    assert plans
    want = [x.positive(db, p) for p in plans]
    per_shard, merged = x.positive_stacked_merged(
        list(sdb.shards), plans, [tc.CostStats() for _ in range(n)])
    equal_tables(merged, want)
    for s, shard in enumerate(sdb.shards):
        equal_tables(per_shard[s], [x.positive(shard, p) for p in plans])
    stats = [tc.CostStats() for _ in range(n)]
    equal_tables(x.positive_fanout_merged(list(sdb.shards), plans,
                                          sdb.partitioned, stats), want)
    for s, shard in enumerate(sdb.shards):
        alone = tc.CostStats()
        for p in plans:
            x.positive(shard, p, alone)
        assert (stats[s].joins, stats[s].rows_scanned) == (
            alone.joins, alone.rows_scanned)


def test_fanout_view_reassembles_the_database():
    db = mixed_db()
    sdb = tc.shard_database(db, 3)
    view = tc.fanout_view(sdb.shards, sdb.partitioned)
    for name, tab in db.relations.items():
        vt = view.relations[name]
        if name not in sdb.partitioned:
            assert vt is tab
            continue
        key = lambda t: sorted(zip(t.src.tolist(), t.dst.tolist(),
                                   *[t.attrs[a].tolist()
                                     for a in sorted(t.attrs)]))
        assert key(vt) == key(tab)
    assert view.entities is db.entities
    view.validate()


@pytest.mark.parametrize("name,n", [("UW", 2), ("Mondial", 3),
                                    ("mixed", 2)])
def test_stack_keys_equal_jax(name, n):
    """``plan_stack_key`` per shard and ``fanout_stack_key`` over the
    shards: the JAX package's keys (the groups a flood stacks into)."""
    jdb, tdb = ((jax_mixed_db(), mixed_db()) if name == "mixed"
                else both(name))
    jsdb, tsdb = jc.shard_database(jdb, n), tc.shard_database(tdb, n)
    jeng = jc.CountingEngine(jsdb.shards[0], "sparse", jc.CostStats())
    teng = tc.CountingEngine(tsdb.shards[0], "sparse", device=CPU)
    for p in jc.build_lattice(jdb.schema, 2):
        try:
            jsdb.route(p)
        except jc.NotRoutableError:
            continue
        jp, tp = jeng.plan(p, None), teng.plan(point_to_port(p), None)
        assert tex.fanout_stack_key(tsdb.shards, tp, tsdb.partitioned) == \
            jex.fanout_stack_key(jsdb.shards, jp, jsdb.partitioned)
        for js, ts in zip(jsdb.shards, tsdb.shards):
            assert tex.plan_stack_key(ts, tp) == jex.plan_stack_key(js, jp)


def test_positive_fanout_merged_reads_the_written_shards():
    """A write to the shards moves the next fan-out evaluation: its table
    is the written single database's."""
    db = mixed_db()
    sdb = tc.shard_database(db, 2)
    x = tc.make_executor("sparse", device=CPU)
    plan = fanout_plans(sdb, 1)[0]
    (before,) = x.positive_fanout_merged(list(sdb.shards), [plan],
                                         sdb.partitioned)
    equal_tables([before], [x.positive(db, plan)])
    r0 = db.relations["R0"]
    src, dst = r0.src[:2].copy(), r0.dst[:2].copy()
    sdb.delete_facts("R0", src, dst)
    db.delete_facts("R0", src, dst)
    (after,) = x.positive_fanout_merged(list(sdb.shards), [plan],
                                        sdb.partitioned)
    equal_tables([after], [x.positive(db, plan)])
    assert not np.array_equal(after.counts.numpy(), before.counts.numpy())
