"""Positive ct-tables of the port's executors against the JAX package's.

Counts are integers in float32 below 2^24, so the port must equal the JAX
package exactly (and the oracle) for every plan, on both executors.
"""

import itertools

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.oracle import oracle_ct
from repro_torch.kernels import ops
from tests.test_engine_equivalence import random_db
from tests.test_torch_data import keep_to_port, point_to_port, to_port

CPU = "cpu"
EXECUTORS = ("dense", "sparse")


def _keeps(rng, point, schema):
    pool = list(point.all_ct_vars(schema, include_rind=False))
    keeps = [tuple(pool), ()]
    for _ in range(2):
        k = int(rng.integers(1, len(pool) + 1))
        pick = rng.choice(len(pool), size=k, replace=False)
        keeps.append(tuple(pool[i] for i in sorted(pick)))
    return keeps


@pytest.mark.parametrize("seed,ex", list(itertools.product(range(5),
                                                           EXECUTORS)))
def test_positive_equals_jax_every_plan(seed, ex):
    jdb = random_db(seed)
    tdb = to_port(jdb)
    rng = np.random.default_rng(seed)
    jeng = jc.CountingEngine(jdb, ex, jc.CostStats())
    teng = tc.CountingEngine(tdb, ex, tc.CostStats(), device=CPU)
    for point in jc.build_lattice(jdb.schema, 2):
        for keep in _keeps(rng, point, jdb.schema):
            want = jeng.contract(point, keep)
            got = teng.contract(point_to_port(point), keep_to_port(keep))
            assert got.vars == keep_to_port(want.vars)
            assert got.counts.dtype == torch.float32
            np.testing.assert_array_equal(got.counts.numpy(),
                                          np.asarray(want.counts))
            np.testing.assert_array_equal(
                got.counts.numpy(),
                oracle_ct(jdb, point, keep, require_positive=True))
    assert teng.stats.joins == jeng.stats.joins
    assert teng.stats.rows_scanned == jeng.stats.rows_scanned
    assert teng.stats.ct_cells == jeng.stats.ct_cells


@pytest.mark.parametrize("ex", EXECUTORS)
def test_hist_and_leaf_hop_equal_jax(ex):
    jdb = random_db(3)
    tdb = to_port(jdb)
    jx = jc.make_executor(ex)
    tx = tc.make_executor(ex, device=CPU)
    schema = jdb.schema
    for et in schema.entities:
        v = jc.Var(et.name)
        attrs = tuple(jc.attr_var(v, a.name, a.card) for a in et.attrs)
        for keep in (attrs, attrs[:1], ()):
            want = jx.hist(jdb, v, keep)
            got = tx.hist(tdb, tc.Var(et.name), keep_to_port(keep))
            np.testing.assert_array_equal(got.counts.numpy(),
                                          np.asarray(want.counts))
    point = jc.build_lattice(schema, 1)[0]
    atom = point.atoms[0]
    rel = schema.relationship(atom.rel)
    cattrs = tuple(jc.attr_var(atom.src, a.name, a.card)
                   for a in schema.entity(atom.src.etype).attrs)
    eattrs = tuple(jc.edge_var(rel.name, a.name, a.card) for a in rel.attrs)
    m, mvars = jx.leaf_hop(jdb, atom, atom.src, atom.dst, cattrs, eattrs)
    tatom = point_to_port(point).atoms[0]
    tm, tvars = tx.leaf_hop(tdb, tatom, tatom.src, tatom.dst,
                            keep_to_port(cattrs), keep_to_port(eattrs))
    assert tuple(tvars) == keep_to_port(mvars)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(m))


def test_three_atom_points_take_the_dense_message_hop():
    """Every 3-atom point of the VisualGenome stand-in nests a hop under
    the root, so the sparse executor runs its dense-message hop (K2 rows)
    on top of the root combine; counts equal the JAX package's."""
    jdb = jc.paper_benchmark_db("VisualGenome", 0, scale=0.001)
    tdb = tc.paper_benchmark_db("VisualGenome", 0, scale=0.001)
    points = [p for p in jc.build_lattice(jdb.schema, 3) if p.length == 3]
    assert len(points) == 32
    jeng = {ex: jc.CountingEngine(jdb, ex, jc.CostStats())
            for ex in EXECUTORS}
    teng = {ex: tc.CountingEngine(tdb, ex, tc.CostStats(), device=CPU)
            for ex in EXECUTORS}
    for point in points:
        tp = point_to_port(point)
        plan = tc.compile_plan(tdb.schema, tp)
        assert any(h.child_node.hops for h in plan.root.hops)
        want = np.asarray(jeng["sparse"].contract(point).counts)
        for ex in EXECUTORS:
            before = ops.PLAIN_CALLS["segsum_rows"]
            got = teng[ex].contract(tp).counts.numpy()
            calls = ops.PLAIN_CALLS["segsum_rows"] - before
            # sparse: nested hop + root combine; dense: one per hop
            assert calls >= (2 if ex == "sparse" else 3), (ex, calls)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            want, np.asarray(jeng["dense"].contract(point).counts))


def test_sparse_overflow_guard_matches_jax():
    """Both packages refuse a sparse hop whose segment space exceeds
    int32, alike."""
    n, card = 3000, 1000        # parent segments 3000 * 1000 * 1000 > 2^31
    schema_args = dict(
        entities=[("A", n, [("a", card)]), ("B", n, [("b", card)])],
        relationships=[("R", "A", "B", [("e", card - 1)])])
    rng = np.random.default_rng(0)
    ents = {"A": {"a": rng.integers(0, card, n)},
            "B": {"b": rng.integers(0, card, n)}}
    rels = {"R": (np.arange(5), np.arange(5), {"e": np.zeros(5)})}
    tdb = tc.db_from_arrays(schema_args, ents, rels)
    jschema = jc.Schema(
        (jc.EntityType("A", n, (jc.Attribute("a", card),)),
         jc.EntityType("B", n, (jc.Attribute("b", card),))),
        (jc.Relationship("R", "A", "B", (jc.Attribute("e", card - 1),)),))
    jdb = jc.RelationalDB(
        jschema,
        {n: jc.database.EntityTable(jschema.entity(n), {
            k: v.astype(np.int32) for k, v in ents[n].items()})
         for n in ents},
        {"R": jc.database.RelationTable(
            jschema.relationship("R"), np.arange(5, dtype=np.int32),
            np.arange(5, dtype=np.int32), {"e": np.zeros(5, np.int32)})})
    point = jc.build_lattice(jschema, 1)[0]
    with pytest.raises(OverflowError):
        jc.CountingEngine(jdb, "sparse").contract(point)
    with pytest.raises(OverflowError):
        tc.CountingEngine(tdb, "sparse", device=CPU).contract(
            point_to_port(point))
