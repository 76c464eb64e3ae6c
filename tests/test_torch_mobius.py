"""The port's Möbius join against the JAX package's and the oracle.

Mirrors ``tests/test_mobius_batch.py``: the transform (per stack, batched,
fused), the assembly (``complete_ct`` and ``complete_ct_many`` in both
evaluation orders, including ``k == 0`` keeps and card-1 domains), and
exact equality with the JAX package's complete tables.
"""

import itertools

import jax  # noqa: F401
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.engine import OnDemandPositives as JaxOnDemand
from repro.core.oracle import oracle_ct
from repro_torch.core.engine import OnDemandPositives
from tests.test_counting_core import tiny_db
from tests.test_engine_equivalence import random_db
from tests.test_executor_edge_cases import edge_case_db
from tests.test_serve import mixed_db
from tests.test_torch_data import keep_to_port, point_to_port, to_port

CPU = "cpu"
EXECUTORS = ("dense", "sparse")


def _random_stacks(rng, b, k, attr_shape):
    return [rng.integers(0, 50, size=(2,) * k + attr_shape)
            .astype(np.float32) for _ in range(b)]


# ------------------------------------------------------------ transform ----

@pytest.mark.parametrize("b,k,attr_shape", [
    (1, 1, (3,)), (2, 2, (3, 2)), (3, 1, ()), (5, 3, (4,)), (8, 2, (2, 1)),
    (2, 0, (3,)),
])
def test_transforms_equal_jax(b, k, attr_shape):
    rng = np.random.default_rng(b * 10 + k)
    stacks = _random_stacks(rng, b, k, attr_shape)
    want = [np.asarray(jc.superset_mobius(jnp.asarray(s), k)) for s in stacks]
    ex = tc.make_executor("sparse", device=CPU)
    ts = [torch.from_numpy(s) for s in stacks]
    for got in ([tc.superset_mobius(s, k) for s in ts],
                tc.butterfly_batch(ts, k),
                [ex.mobius(s, k) for s in ts],
                ex.mobius_batch(ts, k)):
        assert len(got) == b
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), w)
    # the fused step: raw blocks in, request layout out
    perm = tuple(range(k + len(attr_shape)))[::-1]
    blocks = [[torch.tensor(s.reshape((1 << k,) + attr_shape)[i])
               for i in range(1 << k)] for s in stacks]
    for w, g in zip(want, ex.mobius_batch_fused(blocks, k, perm)):
        np.testing.assert_array_equal(g.numpy(), np.transpose(w, perm))
    assert ex.mobius_batch([], k) == []
    assert ex.mobius_batch_fused([], k, perm) == []


# ------------------------------------------------------------- assembly ----

def _queries(rng, lattice, schema, n_random):
    queries = []
    for point in (lattice[0], lattice[-1]):
        pool = list(point.all_ct_vars(schema, include_rind=True))
        queries.append((point, tuple(pool)))
        queries.append((point, ()))                               # k == 0
        queries.append((point, tuple(v for v in pool if v.kind == "attr")))
        for _ in range(n_random):
            k = int(rng.integers(1, len(pool) + 1))
            pick = rng.choice(len(pool), size=k, replace=False)
            queries.append((point, tuple(pool[i] for i in sorted(pick))))
    return queries


@pytest.mark.parametrize("ex,use_butterfly",
                         list(itertools.product(EXECUTORS, (True, False))))
def test_complete_ct_many_equals_jax_and_oracle(ex, use_butterfly):
    jdb = mixed_db()
    tdb = to_port(jdb)
    lattice = jc.build_lattice(jdb.schema, 2)
    queries = _queries(np.random.default_rng(5), lattice, jdb.schema, 4)
    tqueries = [(point_to_port(p), keep_to_port(k)) for p, k in queries]

    teng = tc.CountingEngine(tdb, ex, tc.CostStats(), device=CPU)
    policy = OnDemandPositives(teng)
    fused = tc.complete_ct_many(
        tqueries, policy, use_butterfly=use_butterfly,
        mobius_fn=teng.executor.mobius,
        mobius_fused_fn=teng.executor.mobius_batch_fused)
    unfused = tc.complete_ct_many(
        tqueries, policy, use_butterfly=use_butterfly,
        mobius_batch_fn=teng.executor.mobius_batch)
    jeng = jc.CountingEngine(jdb, ex, jc.CostStats())
    jpolicy = JaxOnDemand(jeng)
    for (point, keep), (tp, tk), f, u in zip(queries, tqueries, fused,
                                             unfused):
        single = tc.complete_ct(tp, tk, policy, use_butterfly=use_butterfly,
                                mobius_fn=teng.executor.mobius)
        want = jc.complete_ct(point, keep, jpolicy,
                              use_butterfly=use_butterfly)
        for got in (f, u, single):
            assert got.vars == tk
            np.testing.assert_array_equal(got.counts.numpy(),
                                          np.asarray(want.counts))
        np.testing.assert_array_equal(f.counts.numpy(),
                                      oracle_ct(jdb, point, keep))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_complete_ct_family_keeps_match_oracle(seed):
    """Family-style keeps on tiny_db, blockwise and butterfly, including
    kept edge attributes with and without their indicator."""
    jdb = tiny_db(seed)
    tdb = to_port(jdb)
    point = jc.build_lattice(jdb.schema, 2)[-1]
    pool = list(point.all_ct_vars(jdb.schema, include_rind=True))
    rng = np.random.default_rng(seed)
    keeps = [tuple(pool)] + [
        tuple(pool[i] for i in sorted(rng.choice(len(pool), size=int(k),
                                                 replace=False)))
        for k in rng.integers(1, 5, size=6)]
    teng = tc.CountingEngine(tdb, "sparse", tc.CostStats(), device=CPU)
    policy = OnDemandPositives(teng)
    for keep in keeps:
        want = oracle_ct(jdb, point, keep)
        for ub in (True, False):
            got = tc.complete_ct(point_to_port(point), keep_to_port(keep),
                                 policy, use_butterfly=ub,
                                 mobius_fn=teng.executor.mobius)
            np.testing.assert_array_equal(got.counts.numpy(), want)


@pytest.mark.parametrize("ex", EXECUTORS)
def test_card1_domains_and_empty_relation(ex):
    jdb = edge_case_db()
    tdb = to_port(jdb)
    point = jc.build_lattice(jdb.schema, 2)[-1]
    pool = list(point.all_ct_vars(jdb.schema, include_rind=True))
    keeps = [tuple(pool), (), tuple(v for v in pool if v.kind == "attr"),
             tuple(v for v in pool if v.kind in ("attr", "rind"))]
    teng = tc.CountingEngine(tdb, ex, tc.CostStats(), device=CPU)
    got = tc.complete_ct_many(
        [(point_to_port(point), keep_to_port(k)) for k in keeps],
        OnDemandPositives(teng), mobius_fn=teng.executor.mobius,
        mobius_fused_fn=teng.executor.mobius_batch_fused)
    for keep, g in zip(keeps, got):
        np.testing.assert_array_equal(g.counts.numpy(),
                                      oracle_ct(jdb, point, keep))


def test_positive_queries_equal_jax():
    jdb = random_db(1)
    point = jc.build_lattice(jdb.schema, 2)[-1]
    pool = list(point.all_ct_vars(jdb.schema, include_rind=True))
    for keep in (tuple(pool), tuple(pool[:3]), ()):
        for ub in (True, False):
            want = jc.positive_queries(point, keep, ub)
            got = tc.positive_queries(point_to_port(point),
                                      keep_to_port(keep), ub)
            assert got == [(point_to_port(p), keep_to_port(k))
                           for p, k in want]
