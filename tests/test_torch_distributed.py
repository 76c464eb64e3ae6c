"""The port's mesh sharding (``repro_torch.core.distributed``,
``repro_torch.launch``) on the CPU, held to the JAX package's single-device
counting, the port's and the oracle with ``atol=0``.

The test process is rank 0 (the controller); a module-scoped fixture spawns
``WORLD - 1`` gloo workers once, which serve its sharded steps, and stops
them at teardown.  The JAX package's own mesh tests fail under its jax
(``tests/test_distributed_counting.py``: sharding-in-types checks, ROADMAP
"Facts about the reference"), so its mesh path is no reference here; its
contract is that sharded counting is numerically identical to
``SparseExecutor``.

The tests before the fixture's first use run with no group: the world of
one, the launcher as a group of one, and the planted faults (each in a
group of two of its own).
"""

import time

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.core as jc
import repro_torch.core as tc
from repro_torch.core import distributed as D
from repro_torch.core.oracle import oracle_ct
from repro_torch.core.plan import compile_plan
from repro_torch.launch import discover as launcher
from repro_torch.launch.mesh import (init_group, make_local_mesh,
                                     serve_main, spawn_ranks, stop_spawned)
from repro_torch.serve import CountingRouter, CountingService
from tests import torch_dist_workers as planted
from tests.test_counting_core import tiny_db as jax_tiny_db
from tests.test_engine_equivalence import random_db as jax_random_db
from tests.test_engine_equivalence import random_keeps
from tests.test_mutations import random_delete, random_insert
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import cv_to_port, point_to_port, to_port

CPU = "cpu"
WORLD = 4
TIMEOUT_S = 120.0            # the fixture's group: a missed collective raises


def mixed_db(seed: int = 0):
    return to_port(jax_mixed_db(seed))


def positives(jdb):
    """``(port db, [(port point, port keep, JAX table)])`` over every
    lattice point of chains <= 2, all attributes kept (positives only)."""
    out = []
    for jp in jc.build_lattice(jdb.schema, 2):
        jkeep = jp.all_ct_vars(jdb.schema, include_rind=False)
        jtab = jc.SparseExecutor().positive(
            jdb, jc.compile_plan(jdb.schema, jp, jkeep))
        out.append((point_to_port(jp), tuple(map(cv_to_port, jkeep)), jtab))
    return to_port(jdb), out


def equal_table(got, jtab):
    """A port table equals a JAX table cell for cell (``atol=0``)."""
    want_vars = tuple(map(cv_to_port, jtab.vars))
    got = got.transpose_to(want_vars) if tuple(got.vars) != want_vars \
        else got
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(jtab.counts))


def plans_of(db, length=2):
    return [compile_plan(db.schema, p, p.all_ct_vars(db.schema,
                                                     include_rind=False))
            for p in tc.build_lattice(db.schema, length)]


# ---------------------------------------------------- no group: world 1 --

def test_world_one_is_the_single_device_executor():
    assert not dist.is_initialized()
    assert tc.EXECUTORS["sparse_sharded"] is tc.ShardedSparseExecutor
    ex = tc.make_executor("sparse_sharded", device=CPU)
    assert ex.n_ranks == 1 and ex.mesh is None
    db = mixed_db()
    ref = tc.SparseExecutor(device=CPU)
    plans = plans_of(db)
    for got, want in zip([ex.positive(db, p) for p in plans]
                         + ex.positive_batch(db, plans),
                         [ref.positive(db, p) for p in plans] * 2):
        assert got.vars == want.vars
        assert torch.equal(got.counts, want.counts)
    assert ex.step_counts == {}
    stacked = torch.arange(24, dtype=torch.float32).reshape(3, 2, 4)
    assert torch.equal(D.merge_stacked(stacked), torch.sum(stacked, dim=0))


def test_launcher_at_world_one_prints_hybrid_models(capsys):
    assert not dist.is_initialized()
    assert launcher.main(["--db", "UW", "--scale", "0.25",
                          "--device", CPU]) == 0
    assert not dist.is_initialized()           # it left its group of one
    out = capsys.readouterr().out
    db = tc.paper_benchmark_db("UW", scale=0.25)
    models, _ = tc.discover_model(
        db, tc.make_strategy("HYBRID", executor="sparse", device=CPU),
        max_chain_length=2, max_parents=2, device=CPU)
    want = launcher.model_lines(models)
    assert want and [line for line in out.splitlines()
                     if line.startswith("  [")] == want
    assert "mesh {'data': 1, 'model': 1}" in out


def planted_group(tmp_path, target, timeout_s: float):
    """A group of two: this process and one planted worker."""
    path = str(tmp_path / "group")
    procs = spawn_ranks(2, path, CPU, timeout_s=timeout_s, target=target)
    init_group(0, 2, path, timeout_s=timeout_s)
    return procs


def test_planted_worker_skipping_its_slice_is_seen(tmp_path):
    procs = planted_group(tmp_path, planted.skipping_worker, 60.0)
    try:
        db, ref = mixed_db(), tc.SparseExecutor(device=CPU)
        differ = [not torch.equal(
            D.sharded_sparse_positive_ct(db, plan.point, plan.keep,
                                         device=CPU).counts,
            ref.positive(db, plan).counts) for plan in plans_of(db)]
    finally:
        stop_spawned(procs, CPU)
    assert all(differ), differ        # every table lost the worker's half


def test_planted_worker_raising_fails_the_controller(tmp_path):
    timeout_s = 30.0
    procs = planted_group(tmp_path, planted.raising_worker, timeout_s)
    db = mixed_db()
    plan = plans_of(db)[0]
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError):
            D.sharded_sparse_positive_ct(db, plan.point, plan.keep,
                                         device=CPU)
        assert time.monotonic() - t0 < timeout_s
        assert not dist.is_initialized()     # the failed step destroyed it
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        procs[0].join(timeout_s)
        if procs[0].is_alive():
            procs[0].kill()
    assert procs[0].exitcode not in (0, None)


def test_failure_on_the_controller_destroys_the_group(tmp_path,
                                                      monkeypatch):
    """Rank 0's own step raises after the scatter, with the worker waiting
    in the reduction: the step destroys the group, so a later step raises
    at once (it cannot pair its collectives with the worker's), and the
    worker's reduction fails."""
    timeout_s = 30.0
    procs = planted_group(tmp_path, serve_main, timeout_s)
    db = mixed_db()
    plan = plans_of(db)[0]
    ex = tc.ShardedSparseExecutor(device=CPU)
    assert ex.n_ranks == 2

    def boom(params, xs, dev):
        raise RuntimeError("planted: rank 0 failed in its step")
    for op in planted.COUNTING_STEPS:
        monkeypatch.setitem(D._STEPS, op, boom)
    t0 = time.monotonic()
    try:
        with pytest.raises(RuntimeError, match="planted"):
            D.sharded_sparse_positive_ct(db, plan.point, plan.keep,
                                         device=CPU)
        assert not dist.is_initialized()
        with pytest.raises(RuntimeError, match="no process group"):
            ex.positive(db, plan)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        procs[0].join(timeout_s)
        if procs[0].is_alive():
            procs[0].kill()
    assert time.monotonic() - t0 < timeout_s
    assert procs[0].exitcode not in (0, None)


# ------------------------------------------- a group of WORLD CPU ranks --

@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """This process as rank 0 of ``WORLD`` gloo ranks; the others serve."""
    path = str(tmp_path_factory.mktemp("group") / "store")
    procs = spawn_ranks(WORLD, path, CPU, timeout_s=TIMEOUT_S)
    init_group(0, WORLD, path, timeout_s=TIMEOUT_S)
    yield make_local_mesh()
    stop_spawned(procs, CPU)


def test_sharded_sparse_equals_single_device_jax_and_oracle(ranks):
    db, cases = positives(jax_mixed_db(0))
    ref = tc.SparseExecutor(device=CPU)
    ex = tc.ShardedSparseExecutor(device=CPU)
    assert ex.n_ranks == WORLD
    for point, keep, jtab in cases:
        got = D.sharded_sparse_positive_ct(db, point, keep, device=CPU)
        equal_table(got, jtab)
        plan = compile_plan(db.schema, point, keep)
        assert torch.equal(got.counts, ref.positive(db, plan).counts)
        assert torch.equal(got.counts, ex.positive(db, plan).counts)
        np.testing.assert_array_equal(
            got.counts.numpy(), oracle_ct(db, point, got.vars,
                                          require_positive=True))
    assert ex.step_counts and all(k[0] in ("edge_ones", "edge_dense",
                                           "reduce_ones", "reduce_kr")
                                  for k in ex.step_counts)


@pytest.mark.parametrize("rels", (["Reg"], ["Reg", "RA"]))
def test_sharded_dense_on_data_and_model_equals_jax(ranks, rels):
    jdb = jax_tiny_db(4)
    jp = jc.point_from_rels(jdb.schema, rels)
    jkeep = jp.all_ct_vars(jdb.schema, include_rind=False)
    want = jc.positive_ct(jdb, jp, jkeep)
    mesh = make_local_mesh(2)
    assert tuple(mesh.mesh.shape) == (WORLD // 2, 2)
    got = D.sharded_positive_ct(to_port(jdb), point_to_port(jp),
                                tuple(map(cv_to_port, jkeep)), mesh=mesh,
                                device=CPU)
    equal_table(got, want)


def test_superset_mobius_sharded_equals_jax(ranks):
    x = np.arange(2 * 2 * 16, dtype=np.float32).reshape(2, 2, 16)
    got = D.superset_mobius_sharded(torch.from_numpy(x), 2,
                                    mesh=make_local_mesh(2))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jc.superset_mobius(jnp.asarray(x), 2)))


@pytest.mark.parametrize("sname", sorted(tc.STRATEGIES))
@pytest.mark.parametrize("seed", (0, 1))
def test_every_strategy_over_the_ranks_equals_oracle(ranks, sname, seed):
    db = to_port(jax_random_db(seed))
    rng = np.random.default_rng(seed + 50)
    lattice = tc.build_lattice(db.schema, 2)
    point = lattice[-1]
    keeps = random_keeps(rng, point, db.schema)
    plain = tc.make_strategy("ONDEMAND", executor="sparse", device=CPU)
    plain.prepare(db, lattice)
    ex = tc.ShardedSparseExecutor(device=CPU)
    st = tc.make_strategy(sname, executor=ex, device=CPU)
    st.prepare(db, lattice)
    for keep in keeps:
        got = st.family_ct(point, keep).counts.numpy()
        np.testing.assert_array_equal(got, oracle_ct(db, point, keep))
        np.testing.assert_array_equal(
            got, plain.family_ct(point, keep).counts.numpy())
    assert ex.step_counts


def test_delta_rounds_issue_no_sharded_step(ranks):
    db = to_port(jax_random_db(0))
    lattice = tc.build_lattice(db.schema, 2)
    ex = tc.ShardedSparseExecutor(device=CPU)
    st = tc.make_strategy("HYBRID", executor=ex, device=CPU)
    st.prepare(db, lattice)
    point = lattice[-1]
    keep = point.all_ct_vars(db.schema, include_rind=True)
    st.family_ct(point, keep)
    rng = np.random.default_rng(5)
    rel = sorted(point.rels)[0]
    rounds = 0
    for delta in [random_insert(db, rel, 2, rng)] + [None] * 2:
        if delta is None:
            delta = random_delete(db, rel, 1, rng)
        steps = dict(ex.step_counts)
        rep = st.apply_delta(delta)
        assert ex.step_counts == steps             # local_mode: no step
        assert rep.updated + rep.invalidated > 0, rep
        np.testing.assert_array_equal(
            st.family_ct(point, keep).counts.numpy(),
            oracle_ct(db, point, keep))
        rounds += 1
    assert rounds == 3


def test_second_pass_adds_the_same_steps_per_plan(ranks):
    db = mixed_db()
    ex = tc.ShardedSparseExecutor(device=CPU)
    plans = plans_of(db)

    def one_pass():
        added = []
        for plan in plans:
            before = dict(ex.step_counts)
            ex.positive(db, plan)
            added.append({k: v - before.get(k, 0)
                          for k, v in ex.step_counts.items()
                          if v != before.get(k, 0)})
        return added

    first = one_pass()
    assert all(first)
    assert one_pass() == first
    # the batch paths run plan by plan: the same steps again
    before = dict(ex.step_counts)
    ex.positive_batch(db, plans)
    assert {k: v - before.get(k, 0) for k, v in ex.step_counts.items()} == {
        k: sum(a.get(k, 0) for a in first) for k in ex.step_counts}


def test_router_over_sharded_executors_equals_single_database(ranks):
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    queries = [(p, None) for p in lattice]
    router = CountingRouter(tc.shard_database(db, 2),
                            executor="sparse_sharded", device=CPU)
    single = CountingService(tc.CountingEngine(db, "sparse", device=CPU))
    try:
        got = router.complete_many(queries)
        want = single.complete_many(queries)
        assert all(e.executor.n_ranks == WORLD and e.executor.step_counts
                   for e in router.engines)
    finally:
        router.shutdown(timeout=60)
        single.shutdown(timeout=60)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.vars == w.vars
        assert torch.equal(g.counts, w.counts)


@pytest.mark.parametrize("n", (2, WORLD, WORLD + 1))
def test_merge_stacked_equals_torch_sum(ranks, n):
    """One stacked sum with a group of any size: the controller holds
    every partial, so the merge issues no collective."""
    x = torch.from_numpy(np.random.default_rng(n).integers(
        0, 1000, size=(n, 3, 5)).astype(np.float32))
    assert torch.equal(D.merge_stacked(x), torch.sum(x, dim=0))


def test_kernel_counts_come_from_every_rank(ranks):
    D.reset_rank_counts(CPU)
    db = mixed_db()
    for plan in plans_of(db, 1):
        D.sharded_sparse_positive_ct(db, plan.point, plan.keep, device=CPU)
    counts = D.rank_counts(CPU)
    assert len(counts) == WORLD
    # on the CPU every rank's steps take the plain versions
    assert all(c["plain_calls"]["segsum_ones"] > 0
               and not any(c["launches"].values()) for c in counts)


def test_steps_from_many_threads_keep_their_collectives_apart(ranks):
    """Eight threads drive sharded steps at once under a short switch
    interval: the group lock keeps each step's header, scatter and
    reduction together, so every table is still exact."""
    import sys
    import threading
    db = mixed_db()
    plans = plans_of(db)
    ref = tc.SparseExecutor(device=CPU)
    want = [ref.positive(db, p).counts for p in plans]
    bad, done = [], []

    def client(i: int) -> None:
        ex = tc.ShardedSparseExecutor(device=CPU)
        for _ in range(3):
            for j, plan in enumerate(plans[i % 2::2]):
                got = ex.positive(db, plan).counts
                if not torch.equal(got, want[(i % 2) + 2 * j]):
                    bad.append((i, j))
        done.append(i)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT_S)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in threads)
    assert sorted(done) == list(range(8)) and not bad
