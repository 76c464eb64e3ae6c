"""The port's versioned store and delta count maintenance, against its own
oracle and against the JAX package.

Mirrors the in-process half of ``tests/test_mutations.py`` (round trip and
versions, rejected writes, delta-view linearity, the interleaving property
for every strategy x executor, stale deltas, in-place ``"fam"`` /
``"complete"`` updates, attribute writes, untouched relations, stamps, the
threshold fallback), then holds the port to the JAX package: the same
seeded writes on both stores give equal ``DeltaReport``s and resident
caches equal bit for bit (counts are integers below 2^24 here, so every
order of summation is exact: tolerance 0).  Last, the recount comparison
that ``chip_smoke.py`` phase 13 runs on the card is shown to fail on a
delta applied with its sign flipped and on a skipped ``"fam"`` update.
"""

import dataclasses
import itertools
import zlib

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from chip_smoke import recount_entries
from repro.core.engine import (CountingEngine as JaxEngine,
                               _DeltaPositives as JaxDeltaPositives)
from repro.core.mobius import complete_ct_delta_many as jax_delta_many
from repro_torch.core import engine as tengine
from repro_torch.core.database import AttrDelta
from repro_torch.core.engine import _DeltaPositives, key_deps
from repro_torch.core.mobius import butterfly_delta, complete_ct_delta_many
from repro_torch.core.oracle import oracle_ct
from tests.test_mutations import (fresh_pairs, random_attr_write,
                                  random_delete, random_insert)
from tests.test_serve import mixed_db as jax_mixed_db
from tests.test_torch_data import (keep_to_port, point_to_port, to_port,
                                   var_to_port)

CPU = "cpu"
STRATEGIES = sorted(tc.STRATEGIES)
EXECUTORS = sorted(tc.EXECUTORS)
ALL_COMBOS = list(itertools.product(STRATEGIES, EXECUTORS))


def mixed_db(seed: int = 0):
    """``tests.test_serve.mixed_db`` carried across to the port."""
    return to_port(jax_mixed_db(seed))


def seed_of(*names) -> int:
    return zlib.crc32("/".join(names).encode())


def strategy(name, db, lattice, ex="sparse"):
    st = tc.make_strategy(name, executor=ex, device=CPU)
    st.prepare(db, lattice)
    return st


def warm_families(st, db, lattice):
    for p in lattice:
        st.family_ct(p, tuple(p.all_ct_vars(db.schema, include_rind=True)))


# ------------------------------------------------------ versioned store ----

def test_insert_delete_roundtrip_and_versions():
    db = mixed_db()
    rng = np.random.default_rng(0)
    assert db.version == 0
    d = random_insert(db, "R0", 3, rng)
    assert d.op == "insert" and d.num_edges == 3 and d.sign == 1
    assert (d.old_version, d.new_version) == (0, 1) and db.version == 1
    db.validate()
    d2 = db.delete_facts("R0", d.src, d.dst)
    assert d2.op == "delete" and d2.sign == -1
    assert d2.num_edges == 3 and db.version == 2
    # deleted edges carry the attribute values they had
    np.testing.assert_array_equal(d2.attrs["e0"], d.attrs["e0"])
    db.validate()
    # empty batches are no-ops, not version bumps
    assert db.insert_facts("R0", [], [], {"e0": []}) is None
    assert db.delete_facts("R0", [], []) is None
    assert db.update_attrs("A", [], {"a0": []}) is None
    assert db.version == 2
    a = db.update_attrs("A", [4, 1], {"a1": [1, 0]})
    assert isinstance(a, AttrDelta) and a.num_rows == 2 and a.attrs == ("a1",)
    assert a.dep_tags() == frozenset({("attr", "A", "a1"), ("attr*", "A")})
    np.testing.assert_array_equal(db.entities["A"].attrs["a1"][[4, 1]],
                                  [1, 0])
    assert (a.old_version, a.new_version) == (2, 3) and db.version == 3


def test_bad_writes_rejected():
    db = mixed_db()
    tab = db.relations["R0"]
    s0, d0 = int(tab.src[0]), int(tab.dst[0])
    with pytest.raises(ValueError):          # duplicate pair
        db.insert_facts("R0", [s0], [d0], {"e0": [0]})
    with pytest.raises(ValueError):          # missing attr column
        db.insert_facts("R0", [0], [0], None)
    with pytest.raises(ValueError):          # attr out of range
        db.insert_facts("R0", [8], [6], {"e0": [99]})
    with pytest.raises(ValueError):          # index out of range
        db.insert_facts("R0", [1000], [0], {"e0": [0]})
    with pytest.raises(ValueError):          # the same new pair twice
        src, dst = fresh_pairs(db, "R0", 1, np.random.default_rng(0))
        db.insert_facts("R0", np.repeat(src, 2), np.repeat(dst, 2),
                        {"e0": [0, 1]})
    with pytest.raises(ValueError):          # deleting a missing edge
        db.delete_facts("R1", [1000], [1000])
    with pytest.raises(ValueError):          # deleting one edge twice
        db.delete_facts("R1", np.repeat(db.relations["R1"].src[:1], 2),
                        np.repeat(db.relations["R1"].dst[:1], 2))
    with pytest.raises(ValueError):          # unknown attribute
        db.update_attrs("A", [0], {"nope": [0]})
    with pytest.raises(ValueError):          # duplicate rows
        db.update_attrs("A", [0, 0], {"a0": [0, 1]})
    with pytest.raises(ValueError):          # value out of range
        db.update_attrs("A", [0], {"a1": [2]})
    with pytest.raises(KeyError):
        db.insert_facts("R9", [0], [0], {})
    assert db.version == 0                   # nothing was applied
    db.validate()


def test_delta_view_shares_entity_tables():
    db = mixed_db()
    d = random_insert(db, "R0", 2, np.random.default_rng(7))
    view = d.as_db(db)
    assert view.entities is db.entities      # zero copies
    assert view.schema is db.schema and view.version == db.version
    assert view.relations["R0"].src is d.src
    assert view.relations["R1"] is db.relations["R1"]
    assert db.relations["R0"].num_edges == 16   # the store is untouched


@pytest.mark.parametrize("ex", EXECUTORS)
def test_delta_view_is_linear(ex):
    """positive(db after) - positive(db before) == positive(delta view):
    the multilinearity the delta path relies on (exact: counts are small
    integers)."""
    db = mixed_db()
    rng = np.random.default_rng(1)
    eng = tc.CountingEngine(db, ex, tc.CostStats(), device=CPU)
    points = [p for p in tc.build_lattice(db.schema, 2) if "R0" in p.rels]
    for p in points:
        before = eng.contract(p, None).counts
        delta = random_insert(db, "R0", 4, rng)
        after = eng.contract(p, None).counts
        dtab = eng.executor.positive(delta.as_db(db), eng.plan(p, None))
        assert torch.equal(after - before, dtab.counts), str(p)


# --------------------------------------------------- interleaving property --

@pytest.mark.parametrize("sname,ex", ALL_COMBOS)
def test_interleaved_mutations_match_oracle(sname, ex):
    """Random interleavings of inserts/deletes/attribute writes and
    family queries stay oracle-exact for every strategy x executor."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    rels = sorted(db.relations)
    etypes = sorted(db.entities)
    points = lattice[:2] + lattice[-2:]
    rng = np.random.default_rng(seed_of(sname, ex))
    st = strategy(sname, db, lattice, ex)

    def check_all():
        for p in points:
            pool = list(p.all_ct_vars(db.schema, include_rind=True))
            pick = rng.choice(len(pool),
                              size=int(rng.integers(1, len(pool) + 1)),
                              replace=False)
            keep = tuple(pool[i] for i in sorted(pick))
            got = st.family_ct(p, keep)
            want = oracle_ct(db, p, keep)
            np.testing.assert_array_equal(
                got.counts.numpy(), want,
                err_msg=f"{sname}/{ex} v={db.version} {p} "
                        f"keep={[str(v) for v in keep]}")

    check_all()                                  # warm the caches
    for step in range(7):
        roll = rng.random()
        if roll < 0.25:
            etype = etypes[int(rng.integers(len(etypes)))]
            delta = random_attr_write(db, etype, int(rng.integers(1, 4)),
                                      rng)
        elif roll < 0.6 \
                and db.relations[(rel := rels[int(rng.integers(len(rels)))])
                                 ].num_edges > 3:
            delta = random_delete(db, rel, int(rng.integers(1, 4)), rng)
        else:
            rel = rels[int(rng.integers(len(rels)))]
            delta = random_insert(db, rel, int(rng.integers(1, 4)), rng)
        if delta is not None:
            st.apply_delta(delta)
        if step % 2 == 0:
            check_all()
    check_all()                                  # final state


def test_stale_delta_application_rejected():
    db = mixed_db()
    rng = np.random.default_rng(2)
    st = strategy("HYBRID", db, tc.build_lattice(db.schema, 1))
    d1 = random_insert(db, "R0", 2, rng)
    random_insert(db, "R0", 2, rng)              # second, unreconciled write
    with pytest.raises(ValueError):
        st.apply_delta(d1)                       # out of order: cross terms


def test_stale_attr_delta_application_rejected():
    db = mixed_db()
    rng = np.random.default_rng(21)
    st = strategy("HYBRID", db, tc.build_lattice(db.schema, 1))
    d1 = random_attr_write(db, "A", 2, rng)
    random_attr_write(db, "A", 2, rng)           # second, unreconciled write
    with pytest.raises(ValueError):
        st.apply_delta(d1)                       # out of order


@pytest.mark.parametrize("sname", STRATEGIES)
def test_small_delta_retains_or_updates_fam_and_complete(sname):
    """After a small fact delta, every resident ``"fam"``/``"complete"``
    entry is retained (zero-delta relation) or updated IN PLACE through the
    butterfly delta — never invalidated — and each equals a recount on a
    fresh strategy over the mutated store bit for bit."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    rng = np.random.default_rng(seed_of(sname))
    st = strategy(sname, db, lattice)
    warm_families(st, db, lattice)
    cache = st.engine.cache
    fam_keys = [k for k in cache.keys_snapshot()
                if k[0] in ("fam", "complete")]
    assert fam_keys
    report = st.apply_delta(random_insert(db, "R0", 2, rng))
    assert report.invalidated == 0, report
    assert report.updated > 0
    assert cache.info()["delta_updated"] == report.updated
    survivors = set(cache.keys_snapshot())
    assert set(fam_keys) <= survivors
    fresh = strategy(sname, db, lattice)
    for key in fam_keys:
        point, keep = tc.LatticePoint(key[1]), tuple(key[2])
        want = fresh.family_ct(point, keep) if key[0] == "fam" \
            else fresh._complete_full(point)
        got = cache.peek(key)
        assert got.vars == want.vars
        assert torch.equal(got.counts, want.counts), f"{sname} {key[0]} {point}"


def test_attr_write_invalidates_only_dependent_entries():
    """An attribute write sweeps exactly the entries whose dependency
    stamps intersect the written ``(etype, attr)`` tags; everything else
    stays resident and oracle-exact afterwards."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    st = strategy("HYBRID", db, lattice)
    warm_families(st, db, lattice)
    cache = st.engine.cache
    before = set(cache.keys_snapshot())
    rows = np.array([0, 1], np.int32)
    a_attr = db.entities["A"].type.attrs[0]
    vals = ((db.entities["A"].attrs[a_attr.name][rows] + 1)
            % a_attr.card).astype(np.int32)
    delta = db.update_attrs("A", rows, {a_attr.name: vals})
    tags = delta.dep_tags()
    invalidated0 = cache.invalidated
    report = st.apply_delta(delta)
    assert report.op == "update_attrs" and report.updated == 0
    after = set(cache.keys_snapshot())
    for key in before:
        deps = key_deps(key)
        if deps is not None and not (deps & tags):
            assert key in after, key             # disjoint deps: retained
        else:
            assert key not in after, key         # dependent: invalidated
    assert report.retained == sum(1 for k in before if not (key_deps(k)
                                                            & tags))
    assert cache.invalidated - invalidated0 == report.invalidated > 0
    for p in lattice:                            # recomputes are exact
        keep = tuple(p.all_ct_vars(db.schema, include_rind=True))
        np.testing.assert_array_equal(st.family_ct(p, keep).counts.numpy(),
                                      oracle_ct(db, p, keep), err_msg=str(p))


# ----------------------------------------- fine-grained invalidation ----

def test_untouched_relations_keep_their_cache_entries():
    """A write to R0 must retain every R1/R2 artefact: the follow-up
    queries hit the cache (no new joins)."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    rng = np.random.default_rng(3)
    st = strategy("HYBRID", db, lattice)
    untouched = [p for p in lattice if "R0" not in p.rels]
    keeps = {p: tuple(p.all_ct_vars(db.schema, include_rind=True))
             for p in untouched}
    for p in untouched:
        st.family_ct(p, keeps[p])                # warm
    report = st.apply_delta(random_insert(db, "R0", 2, rng))
    assert report.retained > 0
    joins_before = st.stats.joins
    hits_before = st.engine.cache.hits
    for p in untouched:                          # all served from cache
        got = st.family_ct(p, keeps[p])
        np.testing.assert_array_equal(got.counts.numpy(),
                                      oracle_ct(db, p, keeps[p]))
    assert st.stats.joins == joins_before        # zero data access
    assert st.engine.cache.hits > hits_before


def test_entries_are_version_and_deps_stamped():
    db = mixed_db()
    st = strategy("HYBRID", db, tc.build_lattice(db.schema, 1))
    cache = st.engine.cache
    keys = cache.keys_snapshot()
    assert keys
    for key in keys:
        deps, version = cache.entry_meta(key)
        assert deps == key_deps(key)
        assert version == 0
        if key[0] == "hist":
            assert not any(isinstance(d, str) for d in deps)
            assert all(d[0] == "attr" for d in deps)
        elif key[0] == "full":
            rels = {d for d in deps if isinstance(d, str)}
            assert rels and rels <= set(db.relations)
            assert all(t[0] == "attr*" for t in deps - rels)
    assert cache.entry_meta(("nope",)) is None
    rng = np.random.default_rng(4)
    st.apply_delta(random_insert(db, "R0", 1, rng))
    updated = [k for k in cache.keys_snapshot()
               if "R0" in (cache.entry_meta(k)[0] or ())]
    assert updated
    for k in updated:                            # refreshed under v1
        assert cache.entry_meta(k)[1] == 1


def test_delta_threshold_falls_back_to_invalidation():
    """A delta above max_update_fraction drops the dependent positive
    artefacts instead of updating them — and the next query recomputes
    correctly either way."""
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 1)
    rng = np.random.default_rng(5)
    st = strategy("HYBRID", db, lattice)
    small = st.apply_delta(random_insert(db, "R0", 1, rng))
    assert small.updated > 0 and small.invalidated == 0
    big = st.apply_delta(random_insert(db, "R0", 12, rng),
                         max_update_fraction=0.05)
    assert big.updated == 0 and big.invalidated > 0
    for p in lattice:
        keep = p.all_ct_vars(db.schema, include_rind=True)
        np.testing.assert_array_equal(st.family_ct(p, keep).counts.numpy(),
                                      oracle_ct(db, p, keep))


def test_cache_delta_methods():
    """peek/entry_meta neither count nor touch the LRU; discard counts
    under ``invalidated``; ``delta_updated`` moves only through
    ``count_delta_updates``."""
    cache = tc.CtCache(deps_fn=lambda key: frozenset({"R"}),
                       version_fn=lambda: 7)
    a, b = torch.zeros(4), torch.ones(2)
    cache.put(("a",), a)
    cache.put(("b",), b)
    assert cache.peek(("a",)) is a and cache.peek(("z",), 3) == 3
    assert cache.entry_meta(("a",)) == (frozenset({"R"}), 7)
    assert cache.keys_snapshot() == [("a",), ("b",)]   # LRU order kept
    assert (cache.hits, cache.misses) == (0, 0)
    assert cache.discard(("a",)) and not cache.discard(("a",))
    cache.count_delta_updates(2)
    info = cache.info()
    assert (info["invalidated"], info["evictions"], info["delta_updated"],
            info["entries"], info["nbytes"]) == (1, 0, 2, 1, b.nbytes)


# ------------------------------------------------- parity with the JAX path --

def key_to_port(key):
    """A JAX package cache key in the port's types."""
    ns = key[0]
    atoms = lambda a: point_to_port(jc.LatticePoint(tuple(a))).atoms
    if ns == "pos":
        return ("pos", key[1], atoms(key[2]), keep_to_port(key[3]))
    if ns == "full":
        return ("full", key[1], atoms(key[2]))
    if ns in ("fam", "complete"):
        return (ns, atoms(key[1]), keep_to_port(key[2]))
    if ns == "msg":
        return ("msg", key[1], atoms((key[2],))[0], var_to_port(key[3]),
                var_to_port(key[4]))
    assert ns == "hist", key
    return ("hist", key[1], var_to_port(key[2]), keep_to_port(key[3]))


def assert_caches_equal(js, ts, label):
    jcache, tcache = js.engine.cache, ts.engine.cache
    jkeys = {key_to_port(k): k for k in jcache.keys_snapshot()}
    tkeys = tcache.keys_snapshot()
    assert set(jkeys) == set(tkeys), label
    for tk in tkeys:
        jk = jkeys[tk]
        assert jcache.entry_meta(jk) == tcache.entry_meta(tk), (label, tk)
        jv, tv = jcache.peek(jk), tcache.peek(tk)
        if tk[0] == "msg":
            (jm, jvars), (tm, tvars) = jv, tv
        else:
            (jm, jvars), (tm, tvars) = (jv.counts, jv.vars), (tv.counts,
                                                              tv.vars)
        assert keep_to_port(jvars) == tuple(tvars), (label, tk)
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm),
                                      err_msg=f"{label} {tk[0]}")
    assert tcache.info()["delta_updated"] == jcache.info()["delta_updated"]
    assert tcache.info()["invalidated"] == jcache.info()["invalidated"]


def mirror(jdb, delta):
    """Apply the port's applied ``delta`` to the JAX store."""
    if isinstance(delta, AttrDelta):
        return jdb.update_attrs(delta.etype, delta.rows, delta.new)
    if delta.op == "insert":
        return jdb.insert_facts(delta.rel, delta.src, delta.dst, delta.attrs)
    return jdb.delete_facts(delta.rel, delta.src, delta.dst)


# inserts, deletes and attribute writes; the last insert is above
# max_update_fraction of R1's edges (the invalidation fallback)
WRITES = (("insert", "R0", 2), ("delete", "R1", 2), ("attr", "A", 2),
          ("insert", "R2", 2), ("attr", "C", 1), ("delete", "R0", 1),
          ("insert", "R1", 5))


@pytest.mark.parametrize("sname", STRATEGIES)
def test_reconciled_caches_equal_jax(sname):
    """The same seeded writes on the JAX store and the port's: after each
    ``apply_delta`` the reports are equal and every resident entry (its
    stamp and its table) is equal bit for bit, then again after the
    families are asked for once more (the invalidated ones recomputed)."""
    jdb = jax_mixed_db()
    tdb = to_port(jdb)
    jl = jc.build_lattice(jdb.schema, 2)
    tl = [point_to_port(p) for p in jl]
    js = jc.make_strategy(sname, executor="sparse")
    js.prepare(jdb, jl)
    ts = strategy(sname, tdb, tl)
    rng = np.random.default_rng(seed_of("parity", sname))
    # every point's full axes (edge attributes kept: the blockwise negative
    # phase) and its axes without edge attributes (the butterfly)
    keeps = []
    for jp in jl:
        pool = tuple(jp.all_ct_vars(jdb.schema, include_rind=True))
        keeps += [(jp, pool), (jp, tuple(v for v in pool if v.kind != "edge"))]

    def ask():
        for jp, keep in keeps:
            js.family_ct(jp, keep)
            ts.family_ct(point_to_port(jp), keep_to_port(keep))

    ask()
    assert_caches_equal(js, ts, "warm")
    seen = set()
    for op, name, k in WRITES:
        if op == "insert":
            d = random_insert(tdb, name, k, rng)
        elif op == "delete":
            d = random_delete(tdb, name, k, rng)
        else:
            d = random_attr_write(tdb, name, k, rng)
        jd = mirror(jdb, d)
        jrep, trep = js.apply_delta(jd), ts.apply_delta(d)
        assert trep.as_dict() == jrep.as_dict(), (op, name)
        seen.add((trep.updated > 0, trep.invalidated > 0))
        assert_caches_equal(js, ts, f"after {op} {name}")
        ask()
        assert_caches_equal(js, ts, f"asked again after {op} {name}")
    assert (True, False) in seen and (False, True) in seen


def delta_queries(jdb):
    """Hand-picked ``(point, keep)`` queries for a write to R0, with the
    status each must get: the butterfly (K3) path, R0's indicator summed
    out, R0 not in the pattern, kept edge attributes (the blockwise path,
    disjoint blocks and the N/A slot shared), and R0 used twice (the
    fallback)."""
    sch = jdb.schema
    A0, A1, B0, C0 = (jc.Var("A", 0), jc.Var("A", 1), jc.Var("B", 0),
                      jc.Var("C", 0))
    r0 = jc.Atom("R0", A0, B0)
    chain = jc.LatticePoint((r0, jc.Atom("R1", B0, C0)))
    single = jc.LatticePoint((r0,))
    other = jc.LatticePoint((jc.Atom("R1", B0, C0),))
    twice = jc.LatticePoint((r0, jc.Atom("R0", A1, B0)))
    a0 = jc.attr_var(A0, "a0", 3)
    b0 = jc.attr_var(B0, "b0", 4)
    c0 = jc.attr_var(C0, "c0", 2)
    e0 = jc.edge_var("R0", "e0", 2)
    rr0, rr1 = jc.rind_var("R0"), jc.rind_var("R1")
    assert sch.relationship("R0").attrs[0].name == "e0"
    return [
        (chain, (a0, rr0, c0, rr1), "delta"),
        (chain, (rr1, b0, rr0), "delta"),
        (single, (b0, rr0, a0), "delta"),
        (chain, (a0, rr1, c0), "zero"),
        (other, (b0, rr1), "zero"),
        (single, (a0, e0, rr0), "delta"),
        (chain, (e0, c0, rr1), "delta"),
        (twice, (a0, rr0), "fallback"),
    ]


@pytest.mark.parametrize("op", ("insert", "delete"))
def test_complete_ct_delta_many_matches_jax(op):
    """``complete_ct_delta_many`` on hand-picked queries: the reference's
    statuses and delta tables bit for bit; each delta added to the old
    complete table gives the recount on the mutated store; and
    ``butterfly_delta`` is its one-query case."""
    jdb = jax_mixed_db()
    tdb = to_port(jdb)
    rng = np.random.default_rng(seed_of("delta_many", op))
    qs = delta_queries(jdb)
    teng = tc.CountingEngine(tdb, "sparse", tc.CostStats(), device=CPU)
    old = [tc.complete_ct(point_to_port(p), keep_to_port(k),
                          tengine.CachedFullPositives(teng))
           for p, k, _ in qs[:-1]]
    d = (random_insert(tdb, "R0", 3, rng) if op == "insert"
         else random_delete(tdb, "R0", 3, rng))
    jd = mirror(jdb, d)
    jeng = JaxEngine(jdb, "sparse", jc.CostStats())
    want = jax_delta_many([(p, k) for p, k, _ in qs], "R0",
                          JaxDeltaPositives(jeng, jd.as_db(jdb)),
                          mobius_fused_fn=jeng.mobius_fused_fn())
    provider = _DeltaPositives(teng, d.as_db(tdb))
    got = complete_ct_delta_many(
        [(point_to_port(p), keep_to_port(k)) for p, k, _ in qs], "R0",
        provider, mobius_fused_fn=teng.mobius_fused_fn())
    assert [s for s, _ in got] == [s for s, _ in want] == \
        [s for _, _, s in qs]
    fresh = tc.CountingEngine(tdb, "sparse", tc.CostStats(), device=CPU)
    for (p, k, status), (_, g), (_, w), o in zip(qs, got, want, old + [None]):
        if status != "delta":
            assert g is None and w is None
            continue
        assert g.vars == keep_to_port(w.vars)
        np.testing.assert_array_equal(g.counts.numpy(), np.asarray(w.counts))
        recount = tc.complete_ct(point_to_port(p), keep_to_port(k),
                                 tengine.CachedFullPositives(fresh))
        assert torch.equal((o + g.scale(d.sign)).counts, recount.counts)
        one = butterfly_delta(point_to_port(p), keep_to_port(k), "R0",
                              provider, mobius_fn=teng.mobius_fn())
        assert one[0] == "delta" and torch.equal(one[1].counts, g.counts)


# ---------------------------------------- the recount comparison can fail --

def warm_pair(sname="HYBRID"):
    db = mixed_db()
    lattice = tc.build_lattice(db.schema, 2)
    st = strategy(sname, db, lattice)
    warm_families(st, db, lattice)
    return db, lattice, st


@pytest.mark.parametrize("sname", STRATEGIES)
def test_recount_comparison_passes_after_reconciliation(sname):
    db, lattice, st = warm_pair(sname)
    rng = np.random.default_rng(seed_of("recount", sname))
    compared = 0
    for write, name in ((random_insert, "R0"), (random_delete, "R2"),
                        (random_attr_write, "B")):
        st.apply_delta(write(db, name, 1, rng))
        out = recount_entries(st, strategy(sname, db, lattice))
        assert out["low_differs"] == [] and out["past_bound"] == []
        assert out["worst_past_2_24"] == 0.0
        compared += out["entries"]
        warm_families(st, db, lattice)
    assert compared > 0


def test_recount_comparison_catches_a_flipped_sign():
    """A planted fault: the insert reconciled as if it were a delete."""
    db, lattice, st = warm_pair()
    d = random_insert(db, "R0", 2, np.random.default_rng(11))
    st.apply_delta(dataclasses.replace(d, op="delete"))
    out = recount_entries(st, strategy("HYBRID", db, lattice))
    assert {k[0] for k in out["low_differs"]} >= {"full", "fam"}


def test_recount_comparison_catches_a_skipped_fam_update(monkeypatch):
    """A planted fault: the butterfly delta claims every derived table is
    unaffected, so no ``"fam"`` entry is updated."""
    db, lattice, st = warm_pair()
    monkeypatch.setattr(
        tengine, "complete_ct_delta_many",
        lambda queries, *a, **kw: [("zero", None)] * len(queries))
    st.apply_delta(random_insert(db, "R0", 2, np.random.default_rng(12)))
    out = recount_entries(st, strategy("HYBRID", db, lattice))
    assert {k[0] for k in out["low_differs"]} == {"fam"}
