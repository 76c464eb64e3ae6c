"""The port's discovery service, mirrored from ``tests/test_discovery.py``
and held to the JAX package's.

Whatever backend the hill-climb counts through — bare strategy or batching
service — and however the store mutates, the learned model must be
edge-identical (and score-identical within fp tolerance) to the local
``discover_model`` oracle run on an equivalent store.  The JAX package's
``test_sharded_router_discovery_matches_oracle`` and the router leg of
``test_all_backends_agree_exactly`` have no counterpart: the router is not
ported yet (ROADMAP item 11).

Then the two packages side by side: on the same database and write, the
JAX ``DiscoveryService`` and the port's give equal signatures, scores and
``RefreshReport`` counts when the JAX search scores with the port's BDeu
(the packages' float32 BDeu bits differ and decide near ties; ROADMAP C),
and the JAX package's own scores are within the discovery tolerance of
the port's.  Last,
the refresh check ``chip_smoke.py`` phase 14 runs on the card
(``refresh_check``) passes a correct refresh and fails one that names the
wrong relation.
"""

import threading
import time

import jax  # noqa: F401  (both frameworks in one process; JAX stays on CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
import repro.core.bdeu as jbdeu
import repro.core.search as jsearch
import repro_torch.core as tc
import repro_torch.core.bdeu as tbdeu
from chip_smoke import (family_tables, memo_scores, refresh_check,
                        refresh_faults)
from repro.discover import DiscoveryService as JaxDiscovery
from repro.serve import CountingService as JaxService
from repro_torch.discover import (DiscoveryService, LocalCounts,
                                  RouterCounts, ServiceCounts,
                                  as_count_provider, models_signature)
from repro_torch.serve import CountingRouter, CountingService
from tests.test_counting_core import tiny_db as jax_tiny_db
from tests.test_mutations import fresh_pairs
from tests.test_torch_data import to_port

CPU = "cpu"
STRATEGIES = ["PRECOUNT", "ONDEMAND", "HYBRID", "TUPLEID"]
SCORE_TOL = 1e-3
WAIT_S = 120.0                     # every join is bounded


def tiny_db(seed=0):
    return to_port(jax_tiny_db(seed))


def strategy(name):
    return tc.make_strategy(name, device=CPU)


def counting(db):
    return CountingService(tc.CountingEngine(db, "sparse", device=CPU))


def _oracle(db, name="ONDEMAND", **kw):
    models, _ = tc.discover_model(db, strategy(name), max_chain_length=2,
                                  device=CPU, **kw)
    return models_signature(models), sum(m.score for m in models.values())


# -- (a) served == local, all 4 strategies -----------------------------------

@pytest.fixture(scope="module")
def oracle():
    return _oracle(tiny_db(0))


@pytest.mark.parametrize("name", STRATEGIES)
def test_local_discovery_matches_oracle_per_strategy(name, oracle):
    """DiscoveryService over each bare strategy == plain discover_model."""
    svc = DiscoveryService(strategy(name), db=tiny_db(0))
    res = svc.discover()
    sig, score = oracle
    assert res.signature() == sig
    assert res.score == pytest.approx(score, abs=SCORE_TOL)
    assert res.restarts == 0
    assert res.families_scored > 0


def test_served_discovery_matches_oracle(oracle):
    csvc = counting(tiny_db(0))
    res = csvc.discovery().discover()
    sig, score = oracle
    assert res.signature() == sig
    assert res.score == pytest.approx(score, abs=SCORE_TOL)
    # entry point memoizes one shared service and surfaces its stats
    assert csvc.discovery() is csvc.discovery()
    assert csvc.stats()["discovery"]["discoveries"] == 1


def test_all_backends_agree_exactly():
    """The local and served backends' signatures are identical and their
    scores equal."""
    local = DiscoveryService(strategy("HYBRID"), db=tiny_db(1)).discover()
    served = DiscoveryService(counting(tiny_db(1))).discover()
    assert local.signature() == served.signature()
    assert abs(local.score - served.score) < SCORE_TOL


def test_count_providers_adapt_backends():
    db = tiny_db(0)
    st = strategy("HYBRID")
    assert isinstance(as_count_provider(st, db), LocalCounts)
    csvc = counting(db)
    assert isinstance(as_count_provider(csvc), ServiceCounts)
    provider = as_count_provider(csvc)
    assert as_count_provider(provider) is provider
    assert provider.version() == ("db", 0)
    with pytest.raises(ValueError):
        LocalCounts(strategy("HYBRID"))           # no db, never prepared

    router = CountingRouter(tc.shard_database(tiny_db(0), 2),
                            executor="sparse", device=CPU)
    assert isinstance(as_count_provider(router), RouterCounts)
    assert as_count_provider(router).version() == ("shards", 0, 0)

    class CountingRouter_:                         # a look-alike by name
        pass

    with pytest.raises(TypeError):
        as_count_provider(CountingRouter_())
    with pytest.raises(TypeError):
        as_count_provider(object())


def test_search_hooks_leave_discover_model_unchanged():
    """``StructureSearch`` without a database (schema and provider given),
    one family at a time (``batch_scoring=False``) and with a round hook
    learns ``discover_model``'s models; ``run(init_models=...)`` starts
    from them and keeps them."""
    db = tiny_db(0)
    lattice = tc.build_lattice(db.schema, 2)
    st = strategy("HYBRID")
    st.prepare(db, lattice)
    want, _ = tc.discover_model(tiny_db(0), strategy("HYBRID"), device=CPU)
    rounds = []
    search = tc.StructureSearch(
        None, None, counts=LocalCounts(st), schema=db.schema,
        batch_scoring=False, round_cb=lambda *a: rounds.append(a))
    got = search.run(lattice)
    assert models_signature(got) == models_signature(want)
    assert rounds and all(a[3] <= a[4] for a in rounds)
    assert sum(a[2] for a in rounds) <= search.families_scored
    assert search.batch_calls == 0
    assert set(search.family_deps) == set(search._score_cache)
    again = tc.StructureSearch(db, st).run(lattice, init_models=got)
    assert models_signature(again) == models_signature(want)


# -- (b) delta refresh: selective, counter-asserted, == full relearn ---------

def _mutate(db, strategy_or_none=None, seed=7):
    """Insert a few not-yet-present Reg edges; returns the FactDelta."""
    rng = np.random.default_rng(seed)
    src, dst = fresh_pairs(db, "Reg", 3, rng)
    delta = db.insert_facts("Reg", src, dst,
                            {"grade": rng.integers(0, 2, size=3)
                             .astype(np.int32)})
    if strategy_or_none is not None:
        strategy_or_none.apply_delta(delta)
    return delta


def test_refresh_matches_fresh_relearn_and_rescans_selectively():
    db = tiny_db(0)
    svc = DiscoveryService(strategy("ONDEMAND"), db=db)
    first = svc.discover()
    delta = _mutate(db, svc.provider.strategy)
    report = svc.refresh(delta)
    # only dependency-intersecting families were re-scored; RA-only
    # families were carried forward untouched
    assert report.changed == frozenset({"Reg"})
    assert report.retained > 0
    assert report.rescored > 0
    assert report.rescored < report.total_families
    # and the refreshed model is bit-identical to learning from scratch
    sig, score = _oracle(db)
    assert report.result.signature() == sig
    assert report.result.score == pytest.approx(score, abs=SCORE_TOL)
    assert report.result.version != first.version


def test_refresh_through_served_backend():
    csvc = counting(tiny_db(0))
    dsvc = csvc.discovery()
    dsvc.discover()
    # fenced write through the service; the delta names the relation
    rng = np.random.default_rng(11)
    src, dst = fresh_pairs(csvc.engine.db, "Reg", 2, rng)
    report = csvc.insert_facts("Reg", src, dst,
                               {"grade": rng.integers(0, 2, size=2)
                                .astype(np.int32)})
    rep = dsvc.refresh("Reg")
    assert rep.retained > 0
    assert rep.rescored < rep.total_families
    sig, score = _oracle(csvc.engine.db)
    assert rep.result.signature() == sig
    assert rep.result.score == pytest.approx(score, abs=SCORE_TOL)
    snap = csvc.stats()["discovery"]
    assert snap["refreshes"] == 1
    assert snap["families_retained"] == rep.retained
    assert snap["rescored_hist"]["count"] == 1
    assert report is not None


def test_refresh_on_untouched_relation_rescans_nothing_new():
    """A delta on RA must retain every Reg-only family score."""
    db = tiny_db(0)
    svc = DiscoveryService(strategy("ONDEMAND"), db=db)
    svc.discover()
    rng = np.random.default_rng(3)
    src, dst = fresh_pairs(db, "RA", 1, rng)
    delta = db.insert_facts("RA", src, dst,
                            {"sal": rng.integers(0, 2, size=1)
                             .astype(np.int32)})
    svc.provider.strategy.apply_delta(delta)
    rep = svc.refresh(delta)
    assert rep.changed == frozenset({"RA"})
    assert rep.retained > 0
    assert rep.rescored < rep.total_families
    sig, _ = _oracle(db)
    assert rep.result.signature() == sig


def test_warm_start_refresh_is_selective_and_valid():
    """warm_start=True trades exact relearn-parity for fewer rounds; it
    must still re-score selectively and produce a well-formed model."""
    db = tiny_db(0)
    svc = DiscoveryService(strategy("ONDEMAND"), db=db)
    svc.discover()
    delta = _mutate(db, svc.provider.strategy)
    rep = svc.refresh(delta, warm_start=True)
    assert rep.retained > 0
    assert rep.rescored < rep.total_families
    for m in rep.result.models.values():
        assert np.isfinite(m.score)


def test_attribute_write_refresh_rescores_everything():
    """An attribute write carries nothing forward (every family's counts
    may depend on it) and still relearns the mutated store's models."""
    csvc = counting(tiny_db(0))
    dsvc = csvc.discovery()
    dsvc.discover()
    delta = csvc.engine.db.update_attrs("s", np.array([0, 3], np.int32),
                                        {"iq": np.array([1, 0], np.int32)})
    csvc.apply_delta(delta)
    rep = dsvc.refresh([delta])
    assert rep.retained == 0
    assert rep.changed == frozenset({"attr:s.iq"})
    assert rep.result.signature() == _oracle(csvc.engine.db)[0]
    dsvc.reset_memo()
    assert dsvc.discover().families_scored > 0     # the memo is empty


# -- (c) concurrent searches + write flood ------------------------------------

def test_concurrent_searches_share_cache_and_agree_under_write_flood():
    csvc = counting(tiny_db(0))
    dsvc = csvc.discovery(max_restarts=500)
    dsvc.discover()                      # warm the CT cache + score memo

    stop_writes = threading.Event()
    mid_results, finals, errors = [], {}, []

    def writer():
        rng = np.random.default_rng(23)
        try:
            for _ in range(5):
                src, dst = fresh_pairs(csvc.engine.db, "Reg", 1, rng)
                csvc.insert_facts("Reg", src, dst,
                                  {"grade": rng.integers(0, 2, size=1)
                                   .astype(np.int32)})
                time.sleep(0.05)
        except Exception as e:            # pragma: no cover - debug aid
            errors.append(e)
        finally:
            stop_writes.set()

    def searcher(name):
        try:
            while not stop_writes.is_set():
                mid_results.append(dsvc.discover())
            finals[name] = dsvc.discover()
        except Exception as e:
            errors.append(e)
            stop_writes.set()

    threads = [threading.Thread(target=writer)]
    threads += [threading.Thread(target=searcher, args=(f"s{i}",))
                for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(WAIT_S)
        assert not t.is_alive(), "a searcher or the writer hung"
    assert not errors, errors

    # both clients converged on the same final model of the same version
    a, b = finals["s0"], finals["s1"]
    assert a.version == b.version
    assert a.signature() == b.signature()
    assert a.score == pytest.approx(b.score, abs=SCORE_TOL)

    # ... which equals a from-scratch local relearn of the final store
    sig, score = _oracle(csvc.engine.db)
    assert a.signature() == sig
    assert a.score == pytest.approx(score, abs=SCORE_TOL)

    # any result minted at the final version is the final model
    for r in mid_results:
        if r.version == a.version:
            assert r.signature() == a.signature()

    # no torn counts: family tables read after quiesce are non-negative
    # integers
    lattice = tc.build_lattice(csvc.engine.db.schema, 2)
    point = lattice[-1]
    keep = tuple(point.all_ct_vars(csvc.engine.db.schema,
                                   include_rind=True))[:3]
    arr = csvc.count_complete(point, keep).counts.numpy()
    assert (arr >= 0).all()
    np.testing.assert_array_equal(arr, np.round(arr))

    # the shared memo served both clients: a warm discover on a quiesced
    # store does no fresh scoring at all
    before = dsvc.metrics.snapshot()["families_scored"]
    again = dsvc.discover()
    assert again.signature() == a.signature()
    assert dsvc.metrics.snapshot()["families_scored"] == before


# -- the two packages side by side ---------------------------------------------

def _port_scorer(stack, ess=1.0):
    """The port's BDeu in the JAX search's place: the same ``N_ijk`` stack
    scored by ``repro_torch.core.bdeu.bdeu_score_batch`` (its plain
    version on the CPU)."""
    return tbdeu.bdeu_score_batch(torch.from_numpy(np.array(stack)),
                                  ess).numpy()


@pytest.mark.parametrize("backend", ["served", "local"])
def test_discovery_and_refresh_equal_jax(backend, monkeypatch):
    """The same database, the same write, through the JAX package's
    discovery service and the port's.  Both packages count the same
    tables (integers below 2^24); only their float32 BDeu bits differ,
    and those decide near ties (score equivalence makes a reversed edge
    tie exactly; ROADMAP C), after which the climbs part.  So the JAX
    service runs here with the port's scorer in its search's place: then
    the signatures, the scores (bit for bit), the refresh counts and the
    discovery counters must all be equal — the service, memo, refresh and
    search logic are the same.  The JAX package's own scores are held to
    the port's in ``test_served_scores_within_jax_tolerance``."""
    monkeypatch.setattr(jsearch, "bdeu_score_batch", _port_scorer)
    jdb, tdb = jax_tiny_db(2), tiny_db(2)
    if backend == "served":
        jcsvc = JaxService(jc.CountingEngine(jdb, "sparse"))
        tcsvc = counting(tdb)
        jd, td = jcsvc.discovery(), tcsvc.discovery()
    else:
        jd = JaxDiscovery(jc.make_strategy("ONDEMAND"), db=jdb)
        td = DiscoveryService(strategy("ONDEMAND"), db=tdb)
    firsts = [d.discover() for d in (jd, td)]
    rng = np.random.default_rng(11)
    src, dst = fresh_pairs(jdb, "Reg", 2, rng)
    attrs = {"grade": rng.integers(0, 2, size=2).astype(np.int32)}
    if backend == "served":
        jcsvc.insert_facts("Reg", src, dst, attrs)
        tcsvc.insert_facts("Reg", src, dst, attrs)
    else:
        for d, db in ((jd, jdb), (td, tdb)):
            d.provider.strategy.apply_delta(db.insert_facts("Reg", src, dst,
                                                            attrs))
    jrep, trep = (d.refresh("Reg") for d in (jd, td))
    jfirst, tfirst = firsts
    assert tfirst.signature() == jfirst.signature()
    assert tfirst.score == jfirst.score
    assert tfirst.families_scored == jfirst.families_scored
    assert trep.result.signature() == jrep.result.signature()
    assert trep.result.score == jrep.result.score
    assert (trep.rescored, trep.retained, trep.total_families) == \
        (jrep.rescored, jrep.retained, jrep.total_families)
    assert trep.changed == jrep.changed
    js, ts = jd.stats(), td.stats()
    for k in ("discoveries", "refreshes", "restarts", "rounds",
              "families_scored", "families_rescored", "families_retained"):
        assert ts[k] == js[k], k


def test_served_scores_within_jax_tolerance():
    """Every family the port's served discovery scored, before and after a
    refresh: the JAX package's BDeu of the same table is within the
    discovery tests' tolerance (``rtol=1e-4, atol=1e-2``) of the port's
    score."""
    tcsvc = counting(tiny_db(2))
    td = tcsvc.discovery()
    td.discover()
    for refreshed in (False, True):
        if refreshed:
            rng = np.random.default_rng(11)
            src, dst = fresh_pairs(tcsvc.engine.db, "Reg", 2, rng)
            tcsvc.insert_facts("Reg", src, dst, {"grade": rng.integers(
                0, 2, size=2).astype(np.int32)})
            td.refresh("Reg")
        got = memo_scores(td)
        tables = family_tables(td, tcsvc, got)
        assert len(tables) == len(got) > 0
        for fam, (_, tab) in tables.items():
            nijk = jnp.asarray(tbdeu.family_nijk(tab, fam[0]).numpy())
            want = float(jbdeu.bdeu_score_batch(nijk[None])[0])
            assert got[fam] == pytest.approx(want, rel=1e-4, abs=1e-2), fam


def test_refresh_check_fails_on_the_wrong_relation():
    """``chip_smoke.refresh_check`` (phase 14's comparison) passes a
    refresh naming the written relation and fails one naming another,
    which carries stale scores forward."""
    stores = [tiny_db(0), tiny_db(0)]
    services = [counting(db) for db in stores]
    for s in services:
        s.discovery().discover()
        rng = np.random.default_rng(11)
        src, dst = fresh_pairs(s.engine.db, "Reg", 3, rng)
        s.insert_facts("Reg", src, dst, {"grade": rng.integers(
            0, 2, size=3).astype(np.int32)})
    good = services[0].discovery().refresh("Reg")
    services[1].discovery().refresh("RA")            # the planted fault
    fresh = counting(tiny_db(0))
    rng = np.random.default_rng(11)
    src, dst = fresh_pairs(fresh.engine.db, "Reg", 3, rng)
    fresh.insert_facts("Reg", src, dst, {"grade": rng.integers(
        0, 2, size=3).astype(np.int32)})
    fresh.discovery().discover()
    ok = refresh_check(services[0].discovery(), services[0],
                       fresh.discovery(), fresh)
    assert not refresh_faults(ok), ok
    assert ok["compared"] == ok["families"] > 0
    assert good.result.signature() == models_signature(
        fresh.discovery()._models)
    bad = refresh_check(services[1].discovery(), services[1],
                        fresh.discovery(), fresh)
    assert "stale" in refresh_faults(bad)
    assert "low_differs" in refresh_faults(bad)
