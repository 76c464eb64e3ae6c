"""The slice as a whole: HYBRID model discovery in the port against the JAX
package, on the UW stand-in at scale 0.25 (``test_torch_discovery_imdb``
holds the same checks on IMDb at scale 0.01).

What is held:

* the paper's counting metrics (joins, rows scanned, ct rows) are equal;
* every family score of both packages is within the float32 error bound of
  the exact (float64) BDeu score of the same counts: the JAX package's
  kernel tolerance (``rtol=1e-4, atol=1e-2``) plus ``4 eps M``, where
  ``M`` is the sum of the magnitudes of the score's lgamma terms and
  ``eps = 2^-24``.  A float32 sum of terms near ``M`` cannot be closer
  than a few ``eps M`` (both packages stay within ``2.2 eps M`` on these
  databases); with counts of ten thousand and more that exceeds the kernel
  tolerance alone, for the JAX package as for the port;
* the JAX package's own search loop, fed the port's scores, learns exactly
  the port's models — the search logic is the same, edge for edge;
* the JAX package's search, replayed move by move beside the port's,
  picks the same move as the port wherever the two packages' scores do
  not meet a near tie; where they pick differently, the two moves' deltas
  differ by less than the error bound of the four family scores involved,
  in both packages' scores (the flip and both deltas are printed).  Every
  point no flip reached, directly or through its sub-points, has the JAX
  package's model edge for edge, and the flips and the points whose models
  differ are no more than those recorded in ``UW_FLIPS``/``UW_DIFFER``
  (``IMDB_*`` for IMDb; ROADMAP.md, section C).  BDeu is score
  equivalent, so reversing an edge between two nodes with the same other
  parents ties exactly, and
  only the last float32 bits break that tie: the JAX package's come from
  XLA's lgamma and reduction order, the port's from its own
  bit-reproducible scorer (``repro_torch/kernels/bdeu.py``).
"""

import jax  # noqa: F401
import numpy as np
import pytest
import torch

import repro.core as jc
import repro_torch.core as tc
from repro.core.search import StructureSearch as JaxSearch
from repro_torch.core.bdeu import family_nijk
from repro_torch.core.search import StructureSearch
from tests.test_torch_data import edges_of, point_to_port

CPU = "cpu"
RTOL, ATOL = 1e-4, 1e-2
EPS32 = 2.0 ** -24
STAT_KEYS = ("joins", "rows_scanned", "ct_rows")


def fam_key(fam):
    child, parents = fam
    return str(child), tuple(sorted(str(p) for p in parents))


def exact_and_bound(nijk, ess=1.0):
    """The float64 BDeu score of ``N_ijk`` and the float32 error bound
    around it (see the module docstring)."""
    n = nijk.double()
    q, r = n.shape
    lg = lambda v: torch.lgamma(torch.as_tensor(v, dtype=torch.float64))
    a_j, a_jk = ess / q, ess / (q * r)
    row, cell = lg(n.sum(1) + a_j), lg(n + a_jk)
    exact = float((lg(a_j) - row + (cell - lg(a_jk)).sum(1)).sum())
    mag = float((lg(a_j).abs() + row.abs()
                 + (cell.abs() + lg(a_jk).abs()).sum(1)).sum())
    return exact, ATOL + RTOL * abs(exact) + 4 * EPS32 * mag


class _NoCounts:
    """A count provider that must never be asked: every family the search
    needs is already in its score memo."""

    def family_ct(self, point, keep):
        raise AssertionError(f"family {keep} was not scored by the port")

    family_ct_many = None


class PortScores(dict):
    """Score memo for the JAX package's search that answers from the
    port's scores (by family name) and records anything else."""

    def __init__(self, port_scores):
        super().__init__()
        self.port = port_scores
        self.own = {}

    def __contains__(self, fam):
        return fam_key(fam) in self.port or fam in self.own

    def __getitem__(self, fam):
        key = fam_key(fam)
        return self.port[key] if key in self.port else self.own[fam]

    def __setitem__(self, fam, score):
        self.own[fam] = score


class RecordingCounts:
    """The port strategy's family-table protocol, keeping each family's
    ``N_ijk`` by name."""

    def __init__(self, strategy):
        self.strategy = strategy
        self.nijk = {}

    def _keep(self, keeps, tabs):
        for keep, tab in zip(keeps, tabs):
            self.nijk[fam_key((keep[-1], keep[:-1]))] = family_nijk(
                tab, keep[-1])
        return tabs

    def family_ct(self, point, keep):
        return self._keep([keep], [self.strategy.family_ct(point, keep)])[0]

    def family_ct_many(self, point, keeps):
        return self._keep(keeps, self.strategy.family_ct_many(point, keeps))


def run_reference(name, scale):
    """The JAX package's HYBRID/sparse discovery, as ``discover_model``
    runs it, keeping the search's score memo."""
    db = jc.paper_benchmark_db(name, 0, scale=scale)
    lattice = jc.build_lattice(db.schema, 2)
    st = jc.make_strategy("HYBRID", executor="sparse")
    st.prepare(db, lattice)
    search = JaxSearch(db, st)
    models = search.run(lattice)
    return dict(db=db, lattice=lattice, strategy=st, models=models,
                scores={fam_key(f): s for f, s in search._score_cache.items()},
                stats=st.stats.as_dict())


def run_port(name, scale, ex):
    db = tc.paper_benchmark_db(name, 0, scale=scale)
    models, st = tc.discover_model(
        db, tc.make_strategy("HYBRID", executor=ex, device=CPU), device=CPU)
    # the same search once more, keeping its score memo and its tables
    counts = RecordingCounts(st)
    search = StructureSearch(db, st, counts=counts)
    again = search.run(tc.build_lattice(db.schema, 2))
    assert edges_of(again) == edges_of(models)
    scores = {fam_key(f): s for f, s in search._score_cache.items()}
    assert set(scores) == set(counts.nijk)
    return dict(models=models, scores=scores,
                exact={k: exact_and_bound(n) for k, n in counts.nijk.items()},
                stats=st.stats.as_dict())


def check_counting_stats(ref, port):
    for k in STAT_KEYS:
        assert port["stats"][k] == ref["stats"][k], k


def check_family_scores(ref, port):
    common = set(ref["scores"]) & set(port["scores"])
    assert len(common) >= 0.8 * len(ref["scores"]), \
        (len(common), len(ref["scores"]))
    for key, (exact, bound) in port["exact"].items():
        assert abs(port["scores"][key] - exact) <= bound, \
            (key, port["scores"][key], exact, bound)
        if key in common:
            assert abs(ref["scores"][key] - exact) <= bound, \
                (key, ref["scores"][key], exact, bound)


def check_jax_search_on_port_scores(ref, port):
    memo = PortScores(port["scores"])
    search = JaxSearch(ref["db"], None, counts=_NoCounts(), score_cache=memo)
    models = search.run(ref["lattice"])
    assert not memo.own
    assert edges_of(models) == edges_of(port["models"])
    for p, m in models.items():
        assert m.score == port["models"][point_to_port(p)].score


def replay_against_reference(ref, port):
    """Run the JAX package's climb, scoring each round's moves with both
    packages' scores and following the port's choice; return the
    decisions where the two choices differ (see the module docstring)."""
    strategy, schema = ref["strategy"], ref["db"].schema
    rules = JaxSearch(ref["db"], strategy)
    jax_scores = dict(ref["scores"])

    def jax_score(point, child, parents):
        key = fam_key((child, parents))
        if key not in jax_scores:
            keep = tuple(sorted(parents)) + (child,)
            jax_scores[key] = jc.family_score(strategy.family_ct(point, keep),
                                              child)
        return jax_scores[key]

    def port_score(point, child, parents):
        return port["scores"][fam_key((child, parents))]

    models, diverged, flips = {}, set(), []
    for point in ref["lattice"]:
        nodes = list(point.all_ct_vars(schema, include_rind=True))
        parents = {n: set() for n in nodes}
        subs = [s for s in models if s.rels < point.rels]
        for sub in subs:
            for c, ps in models[sub].items():
                if c in parents:
                    parents[c] |= {p for p in ps if p in parents}
        split = any(s in diverged for s in subs)
        for _ in range(rules.max_moves):
            moves = rules._candidate_moves(nodes, parents)

            def delta(score, move):
                if move is None:
                    return 0.0
                _, _, dst, new_ps = move
                return (score(point, dst, new_ps)
                        - score(point, dst, frozenset(parents[dst])))

            def best(score):
                best_delta, best_move = 0.0, None
                for move in moves:
                    d = delta(score, move)
                    if d > best_delta:
                        best_delta, best_move = d, move
                return best_move

            mj, mp = best(jax_score), best(port_score)
            if mj != mp:
                split = True
                noise = sum(port["exact"][fam_key((dst, ps))][1]
                            for m in (mj, mp) if m is not None
                            for dst, ps in ((m[2], m[3]),
                                            (m[2], frozenset(parents[m[2]]))))
                gap_jax = delta(jax_score, mj) - delta(jax_score, mp)
                gap_port = delta(port_score, mp) - delta(port_score, mj)
                name = lambda m: "stop" if m is None else \
                    f"{m[0]} {m[1]}->{m[2]}"
                flips.append((str(point), name(mj), name(mp)))
                msg = (f"{point}: JAX {name(mj)}, port {name(mp)}; "
                       f"delta gap {gap_jax!r} in JAX scores, "
                       f"{gap_port!r} in port scores, bound {noise!r}")
                print(msg)
                assert gap_jax <= noise and gap_port <= noise, msg
            if mp is None:
                break
            op, src, dst, _ = mp
            (parents[dst].add if op == "add" else parents[dst].remove)(src)
        models[point] = {n: frozenset(ps) for n, ps in parents.items()}
        if split:
            diverged.add(point)

    replayed = {str(p): sorted((str(a), str(c)) for c, ps in m.items()
                               for a in ps) for p, m in models.items()}
    assert replayed == edges_of(port["models"])
    want, got = edges_of(ref["models"]), edges_of(port["models"])
    differ = {str(p) for p in ref["lattice"] if got[str(p)] != want[str(p)]}
    assert differ <= {str(p) for p in diverged}
    return flips, differ


def check_known_divergence(ref, port, known_flips, known_differ):
    """The near-tie replay, and no flip or differing point beyond those
    recorded in ROADMAP.md (section C): a new divergence fails here."""
    flips, differ = replay_against_reference(ref, port)
    assert set(flips) <= known_flips, set(flips) - known_flips
    assert differ <= known_differ, differ - known_differ


# ------------------------------------------------------------------ UW ----

# Every decision where the two packages' searches part on UW at scale 0.25
# (the same over both executors): (point, JAX move, port move).
UW_FLIPS = {
    ("Registered(student0,course0)",
     "add ranking(student0)->intelligence(student0)",
     "add intelligence(student0)->ranking(student0)"),
    ("RA(prof0,student0)",
     "add teachingability(prof0)->popularity(prof0)",
     "add popularity(prof0)->teachingability(prof0)"),
    ("RA(prof0,student0)",
     "add ranking(student0)->intelligence(student0)",
     "add intelligence(student0)->ranking(student0)"),
}
# The points whose learned models differ: all three of UW's lattice.
UW_DIFFER = {"Registered(student0,course0)", "RA(prof0,student0)",
             "RA(prof0,student0)&Registered(student0,course0)"}


@pytest.fixture(scope="module")
def uw():
    return run_reference("UW", 0.25)


@pytest.fixture(scope="module")
def uw_ports():
    return {ex: run_port("UW", 0.25, ex) for ex in ("sparse", "dense")}


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_uw_counting_stats_equal(uw, uw_ports, ex):
    check_counting_stats(uw, uw_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_uw_family_scores_within_float32_bound(uw, uw_ports, ex):
    check_family_scores(uw, uw_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_uw_jax_search_on_port_scores_learns_port_models(uw, uw_ports, ex):
    check_jax_search_on_port_scores(uw, uw_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_uw_models_equal_but_for_near_ties(uw, uw_ports, ex):
    check_known_divergence(uw, uw_ports[ex], UW_FLIPS, UW_DIFFER)


def test_uw_dense_and_sparse_learn_the_same_models(uw_ports):
    a, b = uw_ports["sparse"], uw_ports["dense"]
    assert edges_of(a["models"]) == edges_of(b["models"])
    assert a["scores"] == b["scores"]
