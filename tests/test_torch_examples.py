"""``examples/discover_strategies_torch.py`` on the host: the paper's
Figs. 3-4 comparison through the port.  Its ``main`` runs PRECOUNT,
ONDEMAND, HYBRID and TUPLEID on UW at scale 0.5 with ``--device cpu``
(about 10 s); every strategy's edges and score equal those of
``repro_torch.core.discover_model`` with HYBRID and the example's search
arguments and those of the sparse executor's run, each strategy's run
reports the paper's counting metrics, and a planted strategy that learns
another model fails the example's own check."""

import dataclasses
import importlib.util
from pathlib import Path

import pytest

from repro_torch.core import discover_model, make_strategy, paper_benchmark_db

ROOT = Path(__file__).resolve().parents[1]
ARGV = ["UW", "0.5", "--device", "cpu"]


def _example():
    spec = importlib.util.spec_from_file_location(
        "discover_strategies_torch",
        ROOT / "examples" / "discover_strategies_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


@pytest.fixture(scope="module")
def results():
    return EX.main(ARGV)


@pytest.fixture(scope="module")
def hybrid():
    db = paper_benchmark_db("UW", seed=0, scale=0.5)
    models, _ = discover_model(db, make_strategy("HYBRID", device="cpu"),
                               device="cpu", **EX.SEARCH)
    return ({p: frozenset(m.edges()) for p, m in models.items()},
            sum(m.score for m in models.values()))


def test_the_example_runs_the_four_strategies(results):
    assert tuple(results) == EX.STRATEGIES == (
        "PRECOUNT", "ONDEMAND", "HYBRID", "TUPLEID")
    assert EX.SEARCH == dict(max_chain_length=2, max_parents=2)


def test_the_sparse_executor_learns_the_dense_ones_model(results):
    """``--executor sparse`` (the run phase 23 adds on the card, where
    the leaf hops are K1's) learns the default executor's model."""
    sparse = EX.main(ARGV + ["--executor", "sparse"])
    for name in EX.STRATEGIES:
        assert sparse[name]["edges"] == results[name]["edges"], name
        assert abs(sparse[name]["score"] - results[name]["score"]) <= \
            EX.SCORE_RTOL * abs(results[name]["score"])


@pytest.mark.parametrize("name", EX.STRATEGIES)
def test_each_strategy_learns_hybrids_model(results, hybrid, name):
    edges, score = hybrid
    assert results[name]["edges"] == edges
    assert sum(map(len, edges.values())) > 0
    assert abs(results[name]["score"] - score) <= EX.SCORE_RTOL * abs(score)


@pytest.mark.parametrize("name", EX.STRATEGIES)
def test_each_strategy_reports_its_counting_cost(results, name):
    st = results[name]["stats"]
    assert results[name]["wall_s"] > 0
    assert st["joins"] > 0 and st["peak_bytes"] > 0
    assert st["time_positive"] > 0


def test_a_strategy_with_another_model_fails_the_check(monkeypatch):
    """TUPLEID planted to drop one learned edge: the example's assertion
    names it."""
    real = EX.discover_model

    def planted(db, strategy, **kw):
        models, strat = real(db, strategy, **kw)
        if strategy.name == "TUPLEID":
            point = next(p for p, m in models.items() if m.edges())
            parents = dict(models[point].parents)
            child = next(c for c, ps in parents.items() if ps)
            parents[child] = frozenset(sorted(parents[child], key=str)[1:])
            models[point] = dataclasses.replace(models[point],
                                                parents=parents)
        return models, strat
    monkeypatch.setattr(EX, "discover_model", planted)
    with pytest.raises(AssertionError, match="TUPLEID"):
        EX.main(["UW", "0.25", "--device", "cpu"])
