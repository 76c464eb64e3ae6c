"""The slice as a whole on the IMDb stand-in at scale 0.01: the checks of
``test_torch_discovery`` (see its docstring), HYBRID over both executors.

IMDb's relationship indicators count cross products of entity sets, so its
family scores sum lgamma terms of up to about 4e10 in float32: there the
error bound, and the gap a near tie may leave between the two packages'
deltas, is hundreds of units of log likelihood, for the JAX package as for
the port.
"""

import jax  # noqa: F401
import pytest

from tests.test_torch_data import edges_of
from tests.test_torch_discovery import (check_counting_stats,
                                        check_family_scores,
                                        check_jax_search_on_port_scores,
                                        check_known_divergence,
                                        run_port, run_reference)

R0 = "imdb_R0(imdb_e00,imdb_e10)"
R1 = "imdb_R1(imdb_e10,imdb_e20)"
R2 = "imdb_R2(imdb_e20,imdb_e00)"
# Every decision where the two packages' searches part on IMDb at scale
# 0.01 (the same over both executors): (point, JAX move, port move).
IMDB_FLIPS = {
    (R0, "add a1_2(imdb_e10)->a1_0(imdb_e10)",
     "add a1_0(imdb_e10)->a1_2(imdb_e10)"),
    (R0, "add a0_1(imdb_e00)->a0_2(imdb_e00)",
     "add a0_2(imdb_e00)->a0_1(imdb_e00)"),
    (R1, "add a1_2(imdb_e10)->a1_0(imdb_e10)",
     "add a1_0(imdb_e10)->a1_2(imdb_e10)"),
    (R2, "add a0_1(imdb_e00)->a0_2(imdb_e00)",
     "add a0_2(imdb_e00)->a0_1(imdb_e00)"),
    (f"{R0}&{R2}", "stop", "add imdb_R0?->imdb_R2?"),
    (f"{R0}&{R2}", "del imdb_R0?->imdb_R2?", "stop"),
}
# The points whose learned models differ: all six of IMDb's lattice.
IMDB_DIFFER = {R0, R1, R2, f"{R0}&{R1}", f"{R0}&{R2}", f"{R1}&{R2}"}


@pytest.fixture(scope="module")
def imdb():
    return run_reference("IMDb", 0.01)


@pytest.fixture(scope="module")
def imdb_ports():
    return {ex: run_port("IMDb", 0.01, ex) for ex in ("sparse", "dense")}


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_imdb_counting_stats_equal(imdb, imdb_ports, ex):
    check_counting_stats(imdb, imdb_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_imdb_family_scores_within_float32_bound(imdb, imdb_ports, ex):
    check_family_scores(imdb, imdb_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_imdb_jax_search_on_port_scores_learns_port_models(imdb, imdb_ports,
                                                           ex):
    check_jax_search_on_port_scores(imdb, imdb_ports[ex])


@pytest.mark.parametrize("ex", ["sparse", "dense"])
def test_imdb_models_equal_but_for_near_ties(imdb, imdb_ports, ex):
    check_known_divergence(imdb, imdb_ports[ex], IMDB_FLIPS, IMDB_DIFFER)


def test_imdb_dense_and_sparse_learn_the_same_models(imdb_ports):
    a, b = imdb_ports["sparse"], imdb_ports["dense"]
    assert edges_of(a["models"]) == edges_of(b["models"])
    assert a["scores"] == b["scores"]
