"""The comparison that decides ``correct`` fails what it must: whole runs
of both cells on the CPU at a small scale (the harness's look for a card
skipped), sound, with a kernel's answer altered where the program
produces it, with the search's choice cut short, and with the
lower-precision control in the program's place."""

import pytest
import torch

from perfbench import harness

IMDB = ("imdb_synth.hybrid.discover", 0.0005)
VG = ("vg_synth.hybrid.discover", 0.00005)
CELLS = [IMDB, VG]


def run(cell, seed=5, seconds=0.3, control=None):
    name, scale = cell
    result, lines = harness.run(name, seed, seconds, False, device="cpu",
                                scale=scale, control=control)
    return result, lines


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_sound_runs_are_correct(cell):
    result, lines = run(cell)
    assert result["correct"], lines
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) >= {"setup_s"}


def _scaled(fn, factor):
    def wrong(*args, **kwargs):
        return fn(*args, **kwargs) * factor
    return wrong


@pytest.mark.parametrize("target,number", [
    ("segsum_rows", "table_gap"),       # K2: positive counts
    ("mobius", "table_gap"),            # K3: negative groundings
    ("bdeu", "score_gap"),              # K4: scores
])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_discovery_with_an_altered_kernel_is_not_correct(monkeypatch, cell,
                                                         target, number):
    from repro_torch.kernels import ops
    monkeypatch.setattr(ops, target, _scaled(getattr(ops, target), 1.001))
    result, lines = run(cell)
    assert not result["correct"], lines
    check = result["checks"][number]
    assert check["value"] > check["limit"]


@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_discovery_with_an_altered_choice_is_not_correct(monkeypatch, cell):
    """A search that stops one move early: its structure is no longer a
    local optimum under the reference's scores."""
    import repro_torch.core.search as search_mod
    climb = search_mod.StructureSearch.climb_point

    def early(self, point, init_parents=None):
        saved = self.max_moves
        self.max_moves = 1
        try:
            return climb(self, point, init_parents)
        finally:
            self.max_moves = saved

    monkeypatch.setattr(search_mod.StructureSearch, "climb_point", early)
    result, lines = run(cell)
    assert not result["correct"], lines
    assert result["checks"]["choice_gap"]["value"] > \
        result["checks"]["choice_gap"]["limit"]


@pytest.mark.parametrize("control", ["bfloat16", "rounded"])
@pytest.mark.parametrize("cell", CELLS, ids=lambda c: c[0])
def test_the_control_is_not_correct(cell, control):
    result, lines = run(cell, control=control)
    assert not result["correct"], lines
    assert result["checks"]["table_gap"]["value"] > \
        result["checks"]["table_gap"]["limit"]


def test_reference_runs_in_float64():
    from perfbench import reference, synth
    cfg = harness.data_file("configs", "imdb_synth")
    ref = reference.Reference(cfg, synth.generate(cfg, 1, 0.0002))
    _, table = ref.complete(("imdb_R0",))
    assert table.dtype == torch.float64
