"""``SparseExecutor.hop_cells`` and the reader of
``exec.hop_cells.discover``: the counter equals the segments times width
of the ``exec.hop`` spans and of every hop of the plans a discovery
evaluated, on the IMDb stand-in and on TPC-H at test scale."""

import json
import math
from pathlib import Path

import pytest

from perfbench import harness, synth, tpch
from perfbench.generator import build_db

CONFIGS = Path(__file__).resolve().parent / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def node_cells(db, node):
    """Cells of the hop outputs under ``node`` and the width of its
    message: a hop writes its parent's entities times its codes (the
    child's own codes times the edge attributes' codes) times the width
    of the child's message, which is 1 at a leaf and the product of its
    hops' codes and widths above one."""
    cells, width = 0, 1
    for hop in node.hops:
        below, w = node_cells(db, hop.child_node)
        ds = hop.child_node.own.card * math.prod(cv.card
                                                 for cv in hop.edge_attrs)
        cells += below + db.entities[hop.parent.etype].size * ds * w
        width *= ds * w
    return cells, width


def discover_traced(monkeypatch, db, search):
    """A HYBRID discovery on the sparse executor with a tracer, the plans
    it evaluated and the databases they read."""
    from repro_torch.core import discover_model, make_strategy
    from repro_torch.core.executors import SparseExecutor
    from repro_torch.obs.trace import Tracer
    evaluated = []
    plain = SparseExecutor._evaluate

    def spy(self, dbs, plans, stats):
        evaluated.extend(zip(dbs, plans))
        return plain(self, dbs, plans, stats)
    monkeypatch.setattr(SparseExecutor, "_evaluate", spy)
    strategy = make_strategy("HYBRID", executor="sparse", device="cpu")
    tracer = Tracer(capacity=1 << 18)
    strategy.set_tracer(tracer)
    discover_model(db, strategy, max_chain_length=search["max_chain_length"],
                   max_parents=search["max_parents"], ess=search["ess"],
                   device="cpu")
    assert tracer.snapshot()["dropped"] == 0
    return strategy.engine.executor, tracer, evaluated


@pytest.mark.parametrize("name,scale", [("imdb_synth", 0.0005),
                                        ("tpch_sf1", 0.002)])
def test_hop_cells_counts_every_hop_output_cell(monkeypatch, name, scale):
    cfg = config(name)
    gen = tpch.generate if name.startswith("tpch") else synth.generate
    db = build_db(cfg, gen(cfg, 41, scale))
    ex, tracer, evaluated = discover_traced(monkeypatch, db, cfg["search"])
    hops = [r for r in tracer.records() if r.name == "exec.hop"]
    assert hops and ex.hop_cells > 0
    assert ex.hop_cells == sum(r.attrs["segments"] * r.attrs["width"]
                               for r in hops)
    assert ex.hop_cells == sum(node_cells(d, p.root)[0]
                               for d, p in evaluated)


def _rec(spans, units):
    return {"units": units, "device": None, "spans": spans}


def test_reader_reads_the_spans_cells(monkeypatch):
    """The reader sums the ``exec.hop`` spans' segments times width a
    discovery, in millions; a window with no ``exec.hop`` span, or no
    spans, gives nothing."""
    reader = harness.metric_reader("exec.hop_cells.discover")
    spans = [(1, None, "discover.run", 0, 10, {}),
             (2, 1, "exec.hop", 1, 2, {"segments": 4_000_000, "width": 1}),
             (3, 1, "exec.hop", 3, 4, {"segments": 1_000_000, "width": 2}),
             (4, 1, "exec.root", 5, 6, {"segments": 9, "width": 9}),
             (5, None, "discover.run", 11, 20, {})]
    monkeypatch.setattr(reader, "window_spans", lambda rec: rec["spans"])
    assert reader.read(_rec(spans, 2)) == pytest.approx(3.0)
    no_hops = [s for s in spans if s[2] != "exec.hop"]
    assert reader.read(_rec(no_hops, 2)) is None
    monkeypatch.setattr(reader, "window_spans", lambda rec: None)
    assert reader.read(_rec(spans, 2)) is None
