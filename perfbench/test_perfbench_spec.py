"""``BENCHMARK.json`` against the benchmark's rules, and the harness
driven by data: every piece is found by name, and a configuration, a
traffic mix, a kind of traffic and a metric added as files are picked up
with no edit to a file that exists."""

import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "perfbench/run.py"]
    assert spec["paths"] == ["perfbench"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_names_units_and_lines(spec):
    names = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in spec[key]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((key, entry["name"]))
            for field in ("why", "layer", "source"):
                text = entry.get(field)
                if text is not None and key != "end_to_end" \
                        and not (key == "per_layer" and field == "source"):
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text, (entry["name"], field)
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    assert len(set(names)) == len(names)
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16


def test_entries_have_just_their_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and m["better"] in ("lower", "higher")
        if "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"] for w in spec["workloads"]}
    for cell in cells:
        mine = [m["name"] for m in harness.cell_metrics(spec, cell,
                                                        "end_to_end")]
        assert "setup_s" in mine and len(mine) >= 2
        layers = harness.cell_metrics(spec, cell, "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in mine, (cell, m["name"])
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}


def test_check_fits_the_day(spec):
    """A full check with the full 24 cells: 2 + 14 runs a cell, each given
    the window and 60 s, each cell 180 s to compile, 1,200 s spare."""
    runs = 2 + 14 * 24
    assert runs * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_each_piece_is_found_by_name(spec):
    for c in spec["configs"]:
        assert c["file"] == f"perfbench/configs/{c['name']}.json"
        cfg = harness.data_file("configs", c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) <= {"table_gap", "score_gap", "choice_gap"}
    for w in spec["workloads"]:
        traffic = harness.data_file("traffic", w["traffic"])
        assert issubclass(harness.mix_class(traffic["kind"]),
                          harness.generator.Mix)
    for m in spec["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read)
    for m in spec["end_to_end"]:
        for cell in m.get("workloads", []):
            w = harness.find(spec, "workloads", cell)
            kind = harness.data_file("traffic", w["traffic"])["kind"]
            assert harness.mix_class(kind).e2e_name == m["name"]


def test_files_under_paths_are_named_from_names():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


#: A kind of traffic that only a test knows: every lattice point's
#: complete table from a prepared strategy, over and over.
TABLES_KIND = '''
import time

from perfbench import compare, synth
from perfbench.generator import Mix, build_db, host_table, rels_of


class Tables(Mix):
    e2e_name = "tables_per_s"

    def setup(self):
        from repro_torch.core import build_lattice
        self.arrays = synth.generate(self.cfg, self.ctx.seed, self.ctx.scale)
        db = build_db(self.cfg, self.arrays)
        self.points = list(build_lattice(
            db.schema, self.search_cfg["max_chain_length"]))
        self.keeps = [tuple(p.all_ct_vars(db.schema, include_rind=True))
                      for p in self.points]
        self.strategy = self.make_strategy()
        self.strategy.prepare(db, self.points)

    def window(self, seconds):
        t0, self.kept = time.perf_counter(), []
        while time.perf_counter() - t0 < seconds or not self.kept:
            for point, keep in zip(self.points, self.keeps):
                self.attempted += 1
                self.kept.append((point, self.strategy.family_ct(point,
                                                                 keep)))
        elapsed = time.perf_counter() - t0
        self.e2e = len(self.kept) / elapsed
        self.records.update(window_s=elapsed, units=len(self.kept))

    def collect(self):
        self.tables = [(rels_of(p),) + host_table(t)
                       for p, t in self.kept[:len(self.points)]]
        del self.kept, self.strategy

    def check(self, verdict: compare.Verdict, ref):
        for rels, axes, got in self.tables:
            verdict.read("table_gap",
                         compare.table_gap(got, ref.family(rels, axes)))


MIX = Tables
'''


def test_added_files_are_picked_up_without_editing(tmp_path, spec):
    """A copy of the benchmark gains a configuration, a traffic mix, a
    cell and a per-layer metric by new files and new entries only; a run
    on the CPU finds them and reports the new metric."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    cfg = harness.data_file("configs", "imdb_synth")
    cfg.update(name="imdb_small", entities=cfg["entities"][:2],
               relationships=cfg["relationships"][:1])
    (bench / "configs" / "imdb_small.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "hybrid.discover-small.json").write_text(
        json.dumps(dict(harness.data_file("traffic", "hybrid.discover"),
                        check_tables=8)))
    (bench / "metrics" / "window.units.py").write_text(
        "def read(rec):\n    return float(rec['units'])\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append(dict(spec["configs"][0], name="imdb_small",
                               file="perfbench/configs/imdb_small.json"))
    new["workloads"].append({"name": "small.discover", "config": "imdb_small",
                             "traffic": "hybrid.discover-small", "chips": 1,
                             "why": "a test's cell"})
    for m in new["end_to_end"]:
        if m["name"] in ("discovery_s",):
            m["workloads"].append("small.discover")
    new["per_layer"].append({"name": "window.units", "unit": "discoveries",
                             "better": "higher", "source": "program_counter",
                             "layer": "search", "moves": "discovery_s",
                             "workloads": ["small.discover"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    result, lines = harness.run("small.discover", 11, 0.2, True,
                                device="cpu", scale=0.0005,
                                spec_root=tmp_path, here=bench)
    assert result["correct"], lines
    assert result["metrics"]["window.units"]["value"] >= 1
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())


def test_a_new_kind_of_traffic_is_picked_up_without_editing(tmp_path, spec):
    """A copy of the benchmark gains a kind of traffic (its code in
    ``kinds/<kind>.py``), a traffic file naming it, an end-to-end metric
    and a cell by new files and new entries only; a whole run on the CPU
    drives the program with it and checks its answers."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__"))
    before = {p.relative_to(bench): p.read_bytes()
              for p in bench.rglob("*") if p.is_file()}
    (bench / "kinds" / "tables.py").write_text(TABLES_KIND)
    (bench / "traffic" / "hybrid.tables.json").write_text(json.dumps(
        {"kind": "tables", "why": "a test's mix", "strategy": "HYBRID"}))
    new = json.loads(json.dumps(spec))
    new["workloads"].append({"name": "imdb_synth.tables",
                             "config": "imdb_synth",
                             "traffic": "hybrid.tables", "chips": 1,
                             "why": "a test's cell"})
    new["end_to_end"].append({"name": "tables_per_s", "unit": "tables/s",
                              "better": "higher", "bound": 0.05,
                              "source": "host_clock",
                              "workloads": ["imdb_synth.tables"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new))
    result, lines = harness.run("imdb_synth.tables", 12, 0.1, False,
                                device="cpu", scale=0.0005,
                                spec_root=tmp_path, here=bench)
    assert result["correct"], lines
    assert result["metrics"]["tables_per_s"]["value"] > 0
    assert set(result["metrics"]) == {"tables_per_s", "setup_s"}
    after = {p.relative_to(bench): p.read_bytes()
             for p in bench.rglob("*") if p.is_file()
             and "__pycache__" not in p.parts}
    assert all(after[k] == v for k, v in before.items())
