"""The readers of the program's spans: self times and the innermost span
on hand-made spans and device events, the checks that make a reading
raise, and a whole traced run on the CPU inside a CPU profiler."""

import pytest
import torch

from perfbench import harness, span_readers
from perfbench import spans as sp
from perfbench.devtrace import DeviceReading

#: Spans in ns: two discoveries, the first with a hop and a collection
#: inside it, and a child that overlaps its sibling.
SPANS = [
    (1, None, "discover.run", 0, 100, {"points": 2}),
    (2, 1, "exec.hop", 10, 40, {"kernel": "K1"}),
    (3, 2, "host.gc", 20, 25, {"generation": 0}),
    (4, 1, "exec.upload", 30, 60, {"bytes": 4000}),
    (5, None, "discover.run", 120, 150, None),
    (6, 5, "exec.upload", 130, 135, {"bytes": 2000}),
]


def test_self_time_leaves_out_the_union_of_the_children():
    own = sp.self_ns(SPANS)
    assert own == {1: 100 - 50, 2: 30 - 5, 3: 5, 4: 30, 5: 25, 6: 5}
    assert sp.seconds(SPANS, ["exec.upload"]) == 35e-9
    assert sp.seconds(SPANS, ["discover.run"], own) == 75e-9
    assert sp.attr_sum(SPANS, "exec.upload", "bytes") == 6000


def test_innermost_span_at_each_instant():
    assert sp.innermost(SPANS) == [
        (0, 10, "discover.run"), (10, 20, "exec.hop"), (20, 25, "host.gc"),
        (25, 30, "exec.hop"), (30, 60, "exec.upload"),
        (60, 100, "discover.run"), (100, 120, None),
        (120, 130, "discover.run"), (130, 135, "exec.upload"),
        (135, 150, "discover.run")]
    # of two spans started together, the one that ends first is inner
    two = [(1, None, "outer", 0, 10, None), (2, 1, "inner", 0, 4, None)]
    assert sp.innermost(two) == [(0, 4, "inner"), (4, 10, "outer")]
    assert sp.innermost([]) == []


def test_idle_time_by_innermost_span():
    pieces = sp.innermost(SPANS)
    idle = [(5, 15), (22, 30), (100, 125), (140, 160)]
    assert sp.time_by_name(pieces, idle) == {
        "discover.run": 5 + 5 + 10, "exec.hop": 5 + 5, "host.gc": 3,
        None: 20 + 10}
    assert sp.gaps([(10, 20), (15, 30), (50, 60)], (0, 55)) == [
        (0, 10), (30, 50)]
    assert sp.union([(3, 4), (0, 2), (1, 3), (5, 5)]) == [(0, 4)]


def _tracer(monkeypatch, spans, capacity=64):
    """A tracer holding ``spans`` (ns), put where the readers look."""
    from repro_torch.obs import profile
    from repro_torch.obs.trace import Tracer
    tracer = Tracer(capacity=capacity)
    tracer.offset = 0.0                   # record's readings kept as given
    ctx = {}
    for sid, parent, name, s, e, attrs in spans:
        ctx[sid] = tracer.record(name, s / 1e9, e / 1e9,
                                 parent=ctx.get(parent), **(attrs or {}))
    monkeypatch.setattr(profile, "profiled_tracer", lambda: tracer,
                        raising=False)
    return tracer


def _device(window=(0, 200)):
    """Busy 0-5, 15-22, 30-100, 125-140 and 160-200 of the window."""
    busy = [(0, 5), (15, 22), (30, 100), (125, 140), (160, 200)]
    return DeviceReading([(s, e, "k", -1) for s, e in busy], [], window)


def test_readers_on_hand_made_spans(monkeypatch):
    _tracer(monkeypatch, SPANS)
    rec = {"units": 2, "device": _device()}
    assert span_readers.span_seconds(rec, ["exec.upload"]) == 35e-9 / 2
    assert span_readers.self_seconds(rec, ["exec.hop"]) == 25e-9 / 2
    assert span_readers.attr_per_unit(rec, "exec.upload", "bytes") == 3000
    idle = span_readers.idle_by_innermost(rec)
    assert idle == {"discover.run": 20, "exec.hop": 10, "host.gc": 3,
                    None: 30}
    assert span_readers.idle_unnamed_pct(rec) == pytest.approx(
        100.0 * 50 / 63)
    # off the card every resident span is read, and the idle share is not
    assert span_readers.span_seconds({"units": 2}, ["exec.upload"]) \
        == 35e-9 / 2
    assert span_readers.idle_unnamed_pct({"units": 2}) is None
    # on the card, the window keeps the spans that lie inside it
    inner = {"units": 1, "device": _device((110, 200))}
    assert span_readers.span_seconds(inner, ["exec.upload"]) == 5e-9


def test_readers_raise_on_a_dropped_span_or_a_root_count(monkeypatch):
    _tracer(monkeypatch, SPANS, capacity=4)
    with pytest.raises(RuntimeError, match="dropped 2"):
        span_readers.span_seconds({"units": 2}, ["exec.upload"])
    _tracer(monkeypatch, SPANS)
    with pytest.raises(RuntimeError, match="2 discover.run spans and 3"):
        span_readers.span_seconds({"units": 3}, ["exec.upload"])


def test_readers_find_nothing_without_the_programs_spans(monkeypatch):
    from repro_torch.obs import profile
    rec = {"units": 2, "device": _device()}
    monkeypatch.delattr(profile, "profiled_tracer")
    assert span_readers.span_seconds(rec, ["exec.upload"]) is None
    assert span_readers.idle_unnamed_pct(rec) is None
    _tracer(monkeypatch, [])
    assert span_readers.self_seconds(rec, ["exec.hop"]) is None


SPAN_METRICS = {"search.self_s", "mobius.blocks_s", "exec.host_ids_s",
                "exec.upload_s", "exec.upload_mb"}


def _profiled_windows(monkeypatch):
    """Each run's window inside a CPU profiler (as the card's traced run
    profiles its window alone), the profiled tracer emptied first."""
    from repro_torch.obs.profile import profiled_tracer
    plain = harness.mix_class

    def mix_class(kind, here=harness.ROOT):
        base = plain(kind, here)

        class Profiled(base):
            def window(self, seconds):
                profiled_tracer().clear()
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CPU]):
                    super().window(seconds)

        return Profiled

    monkeypatch.setattr(harness, "mix_class", mix_class)


def test_a_profiled_cpu_run_reports_the_span_metrics(monkeypatch):
    _profiled_windows(monkeypatch)
    result, lines = harness.run("imdb_synth.hybrid.discover", 2_400_000_017,
                                0.2, True, device="cpu", scale=0.0005)
    assert result["correct"], lines
    got = result["metrics"]
    assert SPAN_METRICS <= set(got)
    assert "device.idle_unnamed_pct.discover" not in got   # needs the card
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, name
    assert got["exec.upload_mb"]["unit"] == "MB"
    assert got["search.families"]["value"] > 0


def test_an_unprofiled_run_reports_no_span_metric():
    from repro_torch.obs.profile import profiled_tracer
    profiled_tracer().clear()
    result, lines = harness.run("imdb_synth.hybrid.discover", 3, 0.1, True,
                                device="cpu", scale=0.0005)
    assert result["correct"], lines
    assert not SPAN_METRICS & set(result["metrics"])
    assert profiled_tracer().records() == []
