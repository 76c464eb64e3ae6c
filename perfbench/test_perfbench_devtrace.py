"""The reading of a traced window, on hand-made events: busy time is the
union of device intervals within the window, and the gaps between them
are named by what the host ran when each began."""

import pytest

from perfbench.devtrace import DeviceReading

NS = 1_000_000_000


def test_busy_is_the_union_within_the_window():
    r = DeviceReading([(10, 20, "a"), (15, 30, "b"), (50, 60, "a"),
                       (95, 105, "c")], [], (0, 100))
    assert r.window_s * NS == 100
    assert round(r.busy_s * NS) == 20 + 10 + 5
    assert r.seconds(lambda n: n == "a") == (20 / NS, 2)


def test_gaps_are_named_by_the_host_and_longest_first():
    r = DeviceReading([(10, 20, "k"), (60, 70, "k")],
                      [(15, 40, "cudaStreamSynchronize"),
                       (65, 80, "cudaLaunchKernel")], (0, 100))
    gaps = r.idle_gaps()
    assert [round(g[1] * NS) for g in gaps] == [40, 30, 10]
    assert gaps[0][0] == "cudaStreamSynchronize"
    assert gaps[1][0] == "cudaLaunchKernel"
    assert gaps[2][0] == "host (no traced op)"
    assert r.breakdown()["device_ops"] == [["k", 20 / NS]]


def test_window_from_the_device_where_the_clocks_disagree():
    far = 10 * NS
    r = DeviceReading([(far + 10, far + 20, "k")], [], (0, 100))
    assert r.window == (far + 10, far + 20) and r.busy_s == r.window_s


def test_work_is_found_by_when_it_was_launched():
    """Device events launched (by the host's clock) within a span count,
    whatever they are named; one launched between the spans does not."""
    r = DeviceReading([(100, 130, "any", 12), (140, 150, "other", 15),
                       (160, 170, "k", 25), (180, 200, "k", 41)],
                      [], (0, 300))
    seconds, names, hit = r.launched_within([(40, 45), (10, 20)])
    assert round(seconds * NS) == 30 + 10 + 20
    assert names == {"any": 1, "other": 1, "k": 1} and hit == 2
    # an event the trace links to no launch is nobody's
    r = DeviceReading([(100, 130, "k")], [], (0, 300))
    assert r.launched_within([(0, 1000)]) == (0.0, {}, 0)


def test_k2_roofline_reads_every_call_or_raises():
    from perfbench.readers import k2_roofline
    from perfbench.roofline import DEFAULT_PEAKS, k2_work, least_seconds
    calls = [(1000, 12, 50, False), (2000, 12, 50, False)]
    least = sum(least_seconds(k2_work(*c), DEFAULT_PEAKS) for c in calls)
    took = int(4 * least * NS)
    dev = DeviceReading([(100, 100 + took // 2, "a", 15),
                         (200, 200 + took // 2, "b", 35)], [], (0, NS))
    rec = {"device": dev, "k2_calls": calls, "k2_spans": [(10, 20),
                                                          (30, 40)],
           "device_kind": "no such card"}
    assert abs(k2_roofline(rec) - 25.0) < 0.01
    assert k2_roofline(dict(rec, k2_calls=[], k2_spans=[])) is None
    with pytest.raises(RuntimeError, match="2 K2 calls"):
        k2_roofline(dict(rec, k2_spans=[(10, 20), (50, 60)]))
