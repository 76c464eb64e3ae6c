"""K2's count of bytes and operations, against the bounds the kernel table
records at IMDb's largest call and VisualGenome's direct hop."""

import pytest

from perfbench.roofline import DEFAULT_PEAKS, k2_work, least_seconds


@pytest.mark.parametrize("edges,width,segments,bound_ms", [
    (2_743, 11_664, 27, 0.0386),
    (1_900_000, 12, 2_400_000, 0.0639),
])
def test_k2_least_time_reproduces_the_recorded_bounds(edges, width,
                                                      segments, bound_ms):
    work = k2_work(edges, width, segments)
    assert round(least_seconds(work) * 1e3, 4) == bound_ms
    # bytes bind K2: one addition a row element is far below the peak
    assert work.ops / DEFAULT_PEAKS["fp32_ops_per_s"] < \
        work.bytes / DEFAULT_PEAKS["hbm_bytes_per_s"]


def test_k2_work_counts_inputs_once_and_the_table_once():
    work = k2_work(10, 3, 4)
    assert work.bytes == 4 * 10 + 4 * 10 * 3 + 4 * 4 * 3
    assert work.ops == 30
    # a call that adds into a given table reads it too
    assert k2_work(10, 3, 4, accumulate=True).bytes == work.bytes + 4 * 12
