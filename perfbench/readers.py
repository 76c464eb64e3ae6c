"""What the per-layer metrics' readers (``metrics/<name>.py``) share.

A reader takes the traced run's records and returns one number, or
``None`` where the records hold nothing for it (the metric is then left
out of the line).  The records: ``units`` (discoveries or answered
queries in the window), ``window_s``, ``launches`` (each kernel's
launches in the window, from ``ops.LAUNCHES``), ``k2_calls`` (each K2
call's edges, width, segments and whether it added into a given table)
and ``k2_spans`` (each K2 call's start and end on the host's clock),
``device`` (a :class:`perfbench.devtrace.DeviceReading`, ``None`` off
the card), ``device_kind``, and what the cell's mix adds (the
``discover`` kind: ``families``, ``positive_s``, ``negative_s``).
"""

from __future__ import annotations

from typing import Mapping, Optional

from .roofline import DEFAULT_PEAKS, PEAKS, k2_work, least_seconds

#: The counting path's kernels K1-K4, by ``ops.LAUNCHES`` key.
COUNTING_KERNELS = ("segsum_ones", "segsum_rows", "mobius", "bdeu")


def mean(rec: Mapping, key: str) -> Optional[float]:
    values = rec.get(key)
    return sum(values) / len(values) if values else None


def launches_per_unit(rec: Mapping) -> Optional[float]:
    """K1-K4 launches in the window over the discoveries or queries."""
    units, launches = rec.get("units"), rec.get("launches")
    if not units or launches is None:
        return None
    return sum(launches.get(k, 0) for k in COUNTING_KERNELS) / units


def k2_roofline(rec: Mapping) -> Optional[float]:
    """K2's least time over its device time, summed over every call of
    the window, in %.  K2's device time is that of every device event
    launched from within a K2 call (found by when it was launched, not by
    its kernels' names).  Nothing is read where the window made no K2
    call; where it made some and the trace gives device work to fewer of
    them, the reading is wrong, and this raises."""
    dev, calls = rec.get("device"), rec.get("k2_calls")
    if dev is None or not calls:
        return None
    seconds, _, hit = dev.launched_within(rec["k2_spans"])
    if hit != len(calls) or seconds <= 0:
        raise RuntimeError(f"k2_roofline: the window made {len(calls)} K2 "
                           f"calls and the trace gives device work to "
                           f"{hit} of them")
    peaks = PEAKS.get(rec.get("device_kind"), DEFAULT_PEAKS)
    least = sum(least_seconds(k2_work(*call), peaks) for call in calls)
    return 100.0 * least / seconds


def idle_pct(rec: Mapping) -> Optional[float]:
    """The share of the traced window in which nothing ran on the device."""
    dev = rec.get("device")
    if dev is None or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
