"""The traced run's window under ``torch.profiler``, and its reading.

The window runs as the profiler schedule's active step, after a warm-up
step: the profiler drops device events at the start of a trace, and the
warm-up step takes that loss.  Only CUDA activity is traced (the device's
kernels and copies, and the host's CUDA runtime calls): tracing every
host operator of a host-bound window costs tens of seconds to collect
and slows the window itself.  The reading works on the trace's raw
events: every device event but the annotations counts as busy, the busy
time is the union of their intervals within the window, and each idle
gap is named by the host's runtime call running when it began.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Tuple

import torch

#: Host pause before the kept step, so the warm-up's events are settled.
PAUSE_S = 0.1
#: Entries of each ``breakdown`` list.
TOP = 10
#: Host events looked back through when naming an idle gap.
LOOKBACK = 20000
#: How far the trace's clock may stray from the host's at the window's
#: ends before the window is taken from the device events instead.
SKEW_NS = 50_000_000


class TracedWindow:
    """``with TracedWindow(): <window>`` traces the window; afterwards
    :meth:`read` gives its device reading."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(
            activities=[ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self.span = (0, 0)

    def __enter__(self) -> "TracedWindow":
        self.prof.__enter__()
        torch.ones(1024, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(PAUSE_S)
        self.prof.step()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        torch.cuda.synchronize()
        self.span = (self.start_ns, time.time_ns())
        self.prof.step()
        self.prof.__exit__(*exc)
        return False

    def read(self) -> "DeviceReading":
        from torch.autograd import DeviceType
        device, host, called = [], [], {}
        for e in self.prof.profiler.kineto_results.events():
            start, dur = e.start_ns(), e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((start, start + dur, e.name(),
                                   e.correlation_id()))
            else:
                host.append((start, start + dur, e.name()))
                called[e.correlation_id()] = start
        device = [(s, e, name, called.get(corr, -1) if corr else -1)
                  for s, e, name, corr in device]
        return DeviceReading(device, host, self.span)


class DeviceReading:
    """Device events ``(start_ns, end_ns, name, launched_ns)`` of a traced
    window (``launched_ns``: when the host's runtime call that launched
    the event began, -1 where the trace does not link one; may be left
    out)."""

    def __init__(self, device: List[Tuple], host: List[Tuple[int, int, str]],
                 window: Tuple[int, int]):
        """``window``: the host's clock (ns since the epoch, the trace's
        clock) at the window's start and end.  Where the device's events
        do not lie within it (give or take ``SKEW_NS``), the two clocks
        disagree, and the window is taken from the first device event to
        the last."""
        self.device = sorted(tuple(e) if len(e) == 4 else (*e, -1)
                             for e in device)
        self.host = sorted(host)
        if self.device and not (
                window[0] - SKEW_NS <= self.device[0][0]
                and self.device[-1][1] <= window[1] + SKEW_NS):
            window = (self.device[0][0], self.device[-1][1])
        self.window = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def _busy_intervals(self) -> List[Tuple[int, int]]:
        merged: List[List[int]] = []
        lo, hi = self.window
        for s, e, *_ in self.device:
            s, e = max(s, lo), min(e, hi)
            if s >= e:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy_intervals()) / 1e9

    def seconds(self, match) -> Tuple[float, int]:
        """Summed device seconds and count of the events ``match(name)``
        accepts."""
        picked = [e - s for s, e, name, _ in self.device if match(name)]
        return sum(picked) / 1e9, len(picked)

    def launched_within(self, spans: List[Tuple[int, int]]
                        ) -> Tuple[float, Dict[str, int], int]:
        """The device work launched from within ``spans`` (host intervals
        ``(start_ns, end_ns)`` on the trace's clock, apart): its summed
        device seconds, its events by name, and how many of the spans
        launched at least one of them."""
        spans = sorted(spans)
        starts = [s for s, _ in spans]
        hit = [False] * len(spans)
        total, names = 0, {}
        for s, e, name, at in self.device:
            i = bisect.bisect_right(starts, at) - 1
            if at >= 0 and i >= 0 and at <= spans[i][1]:
                total += e - s
                names[name] = names.get(name, 0) + 1
                hit[i] = True
        return total / 1e9, names, sum(hit)

    def top_ops(self) -> List[list]:
        by_name: Dict[str, int] = {}
        for s, e, name, _ in self.device:
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def idle_gaps(self) -> List[list]:
        """The longest gaps in the window with nothing on the device, each
        named by what the host was running when it began."""
        lo, hi = self.window
        gaps, at = [], lo
        for s, e in self._busy_intervals():
            if s > at:
                gaps.append((s - at, at))
            at = max(at, e)
        if hi > at:
            gaps.append((hi - at, at))
        gaps.sort(reverse=True)
        starts = [h[0] for h in self.host]
        out = []
        for length, begin in gaps[:TOP]:
            i = bisect.bisect_right(starts, begin)
            name = "host (no traced op)"
            for j in range(i - 1, max(-1, i - 1 - LOOKBACK), -1):
                s, e, n = self.host[j]
                if e >= begin:
                    name = n
                    break
            out.append([name[:120], length / 1e9])
        return out

    def breakdown(self) -> dict:
        return {"device_ops": self.top_ops(), "idle_gaps": self.idle_gaps()}
