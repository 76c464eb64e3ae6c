"""One run of one cell: set-up, the measured window, the check, the
result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``, whose ``kind`` names the code that drives
the program, ``kinds/<kind>.py``; see :mod:`perfbench.generator`) and
each per-layer metric's reader (``metrics/<metric>.py``, a
``read(records)`` that returns a number, or ``None`` where it finds
nothing to read).  :func:`run` takes a device, so
the tests drive a whole run on the CPU at a small scale; ``run.py`` is
the entry that insists on the card.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional, Tuple

import torch

from . import compare, generator
from .reference import Reference, Rounded

ROOT = Path(__file__).resolve().parent
#: Top-level modules that no run may load (compared by whole name).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find(spec: dict, key: str, name: str) -> dict:
    for entry in spec[key]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"{key} has no {name!r}")


def data_file(folder: str, name: str, here: Path = ROOT) -> dict:
    """``configs/<name>.json`` or ``traffic/<name>.json``."""
    return json.loads((here / folder / f"{name}.json").read_text())


def code_file(folder: str, name: str, here: Path = ROOT) -> ModuleType:
    """The module ``<folder>/<name>.py`` (``metrics`` or ``kinds``),
    loaded from its path (names hold dots and dashes)."""
    path = here / folder / f"{name}.py"
    tag = name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{folder}_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, here: Path = ROOT) -> ModuleType:
    """The reader module ``metrics/<name>.py``."""
    return code_file("metrics", name, here)


def mix_class(kind: str, here: Path = ROOT) -> type:
    """The traffic kind ``kinds/<kind>.py``'s :class:`generator.Mix`."""
    cls = code_file("kinds", kind, here).MIX
    if not issubclass(cls, generator.Mix):
        raise TypeError(f"kinds/{kind}.py: MIX is no generator.Mix")
    return cls


def cell_metrics(spec: dict, cell: str, key: str) -> List[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    return [m for m in spec[key]
            if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


class Probe:
    """The instrumentation around the window: the kernels' launch counts
    always; with ``trace``, each K2 call's shape and its span on the
    host's clock (``ops.segsum_rows`` is wrapped for the window), by
    which the trace's reading finds K2's device work."""

    def __init__(self, trace: bool):
        from repro_torch.kernels import ops
        self.ops = ops
        self.k2: List[Tuple[int, int, int, bool]] = []
        self.k2_spans: List[Tuple[int, int]] = []
        self.launches0 = dict(ops.LAUNCHES)
        self.plain = ops.segsum_rows
        if trace:
            ops.segsum_rows = self._k2_spy

    def _k2_spy(self, seg, rows, num_segments, out=None):
        if not (rows.is_cuda and rows.numel() and num_segments):
            return self.plain(seg, rows, num_segments, out)
        began = time.time_ns()
        result = self.plain(seg, rows, num_segments, out)
        self.k2_spans.append((began, time.time_ns()))
        self.k2.append((int(rows.shape[0]), int(rows.shape[1]),
                        int(num_segments), out is not None))
        return result

    def remove(self) -> Dict[str, int]:
        self.ops.segsum_rows = self.plain
        return {k: v - self.launches0.get(k, 0)
                for k, v in self.ops.LAUNCHES.items()}


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", scale: float = 1.0,
        t_start: Optional[float] = None, spec_root: Path = ROOT.parent,
        here: Path = ROOT, control: Optional[str] = None
        ) -> Tuple[dict, List[str]]:
    """One run of ``workload``; returns the result line's object and the
    lines that name each number compared beside its limit.  ``control``
    (``"bfloat16"`` or ``"rounded"``; ``perfbench/readings.py`` only)
    puts the reference in that precision in the program's place: counting
    in bfloat16 throughout, or in float64 with each table rounded to
    bfloat16."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec(spec_root)
    cell = find(spec, "workloads", workload)
    cfg = data_file("configs", cell["config"], here)
    traffic = data_file("traffic", cell["traffic"], here)
    ctx = generator.Context(cfg, traffic, seed, device, scale)
    mix = mix_class(traffic["kind"], here)(ctx)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    mix.setup()
    ctx.sync()
    setup_s = time.perf_counter() - t_start
    probe = Probe(trace)
    reading = None
    try:
        if control is not None:
            low = Reference(cfg, mix.arrays, device=device,
                            dtype=torch.bfloat16)
            if control == "rounded":
                low = Rounded(Reference(cfg, mix.arrays, device=device))
            mix.run_control(seconds, low)
            del low
        elif trace and on_card:
            from .devtrace import TracedWindow
            with TracedWindow() as traced:
                mix.window(seconds)
            reading = traced.read()
            k2_s, k2_names, _ = reading.launched_within(probe.k2_spans)
            mix.notes.append(f"trace: {len(probe.k2)} K2 calls launched "
                             f"{sum(k2_names.values())} device events "
                             f"({k2_s!r} s): "
                             f"{[(n[:60], c) for n, c in k2_names.items()]}")
        else:
            mix.window(seconds)
    finally:
        launches = probe.remove()
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    if control is None:
        mix.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = compare.Verdict(cfg["limits"])
    for err in mix.errors:
        verdict.fault(err)
    ref = Reference(cfg, mix.arrays, device=device)
    mix.check(verdict, ref)
    del ref

    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    records = dict(mix.records, launches=launches, k2_calls=probe.k2,
                   k2_spans=probe.k2_spans, device=reading, device_kind=kind, setup_s=setup_s)
    metrics: Dict[str, dict] = {}
    if trace:
        for m in cell_metrics(spec, workload, "per_layer"):
            value = metric_reader(m["name"], here).read(records)
            if value is not None and math.isfinite(value):
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        own = {"setup_s": setup_s, mix.e2e_name: mix.e2e}
        for m in cell_metrics(spec, workload, "end_to_end"):
            metrics[m["name"]] = {"value": own[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    if reading is not None:
        dev.update(busy_s=reading.busy_s, window_s=reading.window_s)
    result = {"correct": verdict.correct, "attempted": mix.attempted,
              "failed": mix.failed, "metrics": metrics, "device": dev}
    if reading is not None:
        result["breakdown"] = reading.breakdown()
    result["checks"] = verdict.checks()
    return result, mix.notes + verdict.lines()
