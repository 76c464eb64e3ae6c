"""Where K1 (``segsum_ones``) and K4 (``bdeu``) spend their device time on
the IMDb main path, on one CUDA card.

Run from the repository root:  python3 scripts/profile_k1_k4.py [--src DIR]

(``--src``: measure the ``repro_torch`` package under DIR, another
checkout's ``src``, with this script and this checkout's ``chip_smoke``
helpers: a parent commit and its change on one card.)

Runs HYBRID discovery over the sparse executor on IMDb at ``chip_smoke``'s
scale once while recording the shape of every K1 call ``(E, P)`` and every
K4 call ``(B, q, r)``, and prints their distributions.  Then, under
``torch.profiler``, one more run: the device time of K1's and K4's kernels
by name (``K1_NAMES``, ``K4_NAMES``) beside the device's busy time.  Then
each distinct shape's recorded call alone, on device time by event name
(``chip_smoke.device_events_ms``): K1's split into its fill and its
scatter, and the sums over the run's calls (shape time x calls).  Last,
K4 at the shape where its evaluations bind (``K4_SCALING``); K1 at its
largest call and K4 there are held against their plain versions.  Where
the package has K1's regimes: each IMDb shape in its chosen plan and in
each other one (``k1_variants``), and the direct regime beside the
largest call at other table sizes and edge counts (``K1_SWEEP``),
unsliced and in ``K1_SLICES`` slices, and the privatised regime at the
IMDb histograms on ``K1_PRIVATE_BLOCKS`` blocks.  Prints one JSON
object of every reading as its last line.
"""

from __future__ import annotations

import json
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (IMDB_SCALE, K4_SCALING,  # noqa: E402
                        device_events, device_events_ms, device_ms, log,
                        nvidia_smi, sync)

# after chip_smoke, which puts this checkout's src first on the path
SRC = Path(sys.argv[sys.argv.index("--src") + 1]).resolve() \
    if "--src" in sys.argv else ROOT / "src"
sys.path.insert(0, str(SRC))

# Name prefixes of each kernel's device events (csrc/segsum.cu, csrc/bdeu.cu).
K1_NAMES = ("segsum_ones",)
K4_NAMES = ("bdeu_",)
# K1's direct regime beside the IMDb largest call (E=400,000, P=10.8M):
# tables from L2-resident (1 MB) to twice L2 (86 MB), and fewer and more
# edges, to see what its scatter waits on.
K1_SWEEP = ((400_000, 262_144), (400_000, 2_700_000),
            (400_000, 10_800_000), (400_000, 21_600_000),
            (100_000, 10_800_000), (1_600_000, 10_800_000))
K1_SLICES = (1, 2, 3, 4, 6, 8)       # the cooperative launch's slices
K1_PRIVATE_BLOCKS = (13, 25, 49, 98, 196)   # privatised blocks, histograms


class Recorder:
    """Wraps ``ops.<name>`` and keeps every call's shape and, per distinct
    shape, a copy of its first call's positional inputs."""

    def __init__(self, ops, name, shape_of):
        self.ops, self.name, self.fn = ops, name, getattr(ops, name)
        self.shapes, self.inputs = Counter(), {}

        def spy(*args, **kwargs):
            key = shape_of(*args)
            self.shapes[key] += 1
            if key not in self.inputs:
                self.inputs[key] = tuple(a.clone() if torch.is_tensor(a)
                                         else a for a in args)
            return self.fn(*args, **kwargs)
        setattr(ops, name, spy)

    def remove(self):
        setattr(self.ops, self.name, self.fn)


def by_name(events: dict, prefixes) -> float:
    return sum(ms for name, ms in events.items()
               if any(p in name for p in prefixes))


def replay(label: str, rec: Recorder, call, prefixes) -> dict:
    """Each distinct shape's call alone: its device time by event, the
    kernel's own events apart from the rest (K1's fill); totals over the
    run's calls."""
    rows, total, own = [], 0.0, 0.0
    for key, n in sorted(rec.shapes.items(), key=lambda kv: -kv[1]):
        args = rec.inputs[key]
        events = device_events_ms(lambda: call(*args))
        if events is None:
            log(f"{label} {key}: x{n}, device time not measured")
            rows.append(dict(shape=list(key), calls=n, events=None))
            continue
        ms, mine = sum(events.values()), by_name(events, prefixes)
        total += n * ms
        own += n * mine
        log(f"{label} {key}: x{n}, {ms:.5f} ms a call ({mine:.5f} in its "
            f"own kernels); " + ", ".join(f"{k[:40]} {v:.5f}"
                                          for k, v in events.items()))
        rows.append(dict(shape=list(key), calls=n, device_ms=ms,
                         own_ms=mine, events=events))
    log(f"{label}: {sum(rec.shapes.values())} calls, {len(rec.shapes)} "
        f"shapes; replayed device time {total:.4f} ms ({own:.4f} ms in its "
        f"own kernels)")
    return dict(shapes=rows, replayed_ms=total, replayed_own_ms=own)


def k1_variants(rec: Recorder) -> list:
    """Where the package has K1's regimes (``segsum.ones_plan``): at each
    distinct shape, the chosen plan and each of
    ``chip_smoke.ones_alternatives``, each checked exactly against the
    plain version and timed on device time."""
    from repro_torch.kernels import segsum
    if not hasattr(segsum, "ones_plan"):
        return []
    from chip_smoke import ones_alternatives
    card = segsum.card_of(torch.device("cuda"))
    readings = []
    for key in sorted(rec.inputs):
        seg, w, p = rec.inputs[key]
        chosen = segsum.ones_plan(seg.shape[0], p, card)
        want = segsum.segsum_ones_plain(seg, w, p)
        for plan in [chosen] + ones_alternatives(chosen, seg.shape[0], p,
                                                 card):
            got = segsum.segsum_ones_cuda(seg, w, p, plan)
            err = float((got - want).abs().max())
            ms = device_ms(lambda: segsum.segsum_ones_cuda(seg, w, p, plan))
            mark = " (chosen)" if plan == chosen else ""
            log(f"K1 {key} {list(plan)}{mark}: {ms} ms, max_abs_err {err}")
            readings.append(dict(shape=list(key), plan=list(plan),
                                 chosen=plan == chosen, device_ms=ms,
                                 max_abs_err=err))
    return readings


def k1_sweep() -> list:
    """K1's direct regime at ``K1_SWEEP``'s (E, P), uniform random ids and
    weights of 1, a zero kernel first and in ``K1_SLICES`` slices: device
    time by event, checked exactly."""
    from repro_torch.kernels import segsum
    if not hasattr(segsum, "ones_plan"):
        return []
    card = segsum.card_of(torch.device("cuda"))
    gen = torch.Generator(device="cuda").manual_seed(6)
    most = segsum.ONES_BLOCKS_PER_SM * card.sms
    readings = []
    for e, p in K1_SWEEP:
        seg = torch.randint(0, p, (e,), generator=gen, device="cuda",
                            dtype=torch.int32)
        w = torch.ones(e, device="cuda")
        want = segsum.segsum_ones_plain(seg, w, p)
        plans = [segsum.OnesPlan("direct", max(1, min(most, -(-e // 1024))),
                                 0)]
        plans += [segsum.OnesPlan("direct", card.sms, slices)
                  for slices in K1_SLICES]
        for plan in plans:
            err = float((segsum.segsum_ones_cuda(seg, w, p, plan) - want)
                        .abs().max())
            events = device_events_ms(
                lambda: segsum.segsum_ones_cuda(seg, w, p, plan))
            total = events and sum(events.values())
            log(f"K1 sweep E={e} P={p} {list(plan)}: {total} ms "
                f"({events}), max_abs_err {err}")
            readings.append(dict(shape=[e, p], plan=list(plan),
                                 device_ms=total, events=events,
                                 max_abs_err=err))
    return readings


def k1_private_blocks(rec: Recorder) -> list:
    """The privatised regime at each recorded histogram shape on
    ``K1_PRIVATE_BLOCKS`` blocks (more blocks: fewer edges each, more
    flushes onto the same P addresses), checked exactly."""
    from repro_torch.kernels import segsum
    if not hasattr(segsum, "ones_plan"):
        return []
    card = segsum.card_of(torch.device("cuda"))
    readings = []
    for key in sorted(rec.inputs):
        seg, w, p = rec.inputs[key]
        if segsum.ones_plan(seg.shape[0], p, card).regime != "private":
            continue
        want = segsum.segsum_ones_plain(seg, w, p)
        for blocks in K1_PRIVATE_BLOCKS:
            plan = segsum.OnesPlan("private", blocks, 0)
            err = float((segsum.segsum_ones_cuda(seg, w, p, plan) - want)
                        .abs().max())
            ms = device_ms(lambda: segsum.segsum_ones_cuda(seg, w, p, plan))
            log(f"K1 private {key} {list(plan)}: {ms} ms, max_abs_err {err}")
            readings.append(dict(shape=list(key), plan=list(plan),
                                 device_ms=ms, max_abs_err=err))
    return readings


def main() -> None:
    if not torch.cuda.is_available():
        log("FAIL: this script needs a CUDA card")
        sys.exit(2)
    from torch.profiler import ProfilerActivity, profile

    import repro_torch
    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bdeu import bdeu_plain
    from repro_torch.kernels.segsum import segsum_ones_plain
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"package {Path(repro_torch.__file__).parent}")
    if Path(repro_torch.__file__).resolve().parent != SRC / "repro_torch":
        log(f"FAIL: repro_torch came from {repro_torch.__file__}, not {SRC}")
        sys.exit(1)
    build.load()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)

    def run():
        discover_model(db, make_strategy("HYBRID", executor="sparse"),
                       max_chain_length=2, max_parents=3)
        sync()

    run()                                           # warm-up
    k1 = Recorder(ops, "segsum_ones", lambda seg, w, p: (seg.shape[0], p))
    k4 = Recorder(ops, "bdeu", lambda nijk, ess=1.0: tuple(nijk.shape))
    run()
    k1.remove()
    k4.remove()
    for label, rec in (("K1 (E, P)", k1), ("K4 (B, q, r)", k4)):
        log(f"{label}: " + ", ".join(
            f"{k} x{n}" for k, n in sorted(rec.shapes.items())))

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    wall = time.perf_counter() - t0
    on_card = device_events(prof)
    prof_k = {name: dict(ms=sum(e.self_device_time_total for e in on_card
                                if any(p in e.key for p in prefixes)) / 1e3,
                         launches=sum(e.count for e in on_card
                                      if any(p in e.key for p in prefixes)))
              for name, prefixes in (("K1", K1_NAMES), ("K4", K4_NAMES))}
    busy = sum(e.self_device_time_total for e in on_card) / 1e3
    fills = [e for e in on_card if "FillFunctor" in e.key]
    fill_ms = sum(e.self_device_time_total for e in fills) / 1e3
    log(f"IMDb profile: {wall:.3f} s wall, device busy {busy:.4f} ms; K1 "
        f"{prof_k['K1']} ms, K4 {prof_k['K4']} ms by kernel name; fills "
        f"(every caller) {fill_ms:.4f} ms in {sum(e.count for e in fills)} "
        f"launches")

    k1_replay = replay("K1", k1, ops.segsum_ones, K1_NAMES)
    k4_replay = replay("K4", k4, ops.bdeu, K4_NAMES)
    variants = k1_variants(k1) + k1_sweep() + k1_private_blocks(k1)
    seg, w, p = k1.inputs[max(k1.inputs)]
    k1_split = device_events_ms(lambda: ops.segsum_ones(seg, w, p))
    log(f"K1 at its largest call (E={seg.shape[0]} P={p}) by event: "
        f"{k1_split}")
    got, want = ops.segsum_ones(seg, w, p), segsum_ones_plain(seg, w, p)
    k1_err = float((got - want).abs().max())

    b, q, r = K4_SCALING
    gen = torch.Generator(device="cuda").manual_seed(4)
    nijk = torch.randint(0, 50, (b, q, r), generator=gen,
                         device="cuda").float()
    k4_scale = device_events_ms(lambda: ops.bdeu(nijk, 1.0))
    k4_err = float((ops.bdeu(nijk, 1.0) - bdeu_plain(nijk, 1.0)).abs().max())
    log(f"K4 at B={b} q={q} r={r}: {k4_scale} (max_abs_err {k4_err}); "
        f"K1 at its largest call max_abs_err {k1_err}")
    log(nvidia_smi())
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0), nvidia_smi=smi,
        k1_shapes={str(k): n for k, n in k1.shapes.items()},
        k4_shapes={str(k): n for k, n in k4.shapes.items()},
        profile=dict(wall_s=wall, busy_ms=busy, **prof_k),
        k1_replay=k1_replay, k4_replay=k4_replay, k1_split=k1_split,
        k1_variants=variants,
        k1_largest=[seg.shape[0], p], k4_scaling=dict(
            shape=list(K4_SCALING), events=k4_scale, max_abs_err=k4_err))))
    if k1_err or k4_err or any(v["max_abs_err"] for v in variants):
        log("FAIL: a kernel differs from its plain version")
        sys.exit(1)


if __name__ == "__main__":
    main()
