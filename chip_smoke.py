"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py
(no arguments: every database is at its full size, ``*_SCALE`` below).

Phases (any failure exits non-zero before the last line is printed):

1. device   — a CUDA card is required; prints its name, count, versions and
              ``nvidia-smi`` name / power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
              and prints the build time and ``ptxas`` register/shared lines.
3. main     — HYBRID model discovery over the sparse executor on the IMDb
              stand-in at full size (1.06M rows, 3 relationships), counting
              every kernel launch; its wall time and peak memory are read on
              this run alone.  The IMDb run is made once more under
              ``torch.profiler``: device busy time against wall time, and
              the kernels that took most of it.  Then HYBRID pre-counting
              alone on the VisualGenome stand-in (15.8M rows, 8
              relationships, chains of 3, which take the dense-message
              hop).  Checks that each kernel was launched and that every
              single-relation positive table sums to its relation's edge
              count.
4. kernels  — the IMDb run once more, keeping a copy of the inputs of each
              kernel's largest call; each kernel against its plain PyTorch
              version on those inputs: exact for the
              segment sums, the Möbius transform and BDeu (BDeu is
              bit-reproducible by design; the ``rtol=1e-4, atol=1e-2``
              tolerance is the JAX reference's and is checked too).  Times
              the kernel, the plain version and one PyTorch library call of
              the same function where there is one, beside the least time
              the card could take (bytes over 3.35 TB/s, float32 operations
              over 67 TFLOP/s: NVIDIA H100 SXM data sheet).
5. parity   — model discovery on the full UW stand-in, HYBRID over sparse
              and over dense, on the card and on the CPU: edge-identical.

The line before the last is one JSON object with a row per kernel; the
last is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
FP32_OPS_PER_S = 67e12             # H100 SXM float32 outside tensor cores
LGAMMA_OPS = 70                    # float32 operations per lgamma_f32 call
                                   # (count of bdeu.cu's lgamma_f32 + log_f32)

# Database sizes (``paper_benchmark_db`` scale): all full size, none cut.
IMDB_SCALE = 1.0
VG_SCALE = 1.0
UW_SCALE = 1.0


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync() -> None:
    torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` launches, after a
    warm-up, from CUDA events."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Spy:
    """Wraps the ``ops`` wrappers during a run and keeps a copy of the
    positional inputs of each kernel's largest call (by input elements).
    An ``out`` that a call adds into is not kept: the comparison sums
    into a zeroed table."""

    def __init__(self, ops, names):
        self.ops, self.orig, self.big = ops, {}, {}
        for name in names:
            self.orig[name] = getattr(ops, name)
            setattr(ops, name, self._wrap(name, self.orig[name]))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            if size > self.big.get(name, (0,))[0]:
                self.big[name] = (size, tuple(
                    a.clone() if torch.is_tensor(a) else a for a in args))
            return fn(*args, **kwargs)
        return spy

    def remove(self):
        for name, fn in self.orig.items():
            setattr(self.ops, name, fn)


def edges_of(models):
    return {str(p): sorted((str(a), str(b)) for a, b in m.edges())
            for p, m in models.items()}


def check_positive_invariant(strategy, db, label: str) -> None:
    """Every single-relation full positive table counts each edge once."""
    for point in strategy.lattice:
        if point.length != 1:
            continue
        rel = next(iter(point.rels))
        total = strategy.provider._full(point).total()
        if total != db.relations[rel].num_edges:
            fail(f"{label}: positive table of {rel} sums to {total}, not "
                 f"{db.relations[rel].num_edges}")
    log(f"{label}: single-relation positive tables sum to their edge "
        f"counts")


def profile_main_path(db, discover_model, make_strategy) -> None:
    """The main path once more under ``torch.profiler``: the device's busy
    time against the wall time, and the kernels that took most of it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        discover_model(db, make_strategy("HYBRID", executor="sparse"),
                       max_chain_length=2, max_parents=3)
        sync()
    wall = time.perf_counter() - t0
    # device events, without the spans that annotate() draws over them
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    if not on_card:
        log(f"profile: {wall:.3f} s wall under the profiler; device time "
            f"not measured (the trace holds no device events)")
        return
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    log(f"profile: {wall:.3f} s wall under the profiler, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.2f} %), "
        f"{sum(e.count for e in on_card)} device events")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")


def main() -> None:
    t_start = time.perf_counter()
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is False; this script needs a "
            "CUDA card")
        sys.exit(2)
    from repro_torch.core import (build_lattice, discover_model,
                                  make_strategy, paper_benchmark_db)
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bdeu import bdeu_plain
    from repro_torch.kernels.mobius import mobius_matrix, mobius_plain
    from repro_torch.kernels.segsum import (segsum_ones_plain,
                                            segsum_rows_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device: {kind} x{count}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; nvidia-smi: {smi}")

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    build.build(force=True)
    info = dict(build.BUILD_INFO)
    build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s wall, nvcc "
        f"{info['seconds']:.2f} s -> {info['path']}")
    for line in info["ptxas"]:
        log(f"  {line}")

    # -- 3. main path ----------------------------------------------------------
    t0 = time.perf_counter()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    log(f"IMDb stand-in: {db.total_rows} rows, {len(db.relations)} "
        f"relationships (generated in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    models, strategy = discover_model(
        db, make_strategy("HYBRID", executor="sparse"),
        max_chain_length=2, max_parents=3)
    sync()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = strategy.stats.as_dict()
    log(f"main path (IMDb, HYBRID/sparse, chains <= 2, parents <= 3): "
        f"{wall:.3f} s wall on {kind}")
    log("  stats: " + json.dumps({k: st[k] for k in (
        "joins", "rows_scanned", "ct_rows", "time_metadata",
        "time_positive", "time_negative", "peak_bytes")}))
    log(f"  max_memory_allocated: {peak} B; "
        f"learned edges: {sum(len(m.edges()) for m in models.values())}; "
        f"launches: {json.dumps(launches)}")
    if any(launches[k] <= 0 for k in ops.KERNELS):
        fail(f"a kernel of the main path was not launched: {launches}")
    if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
        fail(f"plain versions ran on the card: {ops.PLAIN_CALLS}")
    for m in models.values():
        if not np.isfinite(m.score):
            fail("a learned model has a non-finite score")
    check_positive_invariant(strategy, db, "IMDb")
    del strategy, models
    profile_main_path(db, discover_model, make_strategy)

    t0 = time.perf_counter()
    vg = paper_benchmark_db("VisualGenome", seed=0, scale=VG_SCALE)
    log(f"VisualGenome stand-in: {vg.total_rows} rows, {len(vg.relations)} "
        f"relationships (generated in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    vg_strategy = make_strategy("HYBRID", executor="sparse")
    vg_strategy.prepare(vg, build_lattice(vg.schema, 3))
    sync()
    log(f"VisualGenome pre-counting (HYBRID/sparse, chains <= 3, "
        f"{len(vg_strategy.lattice)} lattice points): "
        f"{time.perf_counter() - t0:.3f} s wall; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; launches "
        f"{json.dumps(ops.LAUNCHES)}")
    if ops.LAUNCHES["segsum_rows"] <= 0:
        fail("the dense-message hop did not launch segsum_rows")
    check_positive_invariant(vg_strategy, vg, "VisualGenome")
    del vg_strategy, vg

    # -- 4. kernels against their plain versions -------------------------------
    spy = Spy(ops, ops.KERNELS)
    discover_model(db, make_strategy("HYBRID", executor="sparse"),
                   max_chain_length=2, max_parents=3)
    spy.remove()
    del db
    rows = []
    seg, w, p = spy.big["segsum_ones"][1]
    e = seg.shape[0]
    got, want = ops.segsum_ones(seg, w, p), segsum_ones_plain(seg, w, p)
    err = float((got - want).abs().max())
    seg_l = seg.long()
    b_ms, b_by = bound_ms(8.0 * e + 4.0 * p, e)
    rows.append(dict(
        name="segsum_ones", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:103",
        launches=launches["segsum_ones"], max_abs_err=err,
        ms=cuda_ms(lambda: ops.segsum_ones(seg, w, p)),
        plain_ms=cuda_ms(lambda: segsum_ones_plain(seg, w, p)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.zeros(p, device=seg.device)
                           .index_add_(0, seg_l, w)),
        shape=f"E={e} P={p}"))
    if err != 0.0:
        fail(f"segsum_ones differs from its plain version by {err}")

    seg, r, p = spy.big["segsum_rows"][1]
    e, d = r.shape
    got, want = ops.segsum_rows(seg, r, p), segsum_rows_plain(seg, r, p)
    err = float((got - want).abs().max())
    seg_l = seg.long()
    b_ms, b_by = bound_ms(4.0 * e + 4.0 * e * d + 4.0 * p * d, e * d)
    rows.append(dict(
        name="segsum_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:71",
        launches=launches["segsum_rows"], max_abs_err=err,
        ms=cuda_ms(lambda: ops.segsum_rows(seg, r, p)),
        plain_ms=cuda_ms(lambda: segsum_rows_plain(seg, r, p)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.zeros((p, d), device=r.device)
                           .index_add_(0, seg_l, r)),
        shape=f"E={e} D={d} P={p}"))
    if err != 0.0:
        fail(f"segsum_rows differs from its plain version by {err}")

    (x,) = spy.big["mobius"][1]
    bsz, height, d = x.shape
    k = height.bit_length() - 1
    got, want = ops.mobius(x), mobius_plain(x)
    err = float((got - want).abs().max())
    tmat = mobius_matrix(k).to(x.device)
    b_ms, b_by = bound_ms(8.0 * x.numel(), bsz * d * k * (height // 2))
    rows.append(dict(
        name="mobius", route="cuda",
        source="src/repro_torch/kernels/csrc/mobius.cu",
        replaces="src/repro/kernels/mobius_kernel.py:41",
        launches=launches["mobius"], max_abs_err=err,
        ms=cuda_ms(lambda: ops.mobius(x)),
        plain_ms=cuda_ms(lambda: mobius_plain(x)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(tmat, x)),
        shape=f"B={bsz} 2^k={height} D={d}"))
    if err != 0.0:
        fail(f"mobius differs from its plain version by {err}")

    nijk, ess = spy.big["bdeu"][1]
    bsz, q, rr = nijk.shape
    got, want = ops.bdeu(nijk, ess), bdeu_plain(nijk, ess)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
        fail(f"bdeu outside rtol=1e-4, atol=1e-2 of its plain version")
    n_ops = bsz * ((q * rr + q) * LGAMMA_OPS + 4 * q * rr + 4 * q)
    b_ms, b_by = bound_ms(4.0 * nijk.numel() + 4.0 * bsz, n_ops)
    rows.append(dict(
        name="bdeu", route="cuda",
        source="src/repro_torch/kernels/csrc/bdeu.cu",
        replaces="src/repro/kernels/bdeu_kernel.py:40",
        launches=launches["bdeu"], max_abs_err=err,
        ms=cuda_ms(lambda: ops.bdeu(nijk, ess)),
        plain_ms=cuda_ms(lambda: bdeu_plain(nijk, ess)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape=f"B={bsz} q={q} r={rr}"))
    if err != 0.0:
        fail(f"bdeu is not bit-identical to its plain version ({err})")
    for row in rows:
        log(f"kernel {row['name']} [{row['shape']}]: {row['ms']:.4f} ms, "
            f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']} "
            f"ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"max_abs_err {row['max_abs_err']}")

    # -- 5. card against CPU -------------------------------------------------
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    for ex in ("sparse", "dense"):
        t0 = time.perf_counter()
        on_card, _ = discover_model(uw, make_strategy("HYBRID", executor=ex))
        on_cpu, _ = discover_model(
            uw, make_strategy("HYBRID", executor=ex, device="cpu"),
            device="cpu")
        if edges_of(on_card) != edges_of(on_cpu):
            fail(f"UW HYBRID/{ex}: card and CPU models differ:\n"
                 f"{edges_of(on_card)}\n{edges_of(on_cpu)}")
        log(f"UW HYBRID/{ex}: card and CPU models edge-identical "
            f"({sum(len(m.edges()) for m in on_card.values())} edges, "
            f"{time.perf_counter() - t0:.1f} s)")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shape"} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
