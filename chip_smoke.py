"""Drive the PyTorch port's main path on one CUDA card and check it.

Run from the repository root:  python3 chip_smoke.py
(no arguments: every database is at its full size, ``*_SCALE`` below).

Phases (any failure exits non-zero before the last line is printed):

1. device   — a CUDA card is required; prints its name, count, versions and
              ``nvidia-smi`` name / power limit.
2. build    — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
              and prints the build time and ``ptxas`` register, shared
              memory and spill lines; fails if K6's Hopper and mma.sync
              kernels, K2's two kernels, K1's four, K4's or K3's two spill
              (``NO_SPILL_KERNELS``), or if K4's branch-free division or
              frexp gives other bits than the correctly rounded operation
              anywhere in its domain (``bdeu.check_division``, exhaustive).
3. main     — HYBRID model discovery over the sparse executor on the IMDb
              stand-in at full size (1.06M rows, 3 relationships), counting
              every kernel launch; its wall time and peak memory are read on
              this run alone.  The IMDb run is made once more under
              ``torch.profiler``: device busy time against wall time, and
              the kernels that took most of it, and K1's, K2's and K4's
              device time by kernel name.  Then HYBRID pre-counting alone
              on the VisualGenome stand-in (15.8M rows, 8 relationships,
              chains of 3, which take the dense-message hop), and once
              more keeping K2's
              largest call and its largest in the direct regime (the
              dense-message hop), each held bit for bit against its plain
              version and timed.  Checks that each kernel was launched,
              that K2 took both regimes (launch counts by regime printed),
              and that every single-relation positive table sums to its
              relation's edge count.
4. kernels  — the IMDb run once more, keeping a copy of the inputs of each
              kernel's largest call; each kernel against its plain PyTorch
              version on those inputs: exact for the
              segment sums, the Möbius transform and BDeu (BDeu is
              bit-reproducible by design; the ``rtol=1e-4, atol=1e-2``
              tolerance is the JAX reference's and is checked too).  Times
              the kernel, the plain version and one PyTorch library call of
              the same function where there is one, beside the least time
              the card could take (bytes over 3.35 TB/s, float32 operations
              over 67 TFLOP/s: NVIDIA H100 SXM data sheet), each twice: CUDA
              events around back-to-back calls (``ms``, which also counts
              host launch gaps) and device time under ``torch.profiler``
              (``device_ms``, the calls' own device events over the reps).
              K2 is also checked and timed in its other regime where the
              wrapper chose the privatised one; K1 at its largest call and
              at its largest privatised one (an entity histogram), each
              also in its other plans (``ones_alternatives``: the direct
              regime sliced and not, the privatised one where P allows
              it), its device time split by event (the zeroing apart from
              the scatter); K4 also
              at ``K4_SCALING``, where its lgammas bind; K3 also at
              ``K3_SCALING``, where its bytes bind (bit for bit on counts
              above 2^24, its device time beside the bound and
              ``matmul(T, X)``'s).
5. parity   — model discovery on the full UW stand-in, HYBRID and
              ONDEMAND over sparse and over dense, on the card and on the
              CPU: edge-identical.  ONDEMAND's prefetch runs the batched
              positive path (``Executor.positive_batch``), so this is where
              the dense executor's stacked groups run on the card; the
              stacked groups are counted and must be some.
6. hist     — K5's path: the weighted segment histogram at the three
              shapes of ``benchmarks/bench_kernels.py``'s ``bench_hist``,
              counting launches; each against its plain version
              (``rtol=1e-5, atol=1e-3``: float sums whose atomics land in
              any order), the largest timed against ``index_add_`` (CUDA
              events and device time).
7. k6-edges — K6 against its plain version in bf16 (``K6_BF16_TOL``) on a
              grid of small shapes that reach every edge of its tiles:
              ``Sq = Skv`` in ``K6_EDGE_LENGTHS``, causal and not, and
              ``Sq != Skv`` (``K6_EDGE_RAGGED``, not causal); 16 query
              heads over 1, 2 or 16 KV heads; batch 1 and 3; hd 128 (the
              Hopper kernel), 64, 192 and 256 (the mma.sync kernel) and 160
              (the CUDA-core kernel); and the same in float32
              (``K6_F32_TOL``) at hd 160, 192, 256 and 512 (the CUDA-core
              kernel's widest); and at hd 576, 640 and 1,024
              (``K6_EDGE_SLICED_HDS``, the sliced CUDA-core kernel, which
              streams the head dim) in bf16 and float32.  One line per
              shape: the shape, the kernel the C entry chose,
              max_abs_err.  K6's row in the kernels line keeps each
              kernel's largest error apart (``max_abs_err_by_route``,
              float32's under its own key).  Then the sliced kernel is
              timed at ``K6_SLICED_SHAPE`` beside SDPA and its bound (the
              ``sliced`` entry of K6's row).
8. lm       — Qwen2.5-3B serving at its published full size (36 layers,
              d_model 2048, 16/2 heads, vocab 151,936, bf16; random weights
              from generator seed 0).  (c) prefill/decode consistency at
              full width and depth on 2 x 256 tokens; (a) the main run:
              prefill of 4 x 4,096 tokens, then 32 greedy decode steps into
              a 4,128-token cache, and one prefill of 1 x 32,768 tokens
              (``prefill_32k``'s length, its batch cut from 32 to 1), K6
              launched exactly once per layer of each prefill; four
              decode steps and the main prefill once more under
              ``torch.profiler``; (b) K6 against
              its plain version on layer 0's q, k, v of the main prefill,
              in bf16 and in float32, and of the long prefill in bf16;
              timed at both shapes against PyTorch's
              ``scaled_dot_product_attention`` (CUDA events and device
              time), with K6's share of each prefill (launches x ms /
              wall).
9. k2-edges — K2 bit for bit against its plain version on a grid of shapes
              that reaches both regimes and every edge: ``D`` in
              ``K2_EDGE_WIDTHS``, ``P`` in ``K2_EDGE_SEGMENTS`` and the
              privatisation limit and either side of it, ``E`` in
              ``K2_EDGE_EDGES``; ids -1 and P mixed in, a non-zero ``out``
              to add into, fresh inputs and 4-byte-offset views, and the
              direct regime too where the wrapper chose the privatised one.
              One line per shape with the regime chosen; the phase's
              seconds.
10. k1k4-edges — K4 bit for bit against its plain version on a grid of
              shapes (``K4_EDGE_*``: q either side of a warp, of its 256
              lanes and past one chunk, r up to a chunk too wide for 256
              rows, 1, 9 and 200 families, ess 1 and 10) mixing all-zero
              families, counts of a few, counts above 2^20 and counts
              above 2^100 (lgamma's slow path); and K1
              exactly against its plain version on its grid (``K1_EDGE_*``,
              P at the privatisation limit and either side of it), ids -1
              and P mixed in, weights 0 to 3, fresh and 4-byte-offset
              inputs, through the wrapper and in each of K1's other plans
              (``ones_alternatives``).  One
              line per shape (K1's with the regime chosen); the phase's
              seconds.
11. nemotron — Nemotron-4-340B serving at its published width (d_model
              18,432, 96/8 heads, hd 192, d_ff 73,728 squared-ReLU, vocab
              256,000, bf16; random weights from generator seed 0), its 96
              layers cut to ``NEMOTRON_LAYERS`` = 4 so that one card holds
              them: prefill/decode consistency as in phase 8 (c), a prefill
              of 2 x 4,096 tokens with K6 launched once per layer on the
              mma.sync route, 16 greedy decode steps (prefill tokens/s,
              decode ms a step, peak memory); K6 against its plain version
              on layer 0's q, k, v, timed against SDPA and its bound (the
              ``nemotron`` entry of K6's kernels-line row).
12. strategies — the paper's three strategies on the card, over the sparse
              executor on the IMDb stand-in at ``IMDB_SCALE`` with phase
              3's chains and parents: ONDEMAND (post-counting: every
              family's positives contracted from the data through the
              batched positive path), PRECOUNT, and HYBRID under
              ``cache_budget_bytes`` = ``TIGHT_BUDGET`` (64 KiB), so that
              evicted tables re-contract through ``positive_batch``; phase
              3's HYBRID is the fourth.  Each run: wall (host clock ending
              in ``torch.cuda.synchronize()``), the Fig. 3 split, joins,
              rows scanned, peak device memory, launches by kernel and by
              K1/K2 regime, ``positive_batch`` calls, plans, stack groups
              (those of two or more plans are stacked) and the largest;
              every kernel of the run's path launched (all four, but no
              Möbius transform in PRECOUNT, whose complete tables keep
              edge-attribute axes: a blockwise negative phase), no plain
              version; ONDEMAND's and HYBRID's models edge-identical to
              phase 3's (the same operations on the same tables).
              PRECOUNT's tables are projections of complete tables whose
              counts pass 2^24, which float32 cannot hold exactly, so
              each family its search scored is held to HYBRID's: the same
              axes in the same order, every cell below 2^24 bit for bit,
              every cell past it within ``ROUNDING_PAST_2_24``; the same
              families from a negative phase that subtracts no positive
              count (a planted fault) must differ from HYBRID's past 2^24
              by more than that bound; and PRECOUNT run on the CPU over
              the same database must learn the card's models, with those
              families' tables equal bit for bit.  Its models may differ
              from HYBRID's only at points where a family's cells past
              2^24 rounded differently (``precount_tables``, printed with
              both readings).  Then the
              ONDEMAND run's ``positive_batch`` plan lists are replayed
              through ``positive_batch`` and through ``positive`` one plan
              at a time: the tables bit for bit equal, every stacked
              group with fewer K1/K2 launches than its plans one at a
              time; K1/K2 launches, wall and device time of each
              replay.  The runs' launches and the replay are the
              ``strategies`` entries of K1's and K2's kernels-line rows.

13. mutations — writes and delta count maintenance on the card.  (a) The
              IMDb stand-in at ``IMDB_SCALE``: HYBRID and ONDEMAND
              (``MUTATION_STRATEGIES``) warmed by discovery on copies of
              the store (phases 3 and 12 keep theirs), then each write of
              ``IMDB_WRITES`` (drawn from a generator seeded
              ``MUTATION_SEED``) applied and reconciled with
              ``strategy.apply_delta``: the ``DeltaReport``, the
              reconciliation's wall (host clock ending in
              ``torch.cuda.synchronize()``) and K1/K2/K3 launches (K1 and
              K2 by regime), no plain version; the first write must update
              HYBRID in place through K1 or K2 and K3, both small fact
              deltas must invalidate nothing, the large delete must update
              nothing.  A third HYBRID copy takes every write under
              ``torch.profiler`` (device busy time).  (b) After each write
              every resident ``"pos"``/``"full"``/``"fam"``/``"complete"``
              entry against a fresh strategy's recount on the mutated
              store (``recount_entries``): cells below 2^24 bit for bit,
              past it within ``ROUNDING_PAST_2_24``; a fourth copy takes
              the first write reconciled with its sign flipped (a planted
              fault), which must differ below 2^24.  (c) After each write
              the search (``StructureSearch``) on the reconciled strategy,
              launching K4, against ``discover_model`` on a fresh one: edge
              for edge but at points where a family's cells past 2^24
              differ or that inherit a differing sub-point's edges
              (printed with the edges each side alone has); both walls.  (d) UW at
              ``UW_SCALE``, all four strategies over both executors, card
              and CPU taking the same interleaving (``UW_WRITES``): equal
              reports and every resident entry bit for bit.  The phase's
              launches are the ``mutations`` entries of K1's, K2's and
              K3's kernels-line rows (K4's: the rediscoveries').
14. served  — model discovery served on the card through
              ``repro_torch.serve.CountingService`` (its dispatcher thread
              started, deadline ``SERVED_MAX_WAIT_S``) and
              ``repro_torch.discover.DiscoveryService``, on copies of the
              IMDb stand-in at ``IMDB_SCALE``.  (a) One client, traced
              (``Tracer``): wall (host clock ending in
              ``torch.cuda.synchronize()``), the service's stats (requests,
              coalesced, cache hits, batches, bucket sizes, queue-wait,
              bucket and end-to-end p50/p95/p99), K1-K4 launches (K1 and K2
              by regime; each at least once, no plain version); models edge
              for edge phase 3's HYBRID models but at points where a scored
              family's cells past 2^24 differ (printed with both readings);
              the host span breakdown by name (seconds and counts), every
              ``service.exec`` span under a ``service.queue`` span
              (``build_trees``), the threads that ran the batches; then an
              untraced copy's wall and a profiled copy's device busy time.
              (b) ``SERVED_CLIENTS`` threads call ``discover()`` at once on a
              fresh service, cold and then warm: one signature and version,
              (a)'s, and some queries coalesced.  (c) The first of
              ``IMDB_WRITES`` through ``svc.insert_facts`` and
              ``refresh("imdb_R0")``: some families retained, fewer
              rescored than known; models against a fresh relearn of the
              mutated store as in (a); every family score of the refreshed
              memo equal bit for bit to K4 on the family's table as the
              service now holds it (a score carried forward stale differs),
              and against the relearn's scores bit for bit where the table
              stays below 2^24, past it within the discovery tests'
              tolerance plus ``4 eps M`` (``refresh_check``); (b)'s service
              refreshed after the same write naming ``imdb_R1`` (a planted
              fault) must fail that check; refresh and relearn walls.  Then a
              writer thread makes the fenced inserts of ``SERVED_WRITES``
              while ``SERVED_SEARCHERS`` threads run ``discover()``: their
              final results carry one version and one signature, a fresh
              relearn's of the final store.  (d) UW at ``UW_SCALE``: served
              discovery and a refresh after the first of ``UW_WRITES`` on
              the card and on the CPU, signatures, scores and refresh
              counts equal bit for bit; the card's served signature equals
              a local ``DiscoveryService`` over HYBRID.  The phase's launches
              are the ``served`` entries of K1-K4's kernels-line rows.

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
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 dense tensor cores
LGAMMA_OPS = 70                    # float32 operations per lgamma_f32 call
                                   # (count of bdeu.cu's lgamma_f32 + log_f32)
PROFILE_PAUSE_S = 0.1              # host pause before a kept profiler step

# Database sizes (``paper_benchmark_db`` scale): all full size, none cut.
IMDB_SCALE = 1.0
VG_SCALE = 1.0
UW_SCALE = 1.0

# The counting path's kernels (phases 3-4); K5 and K6 have paths of their own.
COUNTING_KERNELS = ("segsum_ones", "segsum_rows", "mobius", "bdeu")
# K2's CUDA kernels (csrc/segsum.cu), by the names ptxas and the profiler
# give them.
K2_KERNEL_NAMES = ("rows_private_kernel", "rows_direct_kernel")
# K1's and K4's CUDA kernels (csrc/segsum.cu, csrc/bdeu.cu), by the
# prefixes of the names ptxas and the profiler give them, and the kernels
# phase 2 holds to 0 bytes spilled.
K1_KERNEL_NAMES = ("segsum_ones",)
K4_KERNEL_NAMES = ("bdeu_",)
NO_SPILL_KERNELS = ("flash_wgmma", "flash_mma", "rows_private_kernel",
                    "rows_direct_kernel", "segsum_ones_direct_kernel",
                    "segsum_ones_sliced_kernel", "segsum_ones_private_kernel",
                    "segsum_ones_zero_kernel", "bdeu_chunk_kernel",
                    "mobius_reg_kernel", "mobius_tile_kernel")
# K4's edge shapes (phase 10): q either side of a warp, of the 256 lanes
# and past one chunk; r from one column to a chunk that no longer fits
# 256 rows' lgammas (33); B of one family, the IMDb largest call's 9 and
# 200; both equivalent sample sizes the tests use.  K4_EDGE_SCALING is
# the shape where the lgammas themselves bind, timed in phase 4.
K4_EDGE_Q = (1, 2, 31, 32, 33, 255, 256, 257, 1000, 4096)
K4_EDGE_R = (1, 2, 3, 8, 33)
K4_EDGE_B = (1, 9, 200)
K4_EDGE_ESS = (1.0, 10.0)
K4_SCALING = (64, 4096, 4)
# K3's shapes where its bytes bind (phase 4), [B, 2^k, D]: the register
# path at k = 3 and k = 5 with 128 MB in, the shared-memory path at k = 8,
# and the batched negative phase's stack of many families of a
# 2-relationship chain over three 12-valued attributes.
K3_SCALING = ((1, 8, 1 << 22), (1, 32, 1 << 20), (1, 256, 1 << 16),
              (1024, 4, 1728))
# K1's edge shapes (phase 10): segment counts besides the privatisation
# limit and either side of it (which the phase adds), up to the IMDb hops'
# 10.8M; edge counts either side of a block's 256 threads and the IMDb
# largest call's 400,000.
K1_EDGE_SEGMENTS = (1, 1024, 10_800_000)
K1_EDGE_EDGES = (1, 255, 256, 257, 400_000)
# K2's edge shapes (phase 9): widths at and either side of its 4-column
# quads, one past a warp's 128 and a tile's 256 columns, and the IMDb
# root combine's; segment counts besides the privatisation limit and
# either side of it (which the phase adds); edge counts either side of a
# block's 256 staged ids.  A shape whose rows
# pass K2_EDGE_ROWS_MAX floats or whose table passes K2_EDGE_CELLS_MAX
# cells is left out (D = 11,664 with E = 100,000 or P = 10^6).
K2_EDGE_WIDTHS = (1, 3, 4, 5, 64, 257, 11664)
K2_EDGE_SEGMENTS = (1, 27, 1024, 10 ** 6)
K2_EDGE_EDGES = (1, 255, 256, 257, 100_000)
K2_EDGE_ROWS_MAX = 2 ** 25
K2_EDGE_CELLS_MAX = 2 ** 28

# Qwen2.5-3B serving (phase 7): the main run and the long prefill.
LM_ARCH = "qwen2.5-3b"
LM_BATCH, LM_PROMPT, LM_NEW = 4, 4096, 32
LM_LONG = 32768                    # prefill_32k's length; batch cut 32 -> 1
LM_CHECK_BATCH, LM_CHECK_LEN = 2, 256
# Tolerances.  K6 against its plain version: bf16 output, probabilities
# rounded to bf16 at the running (kernel) or the final (plain) max: two
# bf16 roundings, 2^-7 relative; float32 inputs: 1e-4.  Prefill/decode
# consistency at 36 layers of bf16: the JAX arch test's 2e-2 and 5e-2 (at
# 2 layers), applied to the logits' max abs difference as a fraction of
# their max abs value.
K6_BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -7)
# K6's edge shapes (phase 7): lengths either side of its 64- and 128-row
# tiles, and a query length unlike the key length; in bf16 at the head
# dims of each route (128 the Hopper kernel; 64, 192 and 256 mma.sync; 160
# the CUDA-core kernel), and in float32 (the CUDA-core kernel) above 128 up
# to its limit of 512.
K6_EDGE_LENGTHS = (1, 64, 127, 128, 129, 300, 1000)
K6_EDGE_RAGGED = (200, 333)
K6_EDGE_HEADS, K6_EDGE_KV_HEADS = 16, (1, 2, 16)
K6_EDGE_BATCHES, K6_EDGE_HDS = (1, 3), (128, 64, 160, 192, 256)
K6_EDGE_F32_HDS = (160, 192, 256, 512)
# The sliced route's head dims (phase 7), in bf16 and float32, and the
# shape where it is timed beside SDPA: (B, S, H, Hkv, hd), causal, bf16.
K6_EDGE_SLICED_HDS = (576, 640, 1024)
K6_SLICED_SHAPE = (1, 2048, 8, 1, 1024)
K6_F32_TOL = dict(rtol=1e-4, atol=1e-4)
LM_PREFILL_TOL = 0.02
LM_DECODE_TOL = 0.05
# Nemotron-4-340B serving (phase 11) at its published width; depth cut from
# 96 to 4 layers so that one H100 holds the weights (37.1 GB of bf16; all
# 96 would be about 672 GB).
NEMOTRON_ARCH = "nemotron-4-340b"
NEMOTRON_LAYERS = 4
NEMOTRON_BATCH, NEMOTRON_PROMPT, NEMOTRON_NEW = 2, 4096, 16
# The strategies phase (12): the tight cache budget of its HYBRID run, and
# the runs as (label, strategy, keyword arguments, the kernels its path
# launches).  PRECOUNT's complete tables keep every edge-attribute axis, so
# its negative phase is the blockwise sum, which runs no Möbius transform.
TIGHT_BUDGET = 64 << 10
STRATEGY_RUNS = (
    ("ONDEMAND", "ONDEMAND", {}, COUNTING_KERNELS),
    ("PRECOUNT", "PRECOUNT", {}, ("segsum_ones", "segsum_rows", "bdeu")),
    ("HYBRID 64 KiB", "HYBRID", {"cache_budget_bytes": TIGHT_BUDGET},
     COUNTING_KERNELS))
DISCOVERY = dict(max_chain_length=2, max_parents=3)    # phases 3, 4 and 12
# The relative difference PRECOUNT's families and HYBRID's may show in
# cells past 2^24, where float32 rounds counts (phase 12): 64 units in the
# last place.  tests/test_torch_batching.py holds the CPU to the same bound.
ROUNDING_PAST_2_24 = 2.0 ** -18
# The mutations phase (13): the strategies warmed on IMDb copies; the
# writes on IMDb and on UW, as (op, target, count),
# drawn from one generator seeded MUTATION_SEED.  IMDb: 1 % fresh pairs
# into imdb_R0, 4,000 deletes from imdb_R1 and 1,000 rows of one attribute
# of imdb_e0 (all updated in place), then 30,000 deletes from imdb_R2, above
# max_update_fraction = 0.25 of the 83,000 edges left (the invalidation
# fallback).  UW: an interleaving whose insert of 40 RA edges passes the
# same fraction.
MUTATION_STRATEGIES = ("HYBRID", "ONDEMAND")
MUTATION_SEED = 13
IMDB_WRITES = (("insert", "imdb_R0", 4000), ("delete", "imdb_R1", 4000),
               ("attrs", "imdb_e0", 1000), ("delete", "imdb_R2", 30000))
UW_WRITES = (("insert", "Registered", 6), ("delete", "RA", 4),
             ("attrs", "student", 5), ("insert", "RA", 40),
             ("delete", "Registered", 5), ("attrs", "course", 3),
             ("insert", "Registered", 3))
# The served discovery phase (14): the service's deadline, past which its
# dispatcher thread drains what waits; the clients of (b) and the
# searchers of (c), and the small fenced inserts (op, target, count) the
# writer of (c) makes, drawn from MUTATION_SEED + 1; the ring of the
# traced runs, large enough that no span of an IMDb discovery falls off;
# the discovery tests' score tolerance, to which 4 eps M is added (M: the
# magnitude of the score's lgamma terms, eps = 2^-24).
SERVED_MAX_WAIT_S = 0.002
SERVED_CLIENTS = 4
# The interpreter's thread switch interval while (b)'s clients run: at the
# default 5 ms one client submits a whole round and flushes it before the
# next client runs, so no query of one is pending when another asks it.
SERVED_SWITCH_S = 1e-4
SERVED_SEARCHERS = 2
SERVED_WRITES = (("insert", "imdb_R0", 100), ("insert", "imdb_R1", 100),
                 ("insert", "imdb_R2", 100))
SERVED_RING = 1 << 21
SCORE_RTOL, SCORE_ATOL = 1e-4, 1e-2
EPS32 = 2.0 ** -24


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


def device_events(prof) -> list:
    """A trace's device events by name, without the spans that annotate()
    draws over them."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def device_events_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one ``fn()`` in ms by event name: the self device time
    of each device event of ``reps`` calls under ``torch.profiler``, over
    ``reps``; host launch gaps do not count.  The profiler drops device
    events from the start of a trace (on the H100 machines, the first
    calls' kernels), so ``reps`` calls run in a warm-up step of its
    schedule, and ``reps`` more, after a pause of ``PROFILE_PAUSE_S``, in
    the step it keeps.  Every call launches the same device work, so a
    trace in which some event's count is not a multiple of ``reps`` still
    lost events: it is taken again, up to ``tries`` times.  ``None`` (not
    measured) if no trace holds every call's device events."""
    from torch.profiler import ProfilerActivity, profile, schedule
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            for step in range(2):
                if step:
                    time.sleep(PROFILE_PAUSE_S)
                for _ in range(reps):
                    fn()
                sync()
                prof.step()
        on_card = device_events(prof)
        short = {e.key[:60]: e.count for e in on_card if e.count % reps}
        if on_card and not short:
            return {e.key: e.self_device_time_total / reps / 1e3
                    for e in on_card}
        log(f"device_ms: a trace of {reps} calls held "
            f"{'no device events' if not on_card else short}")
    return None


def device_ms(fn, reps: int = 20, tries: int = 3):
    """Device time of one ``fn()`` in ms, all its events together
    (:func:`device_events_ms`); ``None`` if not measured."""
    events = device_events_ms(fn, reps, tries)
    return None if events is None else sum(events.values())


def timings(kernel, plain, library, plain_reps: int = 20) -> dict:
    """A kernels-line row's times: CUDA events around back-to-back calls
    (``ms``, ``plain_ms``, ``library_ms``) and device time
    (``device_ms``, ``plain_device_ms``, ``library_device_ms``) of the
    kernel's call, its plain version's and the library call's (``None``
    where there is none)."""
    return dict(
        ms=cuda_ms(kernel), plain_ms=cuda_ms(plain, reps=plain_reps),
        library_ms=cuda_ms(library) if library else None,
        device_ms=device_ms(kernel),
        plain_device_ms=device_ms(plain, reps=plain_reps),
        library_device_ms=device_ms(library) if library else None)


def check_no_spills(lines, name: str) -> None:
    """Fail unless ptxas reported every instance of kernel ``name`` with 0
    bytes spilled; print each one's registers, shared memory and spills."""
    props = [i for i, line in enumerate(lines)
             if "Function properties" in line and name in line]
    if not props or any(" 0 bytes spill stores, 0 bytes spill loads"
                        not in " " + lines[i + 1] for i in props):
        fail(f"{name} spills (or ptxas reported no spill line for it)")
    for i in props:
        used = next((line for line in lines[i + 2:i + 4] if "Used" in line),
                    "no register line")
        log(f"ptxas {name}: {used.split(':', 1)[-1].strip()}; "
            f"{lines[i + 1].strip()}")


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Spy:
    """Wraps the ``ops`` wrappers during a run and keeps a copy of the
    positional inputs of each kernel's largest call (by input elements),
    under the kernel's name and under each extra key that ``tags(name,
    args, kwargs)`` gives the call.  An ``out`` that a call adds into is not
    kept: the comparison sums into a zeroed table."""

    def __init__(self, ops, names, tags=lambda name, args, kwargs: ()):
        self.ops, self.orig, self.big, self.tags = ops, {}, {}, tags
        for name in names:
            self.orig[name] = getattr(ops, name)
            setattr(ops, name, self._wrap(name, self.orig[name]))

    def _wrap(self, name, fn):
        def spy(*args, **kwargs):
            size = sum(a.numel() for a in args if torch.is_tensor(a))
            for key in (name, *self.tags(name, args, kwargs)):
                if size > self.big.get(key, (0,))[0]:
                    self.big[key] = (size, tuple(
                        a.clone() if torch.is_tensor(a) else a
                        for a in args))
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
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        discover_model(db, make_strategy("HYBRID", executor="sparse"),
                       **DISCOVERY)
        sync()
    wall = time.perf_counter() - t0
    on_card = device_events(prof)
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
    for label, names in (("K1 (segsum_ones)", K1_KERNEL_NAMES),
                         ("K2 (the row scatter)", K2_KERNEL_NAMES),
                         ("K4 (bdeu)", K4_KERNEL_NAMES)):
        mine = [e for e in on_card if any(k in e.key for k in names)]
        log(f"profile: {label} "
            f"{sum(e.self_device_time_total for e in mine) / 1e3:.3f} ms of "
            f"device time in {sum(e.count for e in mine)} launches")


def k2_reading(ops, seg, r, p) -> dict:
    """K2 at one call's inputs: bit for bit against its plain version in
    the regime the wrapper chose and, where that was the privatised one,
    in the direct regime too; times of the kernel, its plain version and
    ``index_add_`` (on the ids in range, masked beforehand), the direct
    regime's device time where it was not chosen, and the bound."""
    from repro_torch.kernels.segsum import (card_of, direct_plan, rows_plan,
                                            segsum_rows_cuda,
                                            segsum_rows_plain)
    e, d = r.shape
    card = card_of(r.device)
    plan = rows_plan(e, d, p, card)
    want = segsum_rows_plain(seg, r, p)
    err = float((ops.segsum_rows(seg, r, p) - want).abs().max())
    if err != 0.0:
        fail(f"segsum_rows ({plan.regime}) differs from its plain version "
             f"by {err} at E={e} D={d} P={p}")
    keep = (seg >= 0) & (seg < p)
    seg_l, r_kept = seg[keep].long(), r[keep]
    b_ms, b_by = bound_ms(4.0 * e + 4.0 * e * d + 4.0 * p * d, e * d)
    reading = dict(
        shape=f"E={e} D={d} P={p}", regime=plan.regime, plan=list(plan),
        max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.segsum_rows(seg, r, p),
                  lambda: segsum_rows_plain(seg, r, p),
                  lambda: torch.zeros((p, d), device=r.device)
                  .index_add_(0, seg_l, r_kept)))
    if plan.regime == "private":
        direct = direct_plan(e, d, card)

        def run_direct():
            return segsum_rows_cuda(seg, r, p, torch.zeros(
                (p, d), device=r.device), direct)
        err_direct = float((run_direct() - want).abs().max())
        if err_direct != 0.0:
            fail(f"segsum_rows (direct) differs from its plain version by "
                 f"{err_direct} at E={e} D={d} P={p}")
        reading["direct_device_ms"] = device_ms(run_direct)
    return reading


def ones_alternatives(plan, e: int, p: int, card) -> list:
    """K1's plans for ``E`` edges into ``P`` segments other than ``plan``:
    the direct regime sliced (one cooperative launch) and not (a zero
    kernel first), and the privatised regime where ``P`` allows it."""
    from repro_torch.kernels.segsum import (ONES_BLOCKS_PER_SM,
                                            ONES_SLICE_BYTES, OnesPlan,
                                            ones_privatisation_limit)
    blocks = max(1, min(ONES_BLOCKS_PER_SM * card.sms, -(-e // 1024)))
    plans = [OnesPlan("direct", card.sms,
                      max(1, -(-4 * p // ONES_SLICE_BYTES))),
             OnesPlan("direct", blocks, 0)]
    if p <= ones_privatisation_limit(card):
        plans.append(OnesPlan("private", blocks, 0))
    return [x for x in plans if x != plan]


def k1_reading(ops, seg, w, p) -> dict:
    """K1 at one call's inputs: exact against its plain version in the
    plan the wrapper chose and in each of :func:`ones_alternatives`;
    device time by event (the zeroing apart from the scatter); times of
    the kernel, its plain version and ``index_add_`` (on the ids in range,
    masked beforehand) beside the bound, and each alternative's device
    time."""
    from repro_torch.kernels.segsum import (card_of, ones_plan,
                                            segsum_ones_cuda,
                                            segsum_ones_plain)
    e = seg.shape[0]
    card = card_of(seg.device)
    plan = ones_plan(e, p, card)
    others = ones_alternatives(plan, e, p, card)
    want = segsum_ones_plain(seg, w, p)
    errs = [float((got - want).abs().max()) for got in (
        ops.segsum_ones(seg, w, p),
        *(segsum_ones_cuda(seg, w, p, x) for x in others))]
    if any(errs):
        fail(f"segsum_ones differs from its plain version by {errs} "
             f"({plan}, then {others}) at E={e} P={p}")
    keep = (seg >= 0) & (seg < p)
    seg_l, w_kept = seg[keep].long(), w[keep]
    b_ms, b_by = bound_ms(8.0 * e + 4.0 * p, e)
    events = device_events_ms(lambda: ops.segsum_ones(seg, w, p))
    return dict(
        shape=f"E={e} P={p}", regime=plan.regime, plan=list(plan),
        max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.segsum_ones(seg, w, p),
                  lambda: segsum_ones_plain(seg, w, p),
                  lambda: torch.zeros(p, device=seg.device)
                  .index_add_(0, seg_l, w_kept)),
        device_ms_by_event=events and {k[:60]: v for k, v in events.items()},
        other_plans_device_ms={str(list(x)): device_ms(
            lambda x=x: segsum_ones_cuda(seg, w, p, x)) for x in others})


def log_k1(label: str, k: dict) -> None:
    log(f"K1 {label} [{k['shape']}]: {k['regime']} {k['plan']}, "
        f"max_abs_err {k['max_abs_err']}; device {k['device_ms']} ms "
        f"(events {k['ms']:.4f}; by event {k['device_ms_by_event']}), "
        f"index_add_ device {k['library_device_ms']} ms (events "
        f"{k['library_ms']:.4f}), plain device {k['plain_device_ms']} ms, "
        f"other plans {k['other_plans_device_ms']} ms, bound "
        f"{k['bound_ms']:.4f} ms ({k['bound_by']})")


def k4_scaling_reading(ops) -> dict:
    """K4 at ``K4_SCALING``, where the lgammas bind: bit for bit against
    its plain version, its device time beside the bound."""
    from repro_torch.kernels.bdeu import bdeu_plain
    b, q, r = K4_SCALING
    gen = torch.Generator(device="cuda").manual_seed(4)
    nijk = torch.randint(0, 50, (b, q, r), generator=gen,
                         device="cuda").float()
    got, want = ops.bdeu(nijk, 1.0), bdeu_plain(nijk, 1.0)
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"bdeu at B={b} q={q} r={r} is not bit-identical to its plain "
             f"version")
    b_ms, b_by = bound_ms(4.0 * nijk.numel() + 4.0 * b,
                          b * ((q * r + q) * LGAMMA_OPS + 4 * q * r + 4 * q))
    reading = dict(shape=f"B={b} q={q} r={r}", max_abs_err=0.0,
                   device_ms=device_ms(lambda: ops.bdeu(nijk, 1.0)),
                   ms=cuda_ms(lambda: ops.bdeu(nijk, 1.0)),
                   bound_ms=b_ms, bound_by=b_by)
    log(f"K4 where the lgammas bind [{reading['shape']}]: bit for bit; "
        f"device {reading['device_ms']} ms (events {reading['ms']:.4f}), "
        f"bound {b_ms:.4f} ms ({b_by})")
    return reading


def k3_reading(ops, x: torch.Tensor) -> dict:
    """K3 on ``x [B, 2^k, D]``: bit for bit against its plain version
    (compared as int32), its time beside the bound and ``matmul(T, X)``'s
    (timing only: its rounding differs above 2^24)."""
    from repro_torch.kernels.mobius import mobius_matrix, mobius_plain
    bsz, height, d = x.shape
    k = height.bit_length() - 1
    got, want = ops.mobius(x), mobius_plain(x)
    shape = f"B={bsz} 2^k={height} D={d}"
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail(f"mobius at {shape} is not bit-identical to its plain version")
    err = float((got - want).abs().max())
    del got, want
    tmat = mobius_matrix(k).to(x.device)
    b_ms, b_by = bound_ms(8.0 * x.numel(), bsz * d * k * (height // 2))
    return dict(shape=shape, max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=cuda_ms(lambda: ops.mobius(x)),
                device_ms=device_ms(lambda: ops.mobius(x)),
                library_ms=cuda_ms(lambda: torch.matmul(tmat, x)),
                library_device_ms=device_ms(lambda: torch.matmul(tmat, x)))


def k3_scaling_reading(ops) -> list:
    """K3 at ``K3_SCALING``, where its bytes bind: counts in [0, 2^30) from
    a seeded generator (above 2^24, so only the plain version's order of
    subtractions gives its bits), one :func:`k3_reading` each."""
    gen = torch.Generator(device="cuda").manual_seed(6)
    readings = []
    for b, r, d in K3_SCALING:
        x = torch.randint(0, 1 << 30, (b, r, d), generator=gen,
                          device="cuda").float()
        reading = k3_reading(ops, x)
        log(f"K3 where its bytes bind [{reading['shape']}]: bit for bit; "
            f"device {reading['device_ms']} ms (events "
            f"{reading['ms']:.4f}), matmul(T, X) device "
            f"{reading['library_device_ms']} ms (events "
            f"{reading['library_ms']:.4f}), bound {reading['bound_ms']:.5f} "
            f"ms ({reading['bound_by']}); device / bound "
            f"{(reading['device_ms'] or float('nan')) / reading['bound_ms']:.2f}")
        readings.append(reading)
        del x
    return readings


def log_row(row: dict) -> None:
    log(f"kernel {row['name']} [{row['shape']}]: {row['ms']:.4f} ms "
        f"(device {row['device_ms']}), plain {row['plain_ms']:.4f} ms "
        f"(device {row['plain_device_ms']}), library {row['library_ms']} ms "
        f"(device {row['library_device_ms']}), bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']}), max_abs_err {row['max_abs_err']}")


def log_k2(label: str, k: dict) -> None:
    log(f"K2 {label} [{k['shape']}]: {k['regime']} {k['plan']}, "
        f"max_abs_err {k['max_abs_err']}; device {k['device_ms']} ms "
        f"(events {k['ms']:.4f}), index_add_ device "
        f"{k['library_device_ms']} ms (events {k['library_ms']:.4f}), plain "
        f"device {k['plain_device_ms']} ms, direct regime device "
        f"{k.get('direct_device_ms')} ms, bound {k['bound_ms']:.4f} ms "
        f"({k['bound_by']})")


def hist_phase(ops) -> dict:
    """K5's path: ``bench_hist``'s three shapes (N, P, D), counted; each
    checked against its plain version, the largest timed (and its direct
    regime's device time where the wrapper chose the privatised one)."""
    from repro_torch.kernels.segsum import (card_of, direct_plan, rows_plan,
                                            segment_hist_plain,
                                            segsum_rows_cuda)
    gen = torch.Generator(device="cuda").manual_seed(1)
    inputs = [(torch.randint(0, p, (n,), generator=gen, device="cuda",
                             dtype=torch.int32),
               torch.rand((n, d), generator=gen, device="cuda"), p)
              for n, p, d in ((4096, 64, 128), (65536, 256, 128),
                              (262144, 1024, 64))]
    sync()
    ops.reset_counts()
    t0 = time.perf_counter()
    outs = [ops.segment_hist(*args) for args in inputs]
    sync()
    launches = ops.LAUNCHES["segment_hist"]
    regimes = dict(ops.ROW_REGIMES)
    log(f"hist path (bench_hist shapes): {time.perf_counter() - t0:.4f} s "
        f"wall, {launches} segment_hist launches, by regime "
        f"{json.dumps(regimes)}")
    if launches != len(inputs):
        fail(f"segment_hist launched {launches} times, not {len(inputs)}")
    errs = []
    for (codes, vals, p), got in zip(inputs, outs):
        want = segment_hist_plain(codes, vals, p)
        errs.append(float((got - want).abs().max()))
        if not torch.allclose(got, want, rtol=1e-5, atol=1e-3):
            fail(f"segment_hist at N={codes.shape[0]} P={p} D="
                 f"{vals.shape[1]} outside rtol=1e-5, atol=1e-3 of its "
                 f"plain version (max_abs_err {errs[-1]})")
    log(f"segment_hist against its plain version at the three shapes: "
        f"max_abs_err {errs}")
    err = max(errs)
    codes, vals, p = inputs[-1]
    n, d = vals.shape
    codes_l = codes.long()
    b_ms, b_by = bound_ms(4.0 * n + 4.0 * n * d + 4.0 * p * d, n * d)
    plan = rows_plan(n, d, p, card_of(vals.device))
    direct = direct_plan(n, d, card_of(vals.device))
    return dict(
        name="segment_hist", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/hist_kernel.py:37",
        launches=launches, launches_by_regime=regimes, max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by, regime=plan.regime, plan=list(plan),
        **timings(lambda: ops.segment_hist(codes, vals, p),
                  lambda: segment_hist_plain(codes, vals, p),
                  lambda: torch.zeros((p, d), device=vals.device)
                  .index_add_(0, codes_l, vals)),
        direct_device_ms=None if plan == direct else device_ms(
            lambda: segsum_rows_cuda(codes, vals, p, torch.zeros(
                (p, d), device=vals.device), direct)),
        shape=f"N={n} P={p} D={d}; max_abs_err over the three shapes")


def sdpa_call(q, k, v):
    """One PyTorch library call of the same attention (the yardstick; the
    port never calls it), as a function of no arguments.  KV heads are
    repeated beforehand where this PyTorch has no ``enable_gqa``."""
    import torch.nn.functional as F
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        F.scaled_dot_product_attention(qt[:, :, :1], kt, vt, is_causal=True,
                                       enable_gqa=True)
        kw = dict(is_causal=True, enable_gqa=True)
    except TypeError:
        rep = q.shape[2] // k.shape[2]
        kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
        kw = dict(is_causal=True)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def lm_consistency(model, ops) -> None:
    """(c) ``tests/test_arch_smoke.py``'s property at full width and
    depth: prefill's last logits against ``forward`` at s-2, and
    ``decode_step`` at s-1 against ``forward`` at s-1."""
    b, s = LM_CHECK_BATCH, LM_CHECK_LEN
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (b, s), dtype=np.int64)).cuda()
    logits_all = model.forward({"tokens": toks})
    cache = model.init_cache(b, s)
    last, cache = model.prefill({"tokens": toks[:, :s - 1]}, cache)
    logits1, _ = model.decode_step(cache, {"token": toks[:, s - 1:],
                                           "pos": s - 1})
    for name, got, want, tol in (
            ("prefill", last, logits_all[:, s - 2], LM_PREFILL_TOL),
            ("decode", logits1, logits_all[:, s - 1], LM_DECODE_TOL)):
        if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
            fail(f"lm consistency: non-finite {name} logits")
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        log(f"lm consistency ({b} x {s}): {name} vs forward max abs diff "
            f"{diff:.5f} of max |logit| {scale:.4f} ({diff / scale:.5f}, "
            f"tolerance {tol}); argmax agreement {agree:.2f}")
        if diff > tol * scale:
            fail(f"lm consistency: {name} logits differ from forward by "
                 f"{diff} > {tol} x {scale}")


def layer0_qkv(model, tokens):
    """Layer 0's q, k, v of a prefill of ``tokens``: the same operations on
    the same tokens as in the prefill, recomputed."""
    from repro_torch.models.attention import qkv_project
    from repro_torch.models.layers import embed_lookup, rms_norm
    from repro_torch.models.model import _positions_for
    cfg = model.cfg
    with torch.no_grad():
        x = embed_lookup(model.embed, tokens).to(cfg.act_dtype())
        blk = model.blocks[0]
        return qkv_project(blk.attn, rms_norm(x, blk.norm1), cfg,
                           _positions_for(cfg, {"tokens": tokens},
                                          tokens.shape[1]))


def check_k6(ops, q, k, v, label: str, causal: bool = True) -> float:
    """K6 against its plain version on ``q, k, v`` (``K6_BF16_TOL`` in
    bf16, ``K6_F32_TOL`` in float32); the max abs error."""
    from repro_torch.kernels.attention import flash_attention_plain
    tol = K6_BF16_TOL if q.dtype == torch.bfloat16 else K6_F32_TOL
    got = ops.flash_attention(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(), **tol):
        fail(f"K6 ({q.dtype}, {label}) outside {tol} of its plain version "
             f"(max_abs_err {err})")
    return err


def k6_edge_phase(ops) -> dict:
    """7. K6 against its plain version on the edge shapes; the largest max
    abs error of each route (kernel) that the shapes took, float32's
    apart."""
    from repro_torch.kernels.attention import flash_attention_route
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(sq, sq, c) for sq in K6_EDGE_LENGTHS for c in (True, False)]
    shapes.append((*K6_EDGE_RAGGED, False))
    cases = ([(torch.bfloat16, hd) for hd in K6_EDGE_HDS]
             + [(torch.float32, hd) for hd in K6_EDGE_F32_HDS]
             + [(dtype, hd) for hd in K6_EDGE_SLICED_HDS
                for dtype in (torch.bfloat16, torch.float32)])
    h, errs, by_route = K6_EDGE_HEADS, [], {}
    t0 = time.perf_counter()
    ops.reset_counts()
    for dtype, hd in cases:
        route = flash_attention_route(dtype, hd)
        key = route if dtype == torch.bfloat16 else f"{route} float32"
        for b in K6_EDGE_BATCHES:
            for hk in K6_EDGE_KV_HEADS:
                for sq, skv, causal in shapes:
                    q = torch.randn((b, sq, h, hd), generator=gen,
                                    device="cuda").to(dtype)
                    k, v = (torch.randn((b, skv, hk, hd), generator=gen,
                                        device="cuda").to(dtype)
                            for _ in range(2))
                    label = (f"B={b} Sq={sq} Skv={skv} H={h} Hkv={hk} "
                             f"hd={hd} {'causal' if causal else 'full'} "
                             f"{str(dtype)[6:]}")
                    errs.append(check_k6(ops, q, k, v, label, causal))
                    by_route[key] = max(by_route.get(key, 0.0), errs[-1])
                    log(f"k6 edge {label}: {route}, max_abs_err "
                        f"{errs[-1]}")
    sync()
    if ops.LAUNCHES["flash_attention"] != len(errs):
        fail(f"k6 edges: {ops.LAUNCHES['flash_attention']} launches for "
             f"{len(errs)} shapes")
    log(f"k6 edges: {len(errs)} shapes within {K6_BF16_TOL} (bf16) or "
        f"{K6_F32_TOL} (float32) of the plain version, largest max_abs_err "
        f"by route {by_route}; {time.perf_counter() - t0:.1f} s")
    return by_route


def k6_sliced_reading(ops) -> dict:
    """7. The sliced route at ``K6_SLICED_SHAPE`` (causal, bf16): against
    its plain version, timed beside SDPA and its bound (bf16 operations
    of the causal pairs, or the bytes of q, k, v and out)."""
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route,
                                               head_slices)
    b, s, h, hk, hd = K6_SLICED_SHAPE
    route = flash_attention_route(torch.bfloat16, hd)
    if route != "sliced":
        fail(f"K6 takes the {route} route at hd {hd}, not the sliced one")
    gen = torch.Generator(device="cuda").manual_seed(3)
    q = torch.randn((b, s, h, hd), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((b, s, hk, hd), generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    err = check_k6(ops, q, k, v, f"sliced {K6_SLICED_SHAPE}")
    flops = 4.0 * b * h * hd * s * (s + 1) / 2       # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=f"B={b} S={s} H={h} Hkv={hk} hd={hd} causal bf16",
        slices=head_slices(hd), max_abs_err=err, bound_ms=b_ms,
        bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, causal=True),
                  lambda: flash_attention_plain(q, k, v, True),
                  sdpa_call(q, k, v), plain_reps=3))
    log(f"K6 sliced at {reading['shape']} (slices {reading['slices']}): "
        f"{reading['ms']:.4f} ms / device {reading['device_ms']} ms; SDPA "
        f"{reading['library_ms']:.4f} / {reading['library_device_ms']} ms; "
        f"plain {reading['plain_ms']:.4f} ms; bound {b_ms:.4f} ms ({b_by}); "
        f"max_abs_err {err}")
    del q, k, v
    return reading


class BatchRecorder:
    """Records, while installed, every ``Executor.positive_batch`` call's
    plan list (the call itself is unchanged).  ``summary()`` reads the
    calls afterwards: plans, stack groups (by ``plan_stack_key``), the
    groups of two or more plans (stacked), the largest, and the groups of
    one plan (which go through ``positive``)."""

    def __init__(self):
        from repro_torch.core.executors import Executor
        self.cls, self.orig, self.calls = Executor, Executor.positive_batch, []
        orig, calls = self.orig, self.calls

        def spy(ex, db, plans, stats=None):
            calls.append((ex, db, list(plans)))
            return orig(ex, db, plans, stats)
        Executor.positive_batch = spy

    def remove(self) -> None:
        self.cls.positive_batch = self.orig

    def groups(self) -> list:
        """Every call's stack groups, as ``(db, plans)``."""
        from repro_torch.core.executors import plan_stack_key
        out = []
        for _, db, plans in self.calls:
            keys = {}
            for p in plans:
                keys.setdefault(plan_stack_key(db, p), []).append(p)
            out.extend((db, g) for g in keys.values())
        return out

    def summary(self) -> dict:
        sizes = [len(g) for _, g in self.groups()]
        return dict(calls=len(self.calls),
                    plans=sum(len(c[2]) for c in self.calls),
                    groups=len(sizes), stacked=sum(n > 1 for n in sizes),
                    largest=max(sizes, default=0),
                    singletons=sum(n == 1 for n in sizes))


def counting_reading(ops, strategy, wall: float, recorder=None) -> dict:
    """A discovery run's numbers: wall, the Fig. 3 split, joins, rows
    scanned, peak device memory, launches by kernel and by K1/K2 regime,
    and (with ``recorder``) its ``positive_batch`` calls."""
    st = strategy.stats.as_dict()
    out = dict(wall_s=wall, **{k: st[k] for k in (
        "time_metadata", "time_positive", "time_negative", "joins",
        "rows_scanned", "ct_rows")},
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        launches={k: ops.LAUNCHES[k] for k in COUNTING_KERNELS},
        k1_regimes=dict(ops.ONES_REGIMES), k2_regimes=dict(ops.ROW_REGIMES))
    if recorder is not None:
        out["positive_batch"] = recorder.summary()
    return out


def replay_phase(ops, recorder) -> dict:
    """12 (replay). The recorded ``positive_batch`` plan lists once through
    ``positive_batch`` and once through ``positive`` one plan at a time, on
    a fresh sparse executor: bit for bit equal tables; K1/K2 launches,
    wall and device time of each; then every stacked group on its own,
    which must launch K1 and K2 fewer times than its plans one at a
    time."""
    from repro_torch.core.executors import SparseExecutor
    ex = SparseExecutor(device="cuda")
    lists = [(db, plans) for _, db, plans in recorder.calls]

    def batched():
        return [ex.positive_batch(db, plans) for db, plans in lists]

    def single():
        return [[ex.positive(db, p) for p in plans] for db, plans in lists]

    out, tabs = {}, {}
    for label, fn in (("batched", batched), ("single", single)):
        ops.reset_counts()
        sync()
        t0 = time.perf_counter()
        tabs[label] = fn()
        sync()
        out[label] = dict(
            wall_s=time.perf_counter() - t0,
            k1=ops.LAUNCHES["segsum_ones"], k2=ops.LAUNCHES["segsum_rows"],
            k1_regimes=dict(ops.ONES_REGIMES),
            k2_regimes=dict(ops.ROW_REGIMES))
    n_tabs = 0
    for got, want in zip(tabs["batched"], tabs["single"]):
        for g, w in zip(got, want):
            n_tabs += 1
            if g.vars != w.vars or not torch.equal(g.counts, w.counts):
                fail("replay: a batched table differs from its plan's "
                     "unbatched table")
    del tabs
    stacked = 0
    for db, group in recorder.groups():
        if len(group) < 2:
            continue
        stacked += 1
        ops.reset_counts()
        ex.positive_batch(db, group)
        n_batched = ops.LAUNCHES["segsum_ones"] + ops.LAUNCHES["segsum_rows"]
        ops.reset_counts()
        for p in group:
            ex.positive(db, p)
        n_single = ops.LAUNCHES["segsum_ones"] + ops.LAUNCHES["segsum_rows"]
        if n_batched >= n_single:
            fail(f"replay: a stacked group of {len(group)} plans launched "
                 f"K1/K2 {n_batched} times, one at a time {n_single}")
    for label, fn in (("batched", batched), ("single", single)):
        events = device_events_ms(fn, reps=2) or {}
        out[label]["device_ms"] = sum(events.values()) if events else None
        out[label]["top_device_ms"] = {
            k[:48]: v for k, v in sorted(events.items(),
                                         key=lambda kv: -kv[1])[:6]}
    out.update(tables=n_tabs, stacked_groups=stacked)
    log(f"replay of {len(lists)} positive_batch calls ({n_tabs} plans, "
        f"{stacked} stacked groups, each with fewer K1/K2 launches than one "
        f"plan at a time): tables bit for bit equal; "
        + "; ".join(f"{k}: wall {v['wall_s']:.4f} s, device "
                    f"{v['device_ms']} ms, K1 {v['k1']} {v['k1_regimes']}, "
                    f"K2 {v['k2']} {v['k2_regimes']}, largest device "
                    f"events {json.dumps(v['top_device_ms'])}"
                    for k, v in out.items() if isinstance(v, dict)))
    return out


def record_families(strategy) -> list:
    """The ``(point, keep)`` of every family table ``strategy`` serves
    from now on (its ``family_ct``, which ``family_ct_many`` also calls
    for PRECOUNT), in order."""
    asked, inner = [], strategy.family_ct

    def family_ct(point, keep):
        asked.append((point, tuple(keep)))
        return inner(point, keep)
    strategy.family_ct = family_ct
    return asked


class NoPositives:
    """A planted fault: a positive provider that finds no grounding where a
    relationship holds, so a negative phase over it subtracts nothing."""

    def __init__(self, provider):
        self.provider = provider

    def hist(self, var, keep):
        return self.provider.hist(var, keep)

    def positive(self, point, keep):
        from repro_torch.core import CtTable
        t = self.provider.positive(point, keep)
        return CtTable(t.vars, torch.zeros_like(t.counts))


def past_2_24(a: torch.Tensor, b: torch.Tensor):
    """The largest relative difference between two tables in the cells
    past 2^24, and whether any cell below it differs."""
    a, b = a.double(), b.double()
    big = torch.maximum(a.abs(), b.abs())
    diff = a != b
    low = bool((diff & (big < 2.0 ** 24)).any())
    high = diff & (big >= 2.0 ** 24)
    rel = float(((a - b).abs() / big)[high].max()) if bool(high.any()) \
        else 0.0
    return rel, low


def recount_entries(strategy, fresh) -> dict:
    """Every resident ``"pos"``, ``"full"``, ``"fam"``, ``"complete"`` and
    ``"msg"`` entry of ``strategy``'s cache against ``fresh``'s recount of
    it (``fresh``: a strategy of the same kind prepared on the same store
    after the writes).  Returns the entries compared and the keys whose
    axes differ or whose cells below 2^24 differ (``low_differs``: counts
    there are exact, so any difference is a fault), whose cells past 2^24
    differ at all (``rounded``: an in-place ``old + delta`` may round apart
    from a recount there) and by more than ``ROUNDING_PAST_2_24`` of a
    cell (``past_bound``), with the largest such relative difference.
    ``tests/test_torch_mutations.py`` runs the same comparison on the CPU
    and shows that it fails on a planted fault."""
    from repro_torch.core import LatticePoint
    cache = strategy.engine.cache
    low, rounded, high, worst, n = [], [], [], 0.0, 0
    for key in cache.keys_snapshot():
        ns, got = key[0], cache.peek(key)
        if ns == "pos":
            want = fresh.engine.contract(LatticePoint(key[2]), key[3])
        elif ns == "full":
            want = fresh.engine.contract(LatticePoint(key[2]), None)
        elif ns == "fam":
            want = fresh.family_ct(LatticePoint(key[1]), key[2])
        elif ns == "complete":
            want = fresh._complete_full(LatticePoint(key[1]))
        elif ns == "msg":
            want = fresh.provider._msg(*key[2:])
        else:
            continue
        n += 1
        # a message entry is already its (matrix, column vars) pair
        (a, a_vars), (b, b_vars) = (t if ns == "msg" else (t.counts, t.vars)
                                    for t in (got, want))
        if tuple(a_vars) != tuple(b_vars) or a.shape != b.shape:
            low.append(key)
            continue
        rel, differs_low = past_2_24(a, b.to(a.device))
        if differs_low:
            low.append(key)
        if rel > 0.0:
            rounded.append(key)
        if rel > ROUNDING_PAST_2_24:
            high.append(key)
        worst = max(worst, rel)
    return dict(entries=n, low_differs=low, rounded=rounded, past_bound=high,
                worst_past_2_24=worst)


def precount_tables(db, precount, asked, differ, edges) -> dict:
    """PRECOUNT against HYBRID and against itself on the CPU, table by
    table.  PRECOUNT projects each family from the complete table over all
    of a point's axes; HYBRID runs a Möbius join over projected positives.
    Counts past 2^24 (the groundings where a relationship does not hold:
    1e10 and more per point at IMDb's full size) are not exact in float32,
    so the two orders of operations may round them apart, as in the JAX
    package.  Each family PRECOUNT's search scored is fetched from a fresh
    HYBRID: the axes must be the same and in the same order, every cell
    below 2^24 equal bit for bit, and every cell past it within
    ``ROUNDING_PAST_2_24``.  The same families from complete tables whose
    negative phase subtracts no positive count (``NoPositives``) must
    differ from HYBRID's past 2^24 by more than that bound, in the cells
    the fault leaves nonzero (it empties every block where a relationship
    holds, which the cells below 2^24 catch on their own).  PRECOUNT on
    the CPU over the same database (``edges``: the card's models) must
    learn the same models, and give those families bit for bit (its
    families are float64 sums, exact in any order).  Models may differ
    from HYBRID's (``differ``) only at points where some family differed
    past 2^24; anywhere else fails."""
    from repro_torch.core import (build_lattice, discover_model,
                                  make_strategy)
    from repro_torch.core.mobius import complete_ct
    from repro_torch.core.strategies import _project_wide
    lattice = build_lattice(db.schema, DISCOVERY["max_chain_length"])
    ref = make_strategy("HYBRID", executor="sparse")
    ref.prepare(db, lattice)
    fams = list(dict.fromkeys(asked))
    rounded, n_rounded, worst, planted, faulty = set(), 0, 0.0, 0.0, {}
    for point, keep in fams:
        a, b = ref.family_ct(point, keep), precount.family_ct(point, keep)
        if a.vars != b.vars or a.counts.shape != b.counts.shape:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} has "
                 f"axes {[str(v) for v in b.vars]}, HYBRID's "
                 f"{[str(v) for v in a.vars]}")
        rel, low = past_2_24(a.counts, b.counts)
        if low:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs from HYBRID's in a cell below 2^24")
        if rel > ROUNDING_PAST_2_24:
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs from HYBRID's past 2^24 by {rel} of a cell, "
                 f"more than {ROUNDING_PAST_2_24}")
        if rel > 0.0:
            n_rounded += 1
            rounded.add(str(point))
        worst = max(worst, rel)
        if point not in faulty:
            full = precount._complete_full(point)
            faulty[point] = complete_ct(point, full.vars,
                                        NoPositives(precount.provider))
        # the fault empties every block where a relationship holds; what it
        # leaves is the negative phase proper, short of no subtraction
        f = _project_wide(faulty[point], keep).counts
        planted = max(planted, past_2_24(a.counts[f != 0], f[f != 0])[0])
    if planted <= ROUNDING_PAST_2_24:
        fail(f"PRECOUNT: a negative phase that subtracts no positive count "
             f"differs from HYBRID past 2^24 by {planted} of a cell at "
             f"most, within the bound {ROUNDING_PAST_2_24}")
    if not set(differ) <= rounded:
        fail(f"PRECOUNT: models differ from phase 3's HYBRID at "
             f"{sorted(set(differ) - rounded)}, where every family table "
             f"equals HYBRID's")
    del ref, faulty
    t0 = time.perf_counter()
    on_cpu = make_strategy("PRECOUNT", executor="sparse", device="cpu")
    cpu_models, on_cpu = discover_model(db, on_cpu, device="cpu",
                                        **DISCOVERY)
    if edges_of(cpu_models) != edges:
        fail(f"PRECOUNT: card and CPU models differ:\n{edges}\n"
             f"{edges_of(cpu_models)}")
    for point, keep in fams:
        got, want = precount.family_ct(point, keep), \
            on_cpu.family_ct(point, keep)
        if got.vars != want.vars or not torch.equal(got.counts.cpu(),
                                                    want.counts):
            fail(f"PRECOUNT: family {[str(v) for v in keep]} of {point} "
                 f"differs between the card and the CPU")
    return dict(families=len(fams), rounded_past_2_24=n_rounded,
                largest_relative_difference=worst,
                planted_fault_relative_difference=planted,
                bound=ROUNDING_PAST_2_24,
                points_with_rounded_tables=sorted(rounded),
                models_differ_at=differ,
                cpu_witness_s=time.perf_counter() - t0)


def strategies_phase(ops, hybrid: dict) -> dict:
    """12. ONDEMAND, PRECOUNT and tight-budget HYBRID discovery on the IMDb
    stand-in (``STRATEGY_RUNS``), each against phase 3's HYBRID run
    (``hybrid``: its reading and learned edges), then the replay of the
    ONDEMAND run's ``positive_batch`` calls."""
    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    t_phase = time.perf_counter()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    runs = {"HYBRID (phase 3)": hybrid["reading"]}
    ondemand = None
    for label, name, kw, kernels in STRATEGY_RUNS:
        strategy = make_strategy(name, executor="sparse", **kw)
        asked = record_families(strategy)
        recorder = BatchRecorder()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_counts()
        sync()
        t0 = time.perf_counter()
        models, strategy = discover_model(db, strategy, **DISCOVERY)
        sync()
        wall = time.perf_counter() - t0
        recorder.remove()
        reading = counting_reading(ops, strategy, wall, recorder)
        log(f"{label} (IMDb, sparse): {wall:.3f} s wall; "
            + json.dumps(reading))
        if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
            fail(f"{label}: plain versions ran on the card: "
                 f"{ops.PLAIN_CALLS}")
        if any(reading["launches"][k] <= 0 for k in kernels):
            fail(f"{label}: a kernel of its path was not launched: "
                 f"{reading['launches']}")
        edges = edges_of(models)
        differ = sorted(p for p in set(edges) | set(hybrid["edges"])
                        if edges.get(p) != hybrid["edges"].get(p))
        if name == "PRECOUNT":
            reading["tables"] = precount_tables(db, strategy, asked,
                                                differ, edges)
        elif differ:
            fail(f"{label}: models differ from phase 3's HYBRID at {differ}")
        if not all(np.isfinite(m.score) for m in models.values()):
            fail(f"{label}: a learned model has a non-finite score")
        runs[label] = reading
        if name == "ONDEMAND":
            ondemand = recorder
        del models, strategy
    log(f"strategies: ONDEMAND and HYBRID at {TIGHT_BUDGET} B learn phase "
        f"3's models edge for edge; PRECOUNT learns its CPU run's models "
        f"edge for edge, against HYBRID "
        f"{json.dumps(runs['PRECOUNT']['tables'])}")
    replay = replay_phase(ops, ondemand)
    log(f"strategies phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(runs=runs, replay=replay)


def draw_writes(db, plan, seed: int) -> list:
    """Writes drawn from one numpy generator (``seed``), in order, each
    from the state the writes before it left: ``plan`` holds ``(op,
    target, k)`` with ``op`` ``"insert"`` (``k`` fresh pairs, random edge
    attributes), ``"delete"`` (``k`` random edges) or ``"attrs"`` (``k``
    random rows of one random attribute).  Each write is ``(label, op,
    target, arrays...)``, so every copy of the store takes the same one
    (:func:`apply_write`)."""
    import copy
    rng = np.random.default_rng(seed)
    scratch = copy.deepcopy(db)
    out = []
    for op, target, k in plan:
        if op == "insert":
            tab = scratch.relations[target]
            ns = scratch.entities[tab.type.src].size
            nd = scratch.entities[tab.type.dst].size
            have = tab.src.astype(np.int64) * nd + tab.dst.astype(np.int64)
            cand = np.unique(rng.integers(0, ns * nd, size=2 * k + 16,
                                          dtype=np.int64))
            cand = rng.permutation(cand[~np.isin(cand, have)])[:k]
            if cand.size != k:
                fail(f"draw_writes: fewer than {k} fresh pairs for {target}")
            arrays = ((cand // nd).astype(np.int32),
                      (cand % nd).astype(np.int32),
                      {a.name: rng.integers(0, a.card, size=k).astype(
                          np.int32) for a in tab.type.attrs})
        elif op == "delete":
            tab = scratch.relations[target]
            pick = rng.choice(tab.num_edges, size=k, replace=False)
            arrays = (tab.src[pick].copy(), tab.dst[pick].copy())
        else:
            tab = scratch.entities[target]
            attr = tab.type.attrs[int(rng.integers(len(tab.type.attrs)))]
            rows = rng.choice(tab.size, size=k, replace=False).astype(
                np.int32)
            arrays = (rows, {attr.name: rng.integers(
                0, attr.card, size=k).astype(np.int32)})
        detail = f".{attr.name}" if op == "attrs" else ""
        write = (f"{op} {k:,} {target}{detail}", op, target) + arrays
        apply_write(scratch, write)
        out.append(write)
    return out


def apply_write(db, write):
    """One write of :func:`draw_writes` to ``db``; the applied delta."""
    _, op, target, *arrays = write
    if op == "insert":
        return db.insert_facts(target, *arrays)
    if op == "delete":
        return db.delete_facts(target, *arrays)
    return db.update_attrs(target, *arrays)


def cache_diffs(a, b) -> list:
    """The resident keys where two strategies' caches differ: a key on one
    side only, another stamp or other axes, or any cell not equal bit for
    bit."""
    ca, cb = a.engine.cache, b.engine.cache
    ka, kb = ca.keys_snapshot(), cb.keys_snapshot()
    out = sorted(map(str, set(ka) ^ set(kb)))
    for key in set(ka) & set(kb):
        (ma, xa), (mb, xb) = (v if key[0] == "msg" else (v.counts, v.vars)
                              for v in (ca.peek(key), cb.peek(key)))
        if (ca.entry_meta(key) != cb.entry_meta(key)
                or tuple(xa) != tuple(xb)
                or not torch.equal(ma.cpu(), mb.cpu())):
            out.append(str(key))
    return out


def kernel_counts(ops) -> dict:
    """K1-K4 launches since the last ``reset_counts``, K1's and K2's by
    regime."""
    return dict(k1=ops.LAUNCHES["segsum_ones"],
                k2=ops.LAUNCHES["segsum_rows"], k3=ops.LAUNCHES["mobius"],
                k4=ops.LAUNCHES["bdeu"],
                k1_regimes=dict(ops.ONES_REGIMES),
                k2_regimes=dict(ops.ROW_REGIMES))


def check_no_plain(ops, label: str) -> None:
    if any(ops.PLAIN_CALLS[k] for k in ops.KERNELS):
        fail(f"{label}: plain versions ran on the card: {ops.PLAIN_CALLS}")


def prepared(name: str, db, lattice):
    """A fresh ``name`` strategy over the sparse executor on the card,
    prepared on ``db``: the recount side of :func:`recount_entries`."""
    from repro_torch.core import make_strategy
    fresh = make_strategy(name, executor="sparse")
    fresh.prepare(db, lattice)
    return fresh


def rediscovery(ops, db, strategy, name: str, label: str) -> dict:
    """13 (c). The search on the reconciled ``strategy`` over its lattice
    (``StructureSearch`` directly: ``discover_model`` would prepare a new
    engine and drop the reconciled cache), counted (K4 must launch, no
    plain version may run), against ``discover_model`` on a fresh strategy
    over the mutated store: edge for edge, except at points where a
    family's cells past 2^24 differ between the two, or whose climb
    inherits a differing sub-point's edges (printed with the edges each
    side alone has)."""
    from repro_torch.core import (LatticePoint, StructureSearch,
                                  discover_model, make_strategy)
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    models = StructureSearch(db, strategy,
                             max_parents=DISCOVERY["max_parents"]).run(
        strategy.lattice)
    sync()
    wall = time.perf_counter() - t0
    launches = kernel_counts(ops)
    check_no_plain(ops, f"{label}: the search on the reconciled cache")
    if launches["k4"] <= 0:
        fail(f"{label}: the search after the writes launched no K4")
    t0 = time.perf_counter()
    fresh_models, fresh = discover_model(
        db, make_strategy(name, executor="sparse"), **DISCOVERY)
    sync()
    fresh_wall = time.perf_counter() - t0
    got, want = edges_of(models), edges_of(fresh_models)
    differ = sorted(p for p in set(got) | set(want)
                    if got.get(p) != want.get(p))
    if differ:
        out = recount_entries(strategy, fresh)
        rounded = {str(LatticePoint(key[1])) for key in out["rounded"]
                   if key[0] in ("fam", "complete")}
        # a point's climb starts from its sub-points' edges, so a sub-point
        # whose model differs explains the point's difference too
        why = {}
        for point in strategy.lattice:            # bottom-up
            p = str(point)
            subs = [str(q) for q in strategy.lattice
                    if q.rels < point.rels and str(q) in why]
            if p in differ and (p in rounded or subs):
                why[p] = ("a family rounded apart past 2^24 here"
                          if p in rounded else f"inherits from {subs}")
        for p in differ:
            a, b = set(got.get(p, ())), set(want.get(p, ()))
            log(f"  {label}: models differ at {p} "
                f"({why.get(p, 'unexplained')}): reconciled only "
                f"{sorted(a - b)}, fresh only {sorted(b - a)}")
        if set(differ) - set(why):
            fail(f"{label}: the reconciled search's models differ from a "
                 f"fresh discovery at {sorted(set(differ) - set(why))}, "
                 f"where no family's cells past 2^24 differ and no "
                 f"sub-point's model differs")
    if not all(np.isfinite(m.score) for m in models.values()):
        fail(f"{label}: a model of the reconciled search has a non-finite "
             f"score")
    return dict(search_s=wall, fresh_discover_s=fresh_wall,
                k4=launches["k4"], models_differ_at=differ)


def uw_mutations(ops) -> dict:
    """13 (d). UW at ``UW_SCALE``, every strategy over both executors,
    warmed by discovery on the card and on the CPU, then the same seeded
    interleaving of inserts, deletes and attribute writes (``UW_WRITES``)
    reconciled on both: equal ``DeltaReport``s, and every resident entry
    bit for bit equal between the card and the CPU after every write, and
    again once every point's full-axes family is asked for anew (UW's
    counts are below 2^24)."""
    import copy

    from repro_torch.core import (STRATEGIES, discover_model, make_strategy,
                                  paper_benchmark_db)
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    writes = draw_writes(uw, UW_WRITES, MUTATION_SEED)
    out = {}
    for sname in sorted(STRATEGIES):
        for ex in ("sparse", "dense"):
            t0 = time.perf_counter()
            dbs = {"card": copy.deepcopy(uw), "cpu": copy.deepcopy(uw)}
            sts = {
                "card": discover_model(dbs["card"], make_strategy(
                    sname, executor=ex))[1],
                "cpu": discover_model(dbs["cpu"], make_strategy(
                    sname, executor=ex, device="cpu"), device="cpu")[1]}
            reports = []
            for write in writes:
                reps = {d: sts[d].apply_delta(apply_write(dbs[d], write))
                        .as_dict() for d in dbs}
                if reps["card"] != reps["cpu"]:
                    fail(f"UW {sname}/{ex}, {write[0]}: reports differ: "
                         f"{reps}")
                for when in ("reconciled", "asked again"):
                    diffs = cache_diffs(sts["card"], sts["cpu"])
                    if diffs:
                        fail(f"UW {sname}/{ex}, {write[0]} ({when}): card "
                             f"and CPU caches differ at "
                             f"{[d[:120] for d in diffs[:5]]}")
                    # every point's full-axes family once more on both, so
                    # that what the write invalidated is resident again
                    for st in sts.values():
                        for p in st.lattice:
                            st.family_ct(p, p.all_ct_vars(uw.schema))
                reports.append(reps["card"])
            out[f"{sname}/{ex}"] = dict(
                entries=len(sts["card"].engine.cache),
                updated=sum(r["updated"] for r in reports),
                invalidated=sum(r["invalidated"] for r in reports),
                seconds=time.perf_counter() - t0)
            log(f"UW {sname}/{ex}: {len(writes)} writes reconciled on the "
                f"card and the CPU, equal reports and caches bit for bit: "
                f"{json.dumps(out[f'{sname}/{ex}'])}")
    return out


def mutations_phase(ops) -> dict:
    """13. Writes and delta count maintenance on the card: (a)-(c) on the
    IMDb stand-in at ``IMDB_SCALE``, (d) on UW (module docstring)."""
    import copy
    import dataclasses

    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    writes = draw_writes(base, IMDB_WRITES, MUTATION_SEED)
    # (a) warm caches on copies of the store (phases 3 and 12 keep theirs);
    # one more HYBRID copy takes every write under torch.profiler (device
    # busy time), and one the first write with its sign flipped (the
    # planted fault)
    stores, warm = {}, {}
    for label in MUTATION_STRATEGIES + ("profiled", "planted"):
        stores[label] = copy.deepcopy(base)
        t0 = time.perf_counter()
        _, warm[label] = discover_model(
            stores[label], make_strategy(
                label if label in MUTATION_STRATEGIES else "HYBRID",
                executor="sparse"), **DISCOVERY)
        sync()
        log(f"mutations: {label} warmed on a copy of IMDb in "
            f"{time.perf_counter() - t0:.3f} s; cache "
            f"{json.dumps(warm[label].engine.cache.info())}")
    del base
    totals = {k: 0 for k in ("k1", "k2", "k3")}
    regimes = {"k1": {}, "k2": {}}
    by_write, busy, readings = {}, {}, []
    for i, write in enumerate(writes):
        wlabel = write[0]
        by_write[wlabel] = {}
        for name in MUTATION_STRATEGIES:
            st, db = warm[name], stores[name]
            delta = apply_write(db, write)
            ops.reset_counts()
            sync()
            t0 = time.perf_counter()
            report = st.apply_delta(delta)
            sync()
            wall = time.perf_counter() - t0
            launches = kernel_counts(ops)
            check_no_plain(ops, f"{name}, {wlabel}")
            for k in totals:
                totals[k] += launches[k]
            for k in regimes:
                for r, n in launches[f"{k}_regimes"].items():
                    regimes[k][r] = regimes[k].get(r, 0) + n
            by_write[wlabel][name] = {k: launches[k] for k in totals}
            if write[1] != "attrs":
                # apply_delta's default max_update_fraction: 0.25
                small = delta.num_edges <= 0.25 * db.relations[
                    write[2]].num_edges
                if small and report.invalidated:
                    fail(f"{name}, {wlabel}: a small fact delta invalidated "
                         f"{report.invalidated} entries")
                if not small and (report.updated or not report.invalidated):
                    fail(f"{name}, {wlabel}: a delta above "
                         f"max_update_fraction updated {report.updated} "
                         f"entries in place, invalidated "
                         f"{report.invalidated}")
            if i == 0 and name == "HYBRID" and (
                    launches["k1"] + launches["k2"] <= 0
                    or launches["k3"] <= 0 or report.updated <= 0):
                fail(f"{name}, {wlabel}: the reconciliation did not update "
                     f"in place through K1 or K2 and K3: {launches}")
            # (b) every resident entry against a recount on this store
            t0 = time.perf_counter()
            check = recount_entries(st, prepared(name, db, st.lattice))
            sync()
            recount_wall = time.perf_counter() - t0
            if check["low_differs"] or check["past_bound"]:
                fail(f"{name}, {wlabel}: resident entries differ from a "
                     f"recount: below 2^24 at "
                     f"{[str(k)[:120] for k in check['low_differs'][:5]]}, "
                     f"past 2^24 beyond {ROUNDING_PAST_2_24} at "
                     f"{[str(k)[:120] for k in check['past_bound'][:5]]}")
            reading = dict(
                write=wlabel, strategy=name, report=report.as_dict(),
                reconcile_s=wall, launches=launches,
                recount_s=recount_wall, entries_compared=check["entries"],
                rounded_past_2_24=len(check["rounded"]),
                worst_past_2_24=check["worst_past_2_24"])
            # (c) the search on the reconciled cache against a fresh one
            reading["rediscovery"] = rediscovery(ops, db, st, name,
                                                 f"{name}, {wlabel}")
            readings.append(reading)
            log(f"mutations: {name}, {wlabel}: "
                f"{json.dumps(report.as_dict())}; reconcile {wall:.4f} s; "
                f"K1 {launches['k1']} {launches['k1_regimes']}, K2 "
                f"{launches['k2']} {launches['k2_regimes']}, K3 "
                f"{launches['k3']}; recount of {check['entries']} entries "
                f"{recount_wall:.3f} s, equal below 2^24 ("
                f"{len(check['rounded'])} rounded apart past it, at most "
                f"{check['worst_past_2_24']} of a cell); rediscovery "
                f"{json.dumps(reading['rediscovery'])}")
        # device busy time of the same reconciliation on the profiled copy
        delta = apply_write(stores["profiled"], write)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            warm["profiled"].apply_delta(delta)
            sync()
        on_card = device_events(prof)
        busy[wlabel] = (sum(e.self_device_time_total for e in on_card) / 1e3
                        if on_card else None)
        log(f"mutations: HYBRID, {wlabel}: device busy {busy[wlabel]} ms in "
            f"{sum(e.count for e in on_card)} device events (the profiled "
            f"copy)")
        if i == 0:
            # the planted fault: the same insert reconciled as a delete
            planted, db = warm.pop("planted"), stores.pop("planted")
            planted.apply_delta(dataclasses.replace(apply_write(db, write),
                                                    op="delete"))
            check = recount_entries(planted, prepared("HYBRID", db,
                                                      planted.lattice))
            if not check["low_differs"]:
                fail("mutations: the first write reconciled with its sign "
                     "flipped matches a recount below 2^24: the comparison "
                     "cannot fail")
            log(f"mutations: the planted fault (the insert reconciled as a "
                f"delete) is caught: {len(check['low_differs'])} of "
                f"{check['entries']} entries differ below 2^24")
            del planted, db
    del warm, stores
    uw = uw_mutations(ops)
    log(f"mutations phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(readings=readings, launches=totals,
                launches_by_regime=regimes, by_write=by_write,
                hybrid_device_busy_ms=busy, uw=uw)


def memo_scores(dsvc) -> dict:
    """A discovery service's family scores under the version its last
    result settled on, by ``(child, parents)``."""
    token = dsvc._token
    return {fam: s for (tok, fam), s in dsvc._memo.items() if tok == token}


def family_tables(dsvc, csvc, fams) -> dict:
    """Each family's table as the counting service ``csvc`` serves it now,
    at the lattice point the family was scored at (its relation set,
    ``dsvc._deps``), by family: ``(point, table)``."""
    axes = {p: set(p.all_ct_vars(dsvc.schema, include_rind=True))
            for p in dsvc.lattice}
    out = {}
    for fam in fams:
        child, parents = fam
        keep = tuple(sorted(parents)) + (child,)
        point = next((p for p in dsvc.lattice
                      if p.rels == dsvc._deps.get(fam)
                      and set(keep) <= axes[p]), None)
        if point is None:
            fail(f"family {child} <- {sorted(map(str, parents))} was scored "
                 f"at no lattice point of its relations")
        out[fam] = (point, csvc.count_complete(point, keep))
    return out


def rescore(tables: dict, ess: float = 1.0) -> dict:
    """K4 on each family's table (``family_tables``), grouped by ``N_ijk``
    shape as the search groups them."""
    from repro_torch.core.bdeu import bdeu_score_batch, family_nijk
    groups = {}
    for fam, (_, tab) in tables.items():
        nijk = family_nijk(tab, fam[0])
        groups.setdefault(tuple(nijk.shape), []).append((fam, nijk))
    out = {}
    for members in groups.values():
        scores = bdeu_score_batch(torch.stack([n for _, n in members]),
                                  ess).cpu().numpy()
        out.update({fam: float(s) for (fam, _), s in zip(members, scores)})
    return out


def score_bound(nijk: torch.Tensor, ess: float = 1.0) -> float:
    """How far a float32 BDeu score of ``nijk`` may lie from another of the
    same counts: the discovery tests' ``atol + rtol |score|`` plus ``4 eps
    M`` (``M``: the magnitude of its lgamma terms, float64)."""
    n = nijk.double()
    q, r = n.shape
    a_j, a_jk = ess / q, ess / (q * r)
    lg = torch.lgamma
    row, cell = lg(n.sum(1) + a_j), lg(n + a_jk)
    c_j = torch.lgamma(torch.tensor(a_j, dtype=torch.float64))
    c_jk = torch.lgamma(torch.tensor(a_jk, dtype=torch.float64))
    exact = float((c_j - row + (cell - c_jk).sum(1)).sum())
    mag = float((c_j.abs() + row.abs()
                 + (cell.abs() + c_jk.abs()).sum(1)).sum())
    return SCORE_ATOL + SCORE_RTOL * abs(exact) + 4 * EPS32 * mag


def refresh_check(dsvc, csvc, fresh_dsvc, fresh_csvc) -> dict:
    """A refreshed discovery service (``dsvc`` over ``csvc``) against a
    fresh relearn of the same store (``fresh_dsvc`` over ``fresh_csvc``),
    family by family.  ``stale``: families whose refreshed score is not
    K4's score, bit for bit, of the table the service now holds (a score
    carried forward across a write to its relations); ``low_differs``:
    families scored by both whose scores differ where the relearn's table
    stays below 2^24 (its counts are exact there); ``past_bound``: those
    past 2^24 whose scores differ by more than ``score_bound``.  A correct
    refresh has none of the three.  ``tests/test_torch_discovery_service
    .py`` runs the same check on the CPU and shows that it fails on a
    refresh that names the wrong relation."""
    from repro_torch.core.bdeu import family_nijk
    got, want = memo_scores(dsvc), memo_scores(fresh_dsvc)
    now = rescore(family_tables(dsvc, csvc, got), dsvc.ess)
    stale = [fam for fam, s in got.items() if s != now[fam]]
    fresh = family_tables(fresh_dsvc, fresh_csvc, want)
    low, over, past, worst = [], [], 0, 0.0
    common = [fam for fam in want if fam in got]
    for fam in common:
        g, w = got[fam], want[fam]
        tab = fresh[fam][1]
        if float(tab.counts.abs().max()) < 2.0 ** 24:
            if g != w:
                low.append(fam)
            continue
        past += 1
        bound = score_bound(family_nijk(tab, fam[0]), dsvc.ess)
        worst = max(worst, abs(g - w) / bound)
        if abs(g - w) > bound:
            over.append(fam)
    return dict(families=len(got), compared=len(common),
                only_in_relearn=len(want) - len(common), stale=stale,
                low_differs=low, past_2_24=past, past_bound=over,
                worst_fraction_of_bound=worst)


def refresh_faults(check: dict) -> list:
    """The kinds of fault a :func:`refresh_check` found."""
    return [k for k in ("stale", "low_differs", "past_bound") if check[k]]


def refresh_summary(check: dict) -> dict:
    """A :func:`refresh_check` with its family lists as their lengths."""
    return {k: len(v) if isinstance(v, list) else v for k, v in check.items()}


def span_breakdown(records) -> dict:
    """Seconds and counts of a tracer's spans by name (spans nest: a
    batch's dispatch lies inside its ``service.exec`` span, and each
    query of a batch has an exec span of its own over the same time)."""
    out = {}
    for r in records:
        n, sec = out.get(r.name, (0, 0.0))
        out[r.name] = (n + 1, sec + r.duration_s)
    return {name: dict(count=n, seconds=sec)
            for name, (n, sec) in sorted(out.items())}


def exec_threads(tracer, label: str) -> dict:
    """The threads that ran the service's batches, by ``service.exec``
    span; fails unless the ring kept every span and ``build_trees`` nests
    every ``service.exec`` under a ``service.queue`` span."""
    from repro_torch.obs import build_trees
    snap = tracer.snapshot()
    if snap["dropped"]:
        fail(f"{label}: the tracer's ring dropped {snap['dropped']} spans")
    threads, orphans = {}, []

    def walk(node, parent):
        if node["name"] == "service.exec":
            threads[node["thread"]] = threads.get(node["thread"], 0) + 1
            if parent != "service.queue":
                orphans.append(node["span_id"])
        for child in node["children"]:
            walk(child, node["name"])

    for tree in build_trees(tracer.records()):
        for root in tree["roots"]:
            walk(root, None)
    if not threads or orphans:
        fail(f"{label}: {len(orphans)} of {sum(threads.values())} "
             f"service.exec spans have no service.queue parent")
    return threads


def explain_model_differences(label: str, lattice, got: dict, want: dict,
                              cache_a, cache_b) -> list:
    """The points where two discoveries' models (``edges_of``) differ must
    be points where a family table the two counting caches both hold
    differs past 2^24, or points whose climb inherits a differing
    sub-point's edges; printed with the edges each side alone has.  A
    family table that differs below 2^24 fails, as does any other
    difference."""
    from repro_torch.core import LatticePoint
    differ = sorted(p for p in set(got) | set(want)
                    if got.get(p) != want.get(p))
    if not differ:
        return differ
    rounded = set()
    for key in set(cache_a.keys_snapshot()) & set(cache_b.keys_snapshot()):
        if key[0] != "fam":
            continue
        a, b = cache_a.peek(key), cache_b.peek(key)
        rel, low = past_2_24(a.counts, b.counts.to(a.counts.device))
        if low:
            fail(f"{label}: family {[str(v) for v in key[2]]} of "
                 f"{LatticePoint(key[1])} differs below 2^24")
        if rel > 0.0:
            rounded.add(str(LatticePoint(key[1])))
    why = {}
    for point in lattice:                         # bottom-up
        p = str(point)
        subs = [str(q) for q in lattice if q.rels < point.rels
                and str(q) in why]
        if p in differ and (p in rounded or subs):
            why[p] = ("a family rounded apart past 2^24 here"
                      if p in rounded else f"inherits from {subs}")
    for p in differ:
        a, b = set(got.get(p, ())), set(want.get(p, ()))
        log(f"  {label}: models differ at {p} "
            f"({why.get(p, 'unexplained')}): this run only "
            f"{sorted(a - b)}, the other only {sorted(b - a)}")
    if set(differ) - set(why):
        fail(f"{label}: models differ at {sorted(set(differ) - set(why))}, "
             f"where no family's cells past 2^24 differ and no sub-point's "
             f"model differs")
    return differ


def run_clients(n: int, fn, label: str, timeout: float = 900.0) -> list:
    """``fn()`` on ``n`` threads released together; their results, in
    thread order.  Fails on an error or a thread still running after
    ``timeout`` seconds."""
    import threading
    barrier = threading.Barrier(n)
    results, errors = [None] * n, []

    def client(i):
        try:
            barrier.wait(60)
            results[i] = fn()
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,),
                                name=f"{label}-{i}") for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + timeout
    for t in threads:
        t.join(max(deadline - time.perf_counter(), 0.0))
    if any(t.is_alive() for t in threads):
        fail(f"{label}: a client thread still runs after {timeout} s")
    if errors:
        fail(f"{label}: {errors[0]!r}")
    return results


def served_phase(ops, hybrid: dict) -> dict:
    """14. Served discovery on the IMDb stand-in and on UW (module
    docstring); ``hybrid`` is phase 3's HYBRID run (its learned edges)."""
    import copy
    import threading

    from repro_torch.core import (CountingEngine, build_lattice,
                                  discover_model, make_strategy,
                                  paper_benchmark_db)
    from repro_torch.discover import DiscoveryService
    from repro_torch.obs import NULL_TRACER, Tracer
    from repro_torch.serve import CountingService
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    base = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    lattice = build_lattice(base.schema, DISCOVERY["max_chain_length"])
    (write,) = draw_writes(base, IMDB_WRITES[:1], MUTATION_SEED)
    services = []

    def service(db, tracer=NULL_TRACER, device=None):
        svc = CountingService(CountingEngine(db, "sparse", device=device),
                              max_wait_s=SERVED_MAX_WAIT_S, tracer=tracer)
        services.append(svc)
        return svc.start()

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    def stats_line(svc) -> dict:
        st = svc.stats()
        return dict(
            {k: st[k] for k in ("requests", "complete_requests", "coalesced",
                                "cache_hits", "enqueued", "batches",
                                "batched_queries", "mobius_batches",
                                "flushes", "wait_flushes")},
            buckets=len(st["buckets"]),
            largest_batch=max((b["max_batch"] for b in st["buckets"]),
                              default=0),
            mean_batch=(st["batched_queries"] / st["batches"]
                        if st["batches"] else 0.0),
            **{f"{h}_{q}": st[h][f"{q}_s"]
               for h in ("queue_wait_hist", "bucket_exec_hist", "e2e_hist")
               for q in ("p50", "p95", "p99")})

    def edges_check(label, got, want_edges, cache_a, ref_cache_fn):
        if edges_of(got) == want_edges:
            return []
        return explain_model_differences(label, lattice, edges_of(got),
                                         want_edges, cache_a,
                                         ref_cache_fn())

    launches = {}

    # (a) one client, traced
    tracer = Tracer(capacity=SERVED_RING, slow_threshold_s=None)
    svc = service(copy.deepcopy(base), tracer)
    dsvc = svc.discovery(**DISCOVERY)
    ops.reset_counts()
    res, wall = timed(dsvc.discover)
    launches["a"] = kernel_counts(ops)
    check_no_plain(ops, "served discovery")
    if any(launches["a"][k] <= 0 for k in ("k1", "k2", "k3", "k4")):
        fail(f"served discovery: a kernel of its path was not launched: "
             f"{launches['a']}")
    if not all(np.isfinite(m.score) for m in res.models.values()):
        fail("served discovery: a learned model has a non-finite score")

    def hybrid_cache():
        _, ref = discover_model(copy.deepcopy(base), make_strategy(
            "HYBRID", executor="sparse"), **DISCOVERY)
        return ref.engine.cache

    differ_a = edges_check("served (a) against phase 3", res.models,
                           hybrid["edges"], svc.engine.cache, hybrid_cache)
    stats_a = stats_line(svc)
    spans = span_breakdown(tracer.records())
    threads_a = exec_threads(tracer, "served (a)")
    log(f"served (a) IMDb, one client: {wall:.3f} s wall on the card; "
        f"families scored {res.families_scored}, restarts {res.restarts}; "
        f"stats {json.dumps(stats_a)}; launches {json.dumps(launches['a'])}; "
        f"plain calls {sum(ops.PLAIN_CALLS.values())}; models "
        f"{'edge for edge phase 3' if not differ_a else f'differ at {differ_a}'}")
    log(f"served (a) host spans (seconds, count): " + json.dumps(
        {k: [round(v['seconds'], 6), v['count']] for k, v in spans.items()}))
    log(f"served (a) service.exec spans by thread: {json.dumps(threads_a)}")
    svc.set_tracer(NULL_TRACER)
    dsvc.tracer = NULL_TRACER
    tracer.clear()
    svc_u = service(copy.deepcopy(base))
    _, wall_untraced = timed(svc_u.discovery(**DISCOVERY).discover)
    svc_p = service(copy.deepcopy(base))
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        svc_p.discovery(**DISCOVERY).discover()
        sync()
    wall_profiled = time.perf_counter() - t0
    on_card = device_events(prof)
    busy = (sum(e.self_device_time_total for e in on_card) / 1e6
            if on_card else None)
    log(f"served (a) untraced copy: {wall_untraced:.3f} s wall; profiled "
        f"copy: {wall_profiled:.3f} s wall, device busy "
        + (f"{busy:.4f} s ({100 * busy / wall_profiled:.2f} %)"
           if busy is not None else "not measured (no device events)")
        + f" in {sum(e.count for e in on_card)} device events")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")
    for extra in (svc_u, svc_p):
        extra.shutdown(timeout=60)
    del svc_u, svc_p, prof

    # (b) concurrent clients, cold and then warm
    tracer_b = Tracer(capacity=SERVED_RING, slow_threshold_s=None)
    svc_b = service(copy.deepcopy(base), tracer_b)
    dsvc_b = svc_b.discovery(**DISCOVERY)
    ops.reset_counts()
    walls_b = {}
    switch = sys.getswitchinterval()
    sys.setswitchinterval(SERVED_SWITCH_S)
    try:
        runs = {when: timed(lambda: run_clients(
            SERVED_CLIENTS, dsvc_b.discover, f"served (b) {when}"))
            for when in ("cold", "warm")}
    finally:
        sys.setswitchinterval(switch)
    for when, (results, walls_b[when]) in runs.items():
        sigs = {json.dumps(r.signature(), sort_keys=True) for r in results}
        versions = {r.version for r in results}
        if len(sigs) != 1 or len(versions) != 1:
            fail(f"served (b) {when}: {len(sigs)} signatures and "
                 f"{len(versions)} versions among {SERVED_CLIENTS} clients")
        if results[0].signature() != res.signature():
            fail(f"served (b) {when}: the clients' models differ from (a)'s")
    launches["b"] = kernel_counts(ops)
    check_no_plain(ops, "served (b)")
    stats_b = stats_line(svc_b)
    threads_b = exec_threads(tracer_b, "served (b)")
    if stats_b["coalesced"] <= 0:
        fail(f"served (b): no query coalesced among {SERVED_CLIENTS} clients")
    log(f"served (b) {SERVED_CLIENTS} clients at once: cold "
        f"{walls_b['cold']:.3f} s, warm {walls_b['warm']:.3f} s wall; one "
        f"signature and version, (a)'s; stats {json.dumps(stats_b)}; "
        f"launches {json.dumps(launches['b'])}; service.exec spans by "
        f"thread {json.dumps(threads_b)}")
    svc_b.set_tracer(NULL_TRACER)
    dsvc_b.tracer = NULL_TRACER
    del tracer_b

    # (c) a fenced write and refresh, the planted fault, then a writer
    # racing two searchers
    ops.reset_counts()
    report, write_wall = timed(lambda: svc.insert_facts(write[2],
                                                        *write[3:]))
    rep, refresh_wall = timed(lambda: dsvc.refresh(write[2]))
    if not (rep.retained > 0 and rep.rescored < rep.total_families):
        fail(f"served (c): refresh retained {rep.retained} and rescored "
             f"{rep.rescored} of {rep.total_families} families")
    svc_f = service(copy.deepcopy(svc.engine.db))
    dsvc_f = svc_f.discovery(**DISCOVERY)
    fresh, relearn_wall = timed(dsvc_f.discover)
    differ_c = edges_check("served (c) refresh against a relearn",
                           rep.result.models, edges_of(fresh.models),
                           svc.engine.cache, lambda: svc_f.engine.cache)
    check = refresh_check(dsvc, svc, dsvc_f, svc_f)
    if refresh_faults(check):
        fail(f"served (c): the refreshed scores fail the check at "
             f"{refresh_faults(check)}: {json.dumps(refresh_summary(check))}")
    svc_b.insert_facts(write[2], *write[3:])
    dsvc_b.refresh("imdb_R1")                    # names the wrong relation
    planted = refresh_check(dsvc_b, svc_b, dsvc_f, svc_f)
    if not refresh_faults(planted):
        fail("served (c): a refresh naming the wrong relation passes the "
             "refresh check: it cannot fail")
    launches["c_refresh"] = kernel_counts(ops)
    check_no_plain(ops, "served (c)")
    log(f"served (c) {write[0]}: write {write_wall:.4f} s "
        f"({json.dumps(report.as_dict())}); refresh {refresh_wall:.3f} s "
        f"(rescored {rep.rescored}, retained {rep.retained} of "
        f"{rep.total_families}) against a fresh relearn {relearn_wall:.3f} s; "
        f"models {'edge for edge' if not differ_c else f'differ at {differ_c}'}; "
        f"scores {json.dumps(refresh_summary(check))}; the planted refresh "
        f"(naming imdb_R1) fails at {refresh_faults(planted)}: "
        f"{json.dumps(refresh_summary(planted))}")
    for extra in (svc_b, svc_f):
        extra.shutdown(timeout=60)
    del svc_b, dsvc_b, svc_f, dsvc_f

    more = draw_writes(svc.engine.db, SERVED_WRITES, MUTATION_SEED + 1)
    stop, finals, errors, rounds = threading.Event(), {}, [], {}

    def writer():
        try:
            for w in more:
                svc.insert_facts(w[2], *w[3:])
                time.sleep(0.05)
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    def searcher(name):
        try:
            n = 0
            while not stop.is_set():
                dsvc.discover()
                n += 1
            finals[name] = dsvc.discover()
            rounds[name] = n + 1
        except BaseException as e:                 # noqa: BLE001
            errors.append(e)
            stop.set()

    ops.reset_counts()
    threads = [threading.Thread(target=writer, name="served-writer")]
    threads += [threading.Thread(target=searcher, args=(f"s{i}",),
                                 name=f"served-searcher-{i}")
                for i in range(SERVED_SEARCHERS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)
    race_wall = time.perf_counter() - t0
    if errors:
        fail(f"served (c) writer and searchers: {errors[0]!r}")
    if any(t.is_alive() for t in threads):
        fail("served (c) writer and searchers: a thread still runs")
    launches["c_race"] = kernel_counts(ops)
    check_no_plain(ops, "served (c) race")
    outs = list(finals.values())
    if len({r.version for r in outs}) != 1 or len(
            {json.dumps(r.signature(), sort_keys=True) for r in outs}) != 1:
        fail("served (c): the searchers' final results differ in version "
             "or signature")
    svc_g = service(copy.deepcopy(svc.engine.db))
    final = svc_g.discovery(**DISCOVERY).discover()
    differ_race = edges_check("served (c) race against a relearn",
                              outs[0].models, edges_of(final.models),
                              svc.engine.cache, lambda: svc_g.engine.cache)
    log(f"served (c) {len(more)} fenced inserts racing {SERVED_SEARCHERS} "
        f"searchers: {race_wall:.3f} s; discoveries per searcher "
        f"{json.dumps(rounds)}; final version {outs[0].version}, restarts "
        f"{[r.restarts for r in outs]}; models against a relearn of the "
        f"final store: "
        f"{'edge for edge' if not differ_race else f'differ at {differ_race}'}"
        f"; discovery stats {json.dumps(svc.stats()['discovery'])}")
    svc_g.shutdown(timeout=60)
    del svc_g

    # (d) UW: the card against the CPU, and served against local
    ops.reset_counts()
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    (uw_write,) = draw_writes(uw, UW_WRITES[:1], MUTATION_SEED)
    uw_runs = {}
    for dev in ("card", "cpu"):
        s = service(copy.deepcopy(uw), device=None if dev == "card"
                    else "cpu")
        d = s.discovery(**DISCOVERY)
        first = d.discover()
        s.insert_facts(uw_write[2], *uw_write[3:])
        r = d.refresh(uw_write[2])
        uw_runs[dev] = (first, r)
        s.shutdown(timeout=60)
    for i, label in enumerate(("discovery", "refresh")):
        a, b = (uw_runs[d][i] if i == 0 else uw_runs[d][i].result
                for d in ("card", "cpu"))
        if a.signature() != b.signature() or a.score != b.score:
            fail(f"served (d) UW {label}: card and CPU differ (scores "
                 f"{a.score!r}, {b.score!r})")
    counts = {d: (r.rescored, r.retained, r.total_families)
              for d, (_, r) in uw_runs.items()}
    if counts["card"] != counts["cpu"]:
        fail(f"served (d) UW refresh counts differ: {counts}")
    local = DiscoveryService(make_strategy("HYBRID", executor="sparse"),
                             db=copy.deepcopy(uw), **DISCOVERY).discover()
    if local.signature() != uw_runs["card"][0].signature():
        fail("served (d) UW: served and local discovery differ on the card")
    launches["d"] = kernel_counts(ops)
    log(f"served (d) UW: card and CPU equal bit for bit (score "
        f"{uw_runs['card'][0].score!r}; after {uw_write[0]} "
        f"{uw_runs['card'][1].result.score!r}, rescored/retained/total "
        f"{counts['card']}); local HYBRID {local.score!r}, the same "
        f"signature")
    for s in services:
        s.shutdown(timeout=60)
        if s.running:
            fail("served: a dispatcher thread outlived its shutdown")
    log(f"served phase: {time.perf_counter() - t_phase:.1f} s")
    return dict(
        launches=launches, wall_s=wall, wall_untraced_s=wall_untraced,
        wall_profiled_s=wall_profiled, device_busy_s=busy,
        stats=stats_a, spans=spans, exec_threads=threads_a,
        clients=dict(walls_s=walls_b, stats=stats_b),
        refresh=dict(refresh_s=refresh_wall, relearn_s=relearn_wall,
                     rescored=rep.rescored, retained=rep.retained,
                     total_families=rep.total_families,
                     check=refresh_summary(check),
                     planted=refresh_summary(planted)),
        race=dict(seconds=race_wall, discoveries=rounds),
        models_differ_at=dict(a=differ_a, c=differ_c, race=differ_race))


def k2_edge_phase(ops) -> dict:
    """9. K2 bit for bit against its plain version on the edge shapes, each
    with ids -1 and P mixed in and a non-zero ``out`` to add into: fresh
    (16-byte aligned) inputs in the regime the wrapper chooses, the same
    values as 4-byte-offset views of ``seg`` and ``rows`` (the scalar
    path), and, where the wrapper chose the privatised regime, both again
    in the direct one.  One line per shape; returns the launches by
    regime of the wrapper's calls."""
    from repro_torch.kernels.segsum import (card_of, direct_plan,
                                            privatisation_limit, rows_plan,
                                            segsum_rows_cuda,
                                            segsum_rows_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(3)
    card = card_of(torch.device("cuda"))
    limit = privatisation_limit(card)
    segments = sorted({*K2_EDGE_SEGMENTS, limit - 1, limit, limit + 1})
    ops.reset_counts()
    n_shapes = n_checks = 0
    for d in K2_EDGE_WIDTHS:
        for p in segments:
            for e in K2_EDGE_EDGES:
                if e * d > K2_EDGE_ROWS_MAX or p * d > K2_EDGE_CELLS_MAX:
                    continue
                seg_buf = torch.randint(0, p, (e + 1,), generator=gen,
                                        device="cuda", dtype=torch.int32)
                seg_buf[::7] = -1
                seg_buf[3::11] = p
                row_buf = torch.randint(0, 9, (e * d + 1,), generator=gen,
                                        device="cuda").float()
                out0 = torch.randint(0, 5, (p, d), generator=gen,
                                     device="cuda").float()
                views = {"aligned": (seg_buf[:e].clone(),
                                     row_buf[:e * d].clone().view(e, d)),
                         "offset": (seg_buf[1:], row_buf[1:].view(e, d))}
                plan = rows_plan(e, d, p, card)
                errs = {}
                for name, (seg, rows) in views.items():
                    want = segsum_rows_plain(seg, rows, p, out0.clone())
                    got = ops.segsum_rows(seg, rows, p, out=out0.clone())
                    errs[name] = float((got - want).abs().max())
                    if plan.regime == "private":
                        got = segsum_rows_cuda(seg, rows, p, out0.clone(),
                                               direct_plan(e, d, card))
                        errs[f"{name}, direct"] = float(
                            (got - want).abs().max())
                    del want, got
                n_shapes += 1
                n_checks += len(errs)
                log(f"k2 edge E={e} D={d} P={p}: {plan.regime} "
                    f"{list(plan)}; max_abs_err {errs}")
                if any(errs.values()):
                    fail(f"K2 differs from its plain version at E={e} D={d} "
                         f"P={p}: {errs}")
                del seg_buf, row_buf, out0, views
    sync()
    regimes = dict(ops.ROW_REGIMES)
    log(f"k2 edges: {n_shapes} shapes, {n_checks} checks, all bit for bit "
        f"(privatisation limit {limit} segments on this card); wrapper "
        f"launches by regime {json.dumps(regimes)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if ops.LAUNCHES["segsum_rows"] != 2 * n_shapes or min(regimes.values()) \
            <= 0:
        fail(f"k2 edges: {ops.LAUNCHES['segsum_rows']} launches for "
             f"{n_shapes} shapes, by regime {regimes}")
    return regimes


def k4_family(kind: int, q: int, r: int, gen) -> torch.Tensor:
    """One family of phase 10: all zeros (0), counts of a few with zero
    cells (1), counts above 2^20 with zero cells (2), or counts in [2^100,
    2^101) with zero cells (3), which take lgamma's slow path (the
    correctly rounded division and frexp)."""
    if kind == 0:
        return torch.zeros((q, r), device="cuda")
    lo, hi = (0, 9) if kind == 1 else (2 ** 20, 2 ** 24)
    x = torch.randint(lo, hi, (q, r), generator=gen, device="cuda").float()
    if kind == 3:
        x = (x / 2 ** 24 + 1) * 2.0 ** 100
    return x * (torch.rand((q, r), generator=gen, device="cuda") < 0.7)


def k1k4_edge_phase(ops) -> dict:
    """10. K4 bit for bit against its plain version on the edge shapes
    (``K4_EDGE_*``: family i of a shape is of kind (i + shape) % 4 of
    :func:`k4_family`), and K1 exactly against its plain version on its
    edge shapes (``K1_EDGE_*`` and the privatisation limit either side),
    with ids -1 and P mixed in and weights 0 to 3: fresh (16-byte aligned)
    inputs and 4-byte-offset views (the scalar path), through the wrapper
    and in each of :func:`ones_alternatives`.  One line per shape (K1's
    with the regime chosen); returns K1's wrapper launches by regime."""
    from repro_torch.kernels.bdeu import bdeu_plain
    from repro_torch.kernels.segsum import (card_of, ones_plan,
                                            ones_privatisation_limit,
                                            segsum_ones_cuda,
                                            segsum_ones_plain)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(5)
    ops.reset_counts()
    n_k4 = 0
    for b in K4_EDGE_B:
        for q in K4_EDGE_Q:
            for r in K4_EDGE_R:
                nijk = torch.stack([k4_family((i + n_k4) % 4, q, r, gen)
                                    for i in range(b)])
                for ess in K4_EDGE_ESS:
                    got, want = ops.bdeu(nijk, ess), bdeu_plain(nijk, ess)
                    same = torch.equal(got.view(torch.int32),
                                       want.view(torch.int32))
                    log(f"k4 edge B={b} q={q} r={r} ess={ess}: "
                        f"{'bit for bit' if same else 'DIFFERS'}, max_abs_err "
                        f"{float((got - want).abs().max())}")
                    if not same:
                        fail(f"K4 differs from its plain version at B={b} "
                             f"q={q} r={r} ess={ess}")
                n_k4 += 1
                del nijk
    if ops.LAUNCHES["bdeu"] != n_k4 * len(K4_EDGE_ESS):
        fail(f"k4 edges: {ops.LAUNCHES['bdeu']} launches for "
             f"{n_k4 * len(K4_EDGE_ESS)} checks")
    t_k4 = time.perf_counter() - t0
    card = card_of(torch.device("cuda"))
    limit = ones_privatisation_limit(card)
    segments = sorted({*K1_EDGE_SEGMENTS, limit - 1, limit, limit + 1})
    n_shapes = n_checks = 0
    for p in segments:
        for e in K1_EDGE_EDGES:
            seg_buf = torch.randint(0, p, (e + 1,), generator=gen,
                                    device="cuda", dtype=torch.int32)
            seg_buf[::7] = -1
            seg_buf[3::11] = p
            w_buf = torch.randint(0, 4, (e + 1,), generator=gen,
                                  device="cuda").float()
            views = {"aligned": (seg_buf[:e].clone(), w_buf[:e].clone()),
                     "offset": (seg_buf[1:], w_buf[1:])}
            plan = ones_plan(e, p, card)
            others = ones_alternatives(plan, e, p, card)
            errs = {}
            for name, (seg, w) in views.items():
                want = segsum_ones_plain(seg, w, p)
                errs[name] = float((ops.segsum_ones(seg, w, p) - want)
                                   .abs().max())
                for other in others:
                    got = segsum_ones_cuda(seg, w, p, other)
                    errs[f"{name}, {list(other)}"] = float(
                        (got - want).abs().max())
                del want, got
            n_shapes += 1
            n_checks += len(errs)
            log(f"k1 edge E={e} P={p}: {plan.regime} {list(plan)}; "
                f"max_abs_err {errs}")
            if any(errs.values()):
                fail(f"K1 differs from its plain version at E={e} P={p}: "
                     f"{errs}")
            del seg_buf, w_buf, views
    sync()
    regimes = dict(ops.ONES_REGIMES)
    log(f"k1k4 edges: K4 {n_k4} shapes x {len(K4_EDGE_ESS)} ess, all bit "
        f"for bit ({t_k4:.1f} s); K1 {n_shapes} shapes, {n_checks} checks, "
        f"all exact (privatisation limit {limit} segments on this card), "
        f"wrapper launches by regime {json.dumps(regimes)}; "
        f"{time.perf_counter() - t0:.1f} s")
    if ops.LAUNCHES["segsum_ones"] != 2 * n_shapes or min(regimes.values()) \
            <= 0:
        fail(f"k1 edges: {ops.LAUNCHES['segsum_ones']} launches for "
             f"{n_shapes} shapes, by regime {regimes}")
    return regimes


def log_profile(label: str, prof, wall: float) -> None:
    """Device busy time against wall time, K6's share, the top kernels."""
    on_card = device_events(prof)
    if not on_card:
        log(f"{label}: device time not measured (the trace holds no device "
            f"events)")
        return
    busy = sum(e.self_device_time_total for e in on_card) / 1e6
    k6 = sum(e.self_device_time_total for e in on_card
             if "flash_" in e.key) / 1e6
    log(f"{label}: {wall:.4f} s wall under the profiler, device busy "
        f"{busy:.4f} s ({100 * busy / wall:.2f} %), "
        f"{sum(e.count for e in on_card)} device events; K6 {k6:.4f} s "
        f"({100 * k6 / busy:.2f} % of device time)")
    for e in sorted(on_card, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} "
            f"{e.key[:100]}")


def lm_phase(ops, kind: str, edge_errs: dict) -> dict:
    """8. Qwen2.5-3B serving at full size; returns K6's kernels row, whose
    max_abs_err is the largest over the LM shapes and the edge shapes
    (bf16), and whose max_abs_err_by_route keeps each kernel's apart;
    ``edge_errs`` is :func:`k6_edge_phase`'s."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import (flash_attention_plain,
                                               flash_attention_route)
    from repro_torch.models.model import build_model

    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"lm: {LM_ARCH} at full size ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, "
        f"vocab {cfg.vocab}, {cfg.dtype}): {n_params} parameters, "
        f"initialised in {time.perf_counter() - t0:.2f} s; "
        f"memory_allocated {torch.cuda.memory_allocated()} B")

    # (c) first: it also warms up cuBLAS before the timed runs
    lm_consistency(model, ops)

    # (a) the main run
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(rng.integers(
        0, cfg.vocab, (LM_BATCH, LM_PROMPT), dtype=np.int64)).cuda()
    cache = model.init_cache(LM_BATCH, LM_PROMPT + LM_NEW)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6_launches = ops.LAUNCHES["flash_attention"]
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(LM_NEW):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": LM_PROMPT + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    log(f"lm main run: prefill {LM_BATCH} x {LM_PROMPT} tokens in "
        f"{t_prefill:.4f} s ({LM_BATCH * LM_PROMPT / t_prefill:.1f} tok/s); "
        f"{LM_NEW} decode steps x {LM_BATCH} requests in {t_decode:.4f} s "
        f"({LM_BATCH * LM_NEW / t_decode:.2f} tok/s, "
        f"{1e3 * t_decode / LM_NEW:.3f} ms/step); max_memory_allocated "
        f"{peak} B; K6 launches {k6_launches}; first tokens "
        f"{gen[0, :8].tolist()}")
    log(f"lm decode step seconds: first {steps[0]:.4f}, min {min(steps):.4f}"
        f", median {sorted(steps)[len(steps) // 2]:.4f}, max "
        f"{max(steps):.4f}")
    if k6_launches != cfg.n_layers:
        fail(f"the prefill launched K6 {k6_launches} times, not "
             f"{cfg.n_layers}")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("the plain attention ran on the card")
    if not torch.isfinite(logits).all() or logits.shape != (LM_BATCH,
                                                            cfg.vocab):
        fail(f"lm main run: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (LM_BATCH, LM_NEW + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("lm main run: generated tokens out of range")
    # four decode steps once more (rewriting the cache's last positions)
    # under the profiler
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(LM_NEW - 4, LM_NEW):
            model.decode_step(cache, {"token": tok, "pos": LM_PROMPT + i})
        sync()
        wall = time.perf_counter() - t0
    log_profile("lm decode profile (4 steps)", prof, wall)
    del cache, logits

    long_tokens = torch.from_numpy(rng.integers(
        0, cfg.vocab, (1, LM_LONG), dtype=np.int64)).cuda()
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": long_tokens})
    sync()
    t_long = time.perf_counter() - t0
    long_launches = ops.LAUNCHES["flash_attention"]
    log(f"lm long prefill: 1 x {LM_LONG} tokens in {t_long:.4f} s "
        f"({LM_LONG / t_long:.1f} tok/s); max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} B; K6 launches "
        f"{long_launches}")
    if long_launches != cfg.n_layers:
        fail(f"the long prefill launched K6 {long_launches} times")
    if not torch.isfinite(logits).all():
        fail("lm long prefill: non-finite logits")
    del cache, logits
    # K6 against its plain version at the long prefill's shape
    q, k, v = layer0_qkv(model, long_tokens)
    err_long = check_k6(ops, q, k, v, f"1 x {LM_LONG}")
    log(f"K6 against its plain version on layer 0 of the long prefill "
        f"(B=1 S={LM_LONG}): bf16 max_abs_err {err_long} (tolerance "
        f"{K6_BF16_TOL})")
    long_ms = cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True))
    long_sdpa = cuda_ms(sdpa_call(q, k, v))
    long_dev = device_ms(lambda: ops.flash_attention(q, k, v, causal=True),
                         reps=5)
    long_sdpa_dev = device_ms(sdpa_call(q, k, v), reps=5)
    long_bound, _ = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                             4.0 * q.shape[2] * q.shape[3] * LM_LONG
                             * (LM_LONG + 1) / 2, BF16_OPS_PER_S)
    log(f"K6 share of the long prefill: {long_launches} x {long_ms:.4f} ms "
        f"= {long_launches * long_ms / 1e3:.4f} s of {t_long:.4f} s "
        f"({100 * long_launches * long_ms / 1e3 / t_long:.2f} %); K6 "
        f"{long_ms:.4f} ms, SDPA {long_sdpa:.4f} ms, bound {long_bound:.4f} "
        f"ms at B=1 S={LM_LONG} on {kind}; device time K6 {long_dev} ms, "
        f"SDPA {long_sdpa_dev} ms")
    del q, k, v, long_tokens

    # the main prefill once more under the profiler: where its time goes
    cache = model.init_cache(LM_BATCH, LM_PROMPT)
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": prompts}, cache)
        sync()
    wall = time.perf_counter() - t0
    log_profile("lm prefill profile", prof, wall)
    del cache

    # (b) K6 against its plain version on layer 0's q, k, v of the main
    # prefill
    q, k, v = layer0_qkv(model, prompts)
    err = check_k6(ops, q, k, v, f"{LM_BATCH} x {LM_PROMPT}")
    err32 = check_k6(ops, q.float(), k.float(), v.float(),
                     f"{LM_BATCH} x {LM_PROMPT}")
    log(f"K6 against its plain version on layer 0 of the main prefill: "
        f"bf16 max_abs_err {err} (tolerance {K6_BF16_TOL}), float32 "
        f"max_abs_err {err32} (tolerance {K6_F32_TOL})")
    b, s, h, hd = q.shape
    hk = k.shape[2]
    by_route = dict(edge_errs)
    lm_route = flash_attention_route(q.dtype, hd)
    by_route[lm_route] = max(by_route.get(lm_route, 0.0), err, err_long)
    flops = 4.0 * b * h * hd * s * (s + 1) / 2       # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    row = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/attention.cu",
        replaces="src/repro/kernels/attention_kernel.py:66",
        launches=k6_launches, max_abs_err=max(by_route.values()),
        max_abs_err_by_route=by_route,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.flash_attention(q, k, v, causal=True),
                  lambda: flash_attention_plain(q, k, v, True),
                  sdpa_call(q, k, v), plain_reps=3),
        shape=f"B={b} S={s} H={h} Hkv={hk} hd={hd} causal bf16; "
              f"max_abs_err over this shape, 1 x {LM_LONG} and the edge "
              f"shapes (bf16), by route {by_route}")
    log(f"K6 share of the main prefill: {k6_launches} x {row['ms']:.4f} ms "
        f"= {k6_launches * row['ms'] / 1e3:.4f} s of {t_prefill:.4f} s "
        f"({100 * k6_launches * row['ms'] / 1e3 / t_prefill:.2f} %) on "
        f"{kind}")
    del model, q, k, v, prompts
    torch.cuda.empty_cache()
    return row


def nemotron_phase(ops, smi: str) -> dict:
    """11. Nemotron-4-340B serving at its published width (d_model 18,432,
    96/8 heads, hd 192, d_ff 73,728 squared-ReLU, vocab 256,000, bf16,
    random weights from generator seed 0), ``NEMOTRON_LAYERS`` of its 96
    layers: prefill/decode consistency (as phase 8's (c)); a prefill of
    ``NEMOTRON_BATCH`` x ``NEMOTRON_PROMPT`` tokens, K6 launched once per
    layer on the mma.sync route, then ``NEMOTRON_NEW`` greedy decode steps,
    and the prefill once more under ``torch.profiler``;
    K6 against its plain version on layer 0's q, k, v and timed against
    SDPA and its bound.  Returns that K6 reading (a second shape for K6's
    kernels-line row)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.attention import flash_attention_route
    from repro_torch.models.model import build_model

    t_phase = time.perf_counter()
    full = get_config(NEMOTRON_ARCH)
    cfg = full.replace(n_layers=NEMOTRON_LAYERS)
    route = flash_attention_route(cfg.act_dtype(), cfg.hd)
    if route != "mma.sync":
        fail(f"K6 takes the {route} route at hd {cfg.hd}, not mma.sync")
    torch.cuda.empty_cache()
    sync()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg).init(
        torch.Generator(device="cuda").manual_seed(0))
    sync()
    n_params = sum(p.numel() for p in model.parameters())
    log(f"nemotron: {NEMOTRON_ARCH} at full width (d_model {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.hd}, d_ff "
        f"{cfg.d_ff} {cfg.mlp}, vocab {cfg.vocab}, {cfg.dtype}); n_layers "
        f"cut from {full.n_layers} to {cfg.n_layers} so that one card holds "
        f"the weights: {n_params} parameters, initialised in "
        f"{time.perf_counter() - t0:.2f} s; memory_allocated "
        f"{torch.cuda.memory_allocated()} B, max during init "
        f"{torch.cuda.max_memory_allocated()} B; K6 route at hd {cfg.hd}: "
        f"{route}")

    lm_consistency(model, ops)

    b, s, n_new = NEMOTRON_BATCH, NEMOTRON_PROMPT, NEMOTRON_NEW
    prompts = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (b, s), dtype=np.int64)).cuda()
    cache = model.init_cache(b, s + n_new)
    sync()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, cache)
    sync()
    t_prefill = time.perf_counter() - t0
    k6_launches = ops.LAUNCHES["flash_attention"]
    tok = logits.argmax(dim=-1)[:, None]
    out, steps = [tok], []
    t0 = time.perf_counter()
    for i in range(n_new):
        t1 = time.perf_counter()
        logits, cache = model.decode_step(cache, {"token": tok,
                                                  "pos": s + i})
        tok = logits.argmax(dim=-1)[:, None]
        out.append(tok)
        sync()
        steps.append(time.perf_counter() - t1)
    t_decode = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    gen = torch.cat(out, dim=1)
    log(f"nemotron main run: prefill {b} x {s} tokens in {t_prefill:.4f} s "
        f"({b * s / t_prefill:.1f} tok/s); {n_new} decode steps x {b} "
        f"requests in {t_decode:.4f} s ({1e3 * t_decode / n_new:.3f} "
        f"ms/step; first {1e3 * steps[0]:.3f}, median "
        f"{1e3 * sorted(steps)[len(steps) // 2]:.3f} ms); "
        f"max_memory_allocated {peak} B; K6 launches {k6_launches} "
        f"({route}); first tokens {gen[0, :8].tolist()}; on {smi}")
    if k6_launches != cfg.n_layers:
        fail(f"the nemotron prefill launched K6 {k6_launches} times, not "
             f"{cfg.n_layers}")
    if ops.PLAIN_CALLS["flash_attention"]:
        fail("the plain attention ran on the card")
    if not torch.isfinite(logits).all() or logits.shape != (b, cfg.vocab):
        fail(f"nemotron main run: bad decode logits {tuple(logits.shape)}")
    if gen.shape != (b, n_new + 1) or gen.min() < 0 \
            or gen.max() >= cfg.vocab:
        fail("nemotron main run: generated tokens out of range")
    # the prefill once more under the profiler: where its time goes
    from torch.profiler import ProfilerActivity, profile
    sync()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model.prefill({"tokens": prompts}, cache)
        sync()
    log_profile("nemotron prefill profile", prof, time.perf_counter() - t0)
    del cache, logits, prof

    q, k, v = layer0_qkv(model, prompts)
    del model
    err = check_k6(ops, q, k, v, f"nemotron {b} x {s}")
    hq, hd = q.shape[2], q.shape[3]
    flops = 4.0 * b * hq * hd * s * (s + 1) / 2      # causal pairs only
    b_ms, b_by = bound_ms(2.0 * (2 * q.numel() + k.numel() + v.numel()),
                          flops, BF16_OPS_PER_S)
    reading = dict(
        shape=f"B={b} S={s} H={hq} Hkv={k.shape[2]} hd={hd} causal bf16 "
              f"(nemotron-4-340b layer 0)",
        route=route, launches=k6_launches, max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        ms=cuda_ms(lambda: ops.flash_attention(q, k, v, causal=True)),
        device_ms=device_ms(lambda: ops.flash_attention(q, k, v,
                                                        causal=True), reps=5),
        library_ms=cuda_ms(sdpa_call(q, k, v)),
        library_device_ms=device_ms(sdpa_call(q, k, v), reps=5),
        prefill_s=t_prefill, prefill_tokens_per_s=b * s / t_prefill,
        decode_ms_per_step=1e3 * t_decode / n_new, peak_bytes=peak)
    log(f"K6 on nemotron layer 0 [{reading['shape']}]: {route}, max_abs_err "
        f"{err} (tolerance {K6_BF16_TOL}); device {reading['device_ms']} ms "
        f"(events {reading['ms']:.4f}), SDPA device "
        f"{reading['library_device_ms']} ms (events "
        f"{reading['library_ms']:.4f}), bound {b_ms:.4f} ms ({b_by}); K6 "
        f"share of the prefill {k6_launches} x {reading['ms']:.4f} ms = "
        f"{100 * k6_launches * reading['ms'] / 1e3 / t_prefill:.2f} %; on "
        f"{smi}; phase {time.perf_counter() - t_phase:.1f} s")
    del q, k, v, prompts
    torch.cuda.empty_cache()
    return reading


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
    from repro_torch.kernels.bdeu import bdeu_plain, check_division
    from repro_torch.kernels.mobius import mobius_matrix, mobius_plain
    from repro_torch.kernels.segsum import card_of, ones_plan, rows_plan
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
    # the Hopper attention kernel keeps its accumulators in registers, and
    # K2's kernels stream rows through registers into shared memory
    for name in NO_SPILL_KERNELS:
        check_no_spills(info["ptxas"], name)
    # K4's lgamma takes a branch-free division and frexp: over their whole
    # domain they must give the correctly rounded operations' bits
    t0 = time.perf_counter()
    bad = check_division(torch.device("cuda"))
    log(f"K4 fast path against the correctly rounded operations over its "
        f"whole domain (Lanczos divisions, log's quotient, frexp): "
        f"{bad} operands differ ({time.perf_counter() - t0:.2f} s)")
    if any(bad):
        fail(f"K4's branch-free division or frexp differs from the correctly "
             f"rounded one on {bad} operands")

    # -- 3. main path ---------------------------------------------------------
    t0 = time.perf_counter()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    log(f"IMDb stand-in: {db.total_rows} rows, {len(db.relations)} "
        f"relationships (generated in {time.perf_counter() - t0:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_counts()
    sync()
    t0 = time.perf_counter()
    models, strategy = discover_model(
        db, make_strategy("HYBRID", executor="sparse"), **DISCOVERY)
    sync()
    wall = time.perf_counter() - t0
    hybrid = dict(reading=counting_reading(ops, strategy, wall),
                  edges=edges_of(models))
    launches = dict(ops.LAUNCHES)
    imdb_regimes = dict(ops.ROW_REGIMES)
    imdb_ones_regimes = dict(ops.ONES_REGIMES)
    peak = torch.cuda.max_memory_allocated()
    st = strategy.stats.as_dict()
    log(f"main path (IMDb, HYBRID/sparse, chains <= 2, parents <= 3): "
        f"{wall:.3f} s wall on {kind}")
    log("  stats: " + json.dumps({k: st[k] for k in (
        "joins", "rows_scanned", "ct_rows", "time_metadata",
        "time_positive", "time_negative", "peak_bytes")}))
    log(f"  max_memory_allocated: {peak} B; "
        f"learned edges: {sum(len(m.edges()) for m in models.values())}; "
        f"launches: {json.dumps(launches)}; K2 launches by regime: "
        f"{json.dumps(imdb_regimes)}; K1 launches by regime: "
        f"{json.dumps(imdb_ones_regimes)}")
    if any(launches[k] <= 0 for k in COUNTING_KERNELS):
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
    if ops.ROW_REGIMES["direct"] <= 0:
        fail("the dense-message hop did not take K2's direct regime")
    log(f"  K2 launches by regime: {json.dumps(ops.ROW_REGIMES)}")
    check_positive_invariant(vg_strategy, vg, "VisualGenome")
    del vg_strategy
    # once more, keeping K2's largest call and its largest in the direct
    # regime (the dense-message hop)
    vg_spy = Spy(ops, ("segsum_rows",), tags=lambda name, args, kwargs: (
        ("direct",) if rows_plan(args[1].shape[0], args[1].shape[1], args[2],
                                 card_of(args[1].device)).regime == "direct"
        else ()))
    make_strategy("HYBRID", executor="sparse").prepare(
        vg, build_lattice(vg.schema, 3))
    vg_spy.remove()
    del vg
    vg_k2 = {key: k2_reading(ops, *vg_spy.big[big][1])
             for key, big in (("largest", "segsum_rows"), ("hop", "direct"))}
    for key, reading in vg_k2.items():
        log_k2(f"VisualGenome {key}", reading)
    del vg_spy

    # -- 4. kernels against their plain versions ------------------------------
    # (K1's largest call, and its largest in the privatised regime: an
    # entity histogram)
    spy = Spy(ops, COUNTING_KERNELS, tags=lambda name, args, kwargs: (
        ("segsum_ones/private",) if name == "segsum_ones" and ones_plan(
            args[0].shape[0], args[2], card_of(args[0].device)).regime
        == "private" else ()))
    discover_model(db, make_strategy("HYBRID", executor="sparse"),
                   **DISCOVERY)
    spy.remove()
    del db
    rows = []
    reading = k1_reading(ops, *spy.big["segsum_ones"][1])
    log_k1("IMDb largest", reading)
    private = k1_reading(ops, *spy.big["segsum_ones/private"][1])
    log_k1("IMDb largest privatised", private)
    rows.append(dict(
        name="segsum_ones", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:103",
        launches=launches["segsum_ones"],
        launches_by_regime=imdb_ones_regimes, **reading,
        private=private))

    reading = k2_reading(ops, *spy.big["segsum_rows"][1])
    log_k2("IMDb", reading)
    rows.append(dict(
        name="segsum_rows", route="cuda",
        source="src/repro_torch/kernels/csrc/segsum.cu",
        replaces="src/repro/kernels/segsum_kernel.py:71",
        launches=launches["segsum_rows"],
        launches_by_regime=imdb_regimes, **reading,
        visualgenome=vg_k2))

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
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.mobius(x), lambda: mobius_plain(x),
                  lambda: torch.matmul(tmat, x)),
        scaling=k3_scaling_reading(ops),
        shape=f"B={bsz} 2^k={height} D={d}"))
    if err != 0.0:
        fail(f"mobius differs from its plain version by {err}")

    nijk, ess = spy.big["bdeu"][1]
    bsz, q, rr = nijk.shape
    got, want = ops.bdeu(nijk, ess), bdeu_plain(nijk, ess)
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-2):
        fail(f"bdeu outside rtol=1e-4, atol=1e-2 of its plain version")
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("bdeu is not bit-identical to its plain version")
    n_ops = bsz * ((q * rr + q) * LGAMMA_OPS + 4 * q * rr + 4 * q)
    b_ms, b_by = bound_ms(4.0 * nijk.numel() + 4.0 * bsz, n_ops)
    rows.append(dict(
        name="bdeu", route="cuda",
        source="src/repro_torch/kernels/csrc/bdeu.cu",
        replaces="src/repro/kernels/bdeu_kernel.py:40",
        launches=launches["bdeu"], max_abs_err=err,
        bound_ms=b_ms, bound_by=b_by,
        **timings(lambda: ops.bdeu(nijk, ess),
                  lambda: bdeu_plain(nijk, ess), None),
        scaling=k4_scaling_reading(ops),
        shape=f"B={bsz} q={q} r={rr}"))
    for row in rows:
        log_row(row)
    # the LM phase reads its memory with no earlier tensors held
    del spy, x, tmat, nijk, got, want

    # -- 5. card against CPU -------------------------------------------------
    uw = paper_benchmark_db("UW", seed=0, scale=UW_SCALE)
    for sname in ("HYBRID", "ONDEMAND"):
        for ex in ("sparse", "dense"):
            t0 = time.perf_counter()
            recorder = BatchRecorder()
            on_card, _ = discover_model(uw, make_strategy(sname, executor=ex))
            recorder.remove()
            on_cpu, _ = discover_model(
                uw, make_strategy(sname, executor=ex, device="cpu"),
                device="cpu")
            if edges_of(on_card) != edges_of(on_cpu):
                fail(f"UW {sname}/{ex}: card and CPU models differ:\n"
                     f"{edges_of(on_card)}\n{edges_of(on_cpu)}")
            batches = recorder.summary()
            if sname == "ONDEMAND" and batches["stacked"] == 0:
                fail(f"UW ONDEMAND/{ex}: no stacked group ran on the card")
            log(f"UW {sname}/{ex}: card and CPU models edge-identical "
                f"({sum(len(m.edges()) for m in on_card.values())} edges, "
                f"{time.perf_counter() - t0:.1f} s); positive_batch on the "
                f"card: {json.dumps(batches)}")
    del uw, on_card, on_cpu

    # -- 6. K5's path ---------------------------------------------------------
    rows.append(hist_phase(ops))

    # -- 7. K6's edge shapes, and the sliced route timed ----------------------
    edge_errs = k6_edge_phase(ops)
    sliced = k6_sliced_reading(ops)
    edge_errs["sliced"] = max(edge_errs.get("sliced", 0.0),
                              sliced["max_abs_err"])

    # -- 8. Qwen2.5-3B serving ------------------------------------------------
    rows.append(lm_phase(ops, kind, edge_errs))
    for row in rows[-2:]:
        log_row(row)

    # -- 9. K2's edge shapes --------------------------------------------------
    k2_edge_phase(ops)

    # -- 10. K4's and K1's edge shapes ----------------------------------------
    k1k4_edge_phase(ops)

    # -- 11. Nemotron-4-340B serving (hd 192: K6's mma.sync route) -----------
    k6_row = next(row for row in rows if row["name"] == "flash_attention")
    nemo = nemotron_phase(ops, smi)
    by_route = k6_row["max_abs_err_by_route"]
    by_route[nemo["route"]] = max(by_route.get(nemo["route"], 0.0),
                                  nemo["max_abs_err"])
    k6_row["max_abs_err"] = max(by_route.values())
    k6_row["nemotron"] = nemo
    k6_row["sliced"] = sliced

    # -- 12. ONDEMAND, PRECOUNT and tight-budget HYBRID on IMDb ---------------
    strategies = strategies_phase(ops, hybrid)
    for row in rows:
        if row["name"] in ("segsum_ones", "segsum_rows"):
            key = "k1" if row["name"] == "segsum_ones" else "k2"
            row["strategies"] = dict(
                launches={label: run["launches"][row["name"]]
                          for label, run in strategies["runs"].items()},
                launches_by_regime={
                    label: run[f"{key}_regimes"]
                    for label, run in strategies["runs"].items()},
                replay={k: {f: v[f] for f in (key, f"{key}_regimes")}
                        for k, v in strategies["replay"].items()
                        if isinstance(v, dict)})

    # -- 13. writes and delta count maintenance ------------------------------
    mutations = mutations_phase(ops)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2",
               "mobius": "k3"}.get(row["name"])
        if key is not None:
            row["mutations"] = dict(
                launches=mutations["launches"][key],
                by_write={w: {label: v[key] for label, v in runs.items()}
                          for w, runs in mutations["by_write"].items()})
            if key in mutations["launches_by_regime"]:
                row["mutations"]["launches_by_regime"] = \
                    mutations["launches_by_regime"][key]
        elif row["name"] == "bdeu":
            row["mutations"] = dict(rediscovery_launches=sum(
                r["rediscovery"]["k4"] for r in mutations["readings"]))

    # -- 14. served discovery ------------------------------------------------
    served = served_phase(ops, hybrid)
    for row in rows:
        key = {"segsum_ones": "k1", "segsum_rows": "k2", "mobius": "k3",
               "bdeu": "k4"}.get(row["name"])
        if key is not None:
            row["served"] = dict(
                launches=served["launches"]["a"][key],
                by_step={step: c[key]
                         for step, c in served["launches"].items()})
            if key in ("k1", "k2"):
                row["served"]["launches_by_regime"] =                     served["launches"]["a"][f"{key}_regimes"]

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(nvidia_smi())
    print(json.dumps({"kernels": [{k: v for k, v in row.items()
                                   if k != "shape"} for row in rows]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind, "count": count}}),
          flush=True)


if __name__ == "__main__":
    main()
