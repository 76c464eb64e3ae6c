"""The paper's strategies' discovery walls on IMDb, on one CUDA card.

Run from the repository root:
    python3 scripts/strategy_walls.py [--src DIR] [--reps N] [--profile S]

(``--src``: measure the ``repro_torch`` package under DIR, another
checkout's ``src``, with this script and this checkout's ``chip_smoke``
helpers: a parent commit and its change on one card.)

Runs model discovery over the sparse executor on the IMDb stand-in at
``chip_smoke.IMDB_SCALE`` with ``chip_smoke.DISCOVERY``, ``--reps`` times
(default 3) for each of ONDEMAND (post-counting), HYBRID at its default
budget (phase 3's main path) and PRECOUNT, the strategies in turn within
each repetition.  Each run: wall (host clock ending in
``torch.cuda.synchronize()``), the Fig. 3 split, joins, and the K1/K2
launches.  ``--profile S``: then one more run of strategy S under
``cProfile``, printing the host functions that took the most time of it
(``tottime``, then ``cumtime``).  Prints one JSON object of every
reading as its last line.
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from chip_smoke import (DISCOVERY, IMDB_SCALE, log, nvidia_smi,  # noqa: E402
                        sync)

# after chip_smoke, which puts this checkout's src first on the path
SRC = Path(sys.argv[sys.argv.index("--src") + 1]).resolve() \
    if "--src" in sys.argv else ROOT / "src"
sys.path.insert(0, str(SRC))
REPS = int(sys.argv[sys.argv.index("--reps") + 1]) \
    if "--reps" in sys.argv else 3
PROFILE = sys.argv[sys.argv.index("--profile") + 1] \
    if "--profile" in sys.argv else None
STRATEGIES = ("ONDEMAND", "HYBRID", "PRECOUNT")


def main() -> None:
    if not torch.cuda.is_available():
        log("FAIL: this script needs a CUDA card")
        sys.exit(2)
    import repro_torch
    from repro_torch.core import (discover_model, make_strategy,
                                  paper_benchmark_db)
    from repro_torch.kernels import build, ops
    smi = nvidia_smi()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
        f"package {Path(repro_torch.__file__).parent}")
    if Path(repro_torch.__file__).resolve().parent != SRC / "repro_torch":
        log(f"FAIL: repro_torch came from {repro_torch.__file__}, not {SRC}")
        sys.exit(1)
    build.load()
    db = paper_benchmark_db("IMDb", seed=0, scale=IMDB_SCALE)
    # one unmeasured run first: the card's and the allocator's warm-up
    discover_model(db, make_strategy("HYBRID", executor="sparse"),
                   **DISCOVERY)
    runs = {name: [] for name in STRATEGIES}
    for _ in range(REPS):
        for name in STRATEGIES:
            ops.reset_counts()
            sync()
            t0 = time.perf_counter()
            _, strategy = discover_model(
                db, make_strategy(name, executor="sparse"), **DISCOVERY)
            sync()
            wall = time.perf_counter() - t0
            st = strategy.stats.as_dict()
            runs[name].append(dict(
                wall_s=wall, time_positive=st["time_positive"],
                time_negative=st["time_negative"], joins=st["joins"],
                k1=ops.LAUNCHES["segsum_ones"],
                k2=ops.LAUNCHES["segsum_rows"]))
            log(f"{name}: {wall:.4f} s wall; {json.dumps(runs[name][-1])}")
    if PROFILE:
        prof = cProfile.Profile()
        prof.enable()
        discover_model(db, make_strategy(PROFILE, executor="sparse"),
                       **DISCOVERY)
        sync()
        prof.disable()
        for order in ("tottime", "cumtime"):
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats(order).print_stats(25)
            log(f"{PROFILE} under cProfile, by {order}:\n{out.getvalue()}")
    print(json.dumps(dict(src=str(SRC), device=torch.cuda.get_device_name(0),
                          nvidia_smi=smi, runs=runs)))


if __name__ == "__main__":
    main()
