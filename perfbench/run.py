"""Run one cell of the benchmark on the CUDA card; print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line's metrics are
the cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and they are its per-layer metrics, with the device's
busy time and a breakdown.  Exits non-zero, printing no result, when
there is no CUDA card (or fewer than the cell asks for), when the run
fails, or when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402 — the set-up clock starts before imports
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# the program's kernel caches stay inside the checkout, at fixed paths
os.environ["TRITON_CACHE_DIR"] = str(CHECKOUT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CHECKOUT / "build"
                                         / "torch_extensions")
sys.path[:0] = [str(CHECKOUT / "src"), str(CHECKOUT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
        spec = json.loads((CHECKOUT / "BENCHMARK.json").read_text())
        chips = next(w["chips"] for w in spec["workloads"]
                     if w["name"] == args.workload)
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < chips:
            print(f"no run: the cell needs {chips} CUDA card(s), "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
                  f" available", file=sys.stderr)
            return 2
        from perfbench import harness
        result, lines = harness.run(args.workload, args.seed, args.seconds,
                                    bool(args.trace), t_start=T_START,
                                    spec_root=CHECKOUT)
    except Exception:                   # noqa: BLE001 — no result line
        traceback.print_exc()
        return 1
    bad = harness.forbidden_modules()
    if bad:
        print(f"no result: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
