"""The readings that set the limits of ``correct``.

    python3 perfbench/readings.py --workload <cell> --seeds 301-312 \
        --control-seeds 401-403 [--seconds S]

Runs the cell once per seed in this one process (set-up, a window of
``--seconds``, the check; the kernels are built once) and prints each
run's numbers; then, on each control seed, the control in the program's
place: the plain reference counting in bfloat16 throughout, and the
reference in float64 with every table rounded to bfloat16 (for
discovery, the program's structure search over those tables).  The last
line is one JSON object: every reading, the program's largest per number
and the controls' smallest.  Benchmark runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]


def seeds(text: str):
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=seeds, required=True)
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=float, default=1.0)
    args = ap.parse_args(argv)
    from perfbench import harness
    out = {"program": {}, "bfloat16": {}, "rounded": {}}
    runs = [(None, s) for s in args.seeds] + [
        (c, s) for s in args.control_seeds for c in ("bfloat16", "rounded")]
    for control, seed in runs:
        t0 = time.perf_counter()
        result, lines = harness.run(args.workload, seed, args.seconds, False,
                                    device=args.device, scale=args.scale,
                                    control=control)
        numbers = {k: v["value"] for k, v in result["checks"].items()}
        out[control or "program"][seed] = numbers
        print(json.dumps({"control": control, "seed": seed,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    summary = {}
    for key, pick in (("program", max), ("bfloat16", min), ("rounded", min)):
        names = {n for nums in out[key].values() for n in nums}
        summary[key] = {n: pick(nums[n] for nums in out[key].values()
                                if n in nums) for n in sorted(names)}
    print(json.dumps({"workload": args.workload, "readings": out,
                      "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
