"""One traced run of a cell on the CUDA card, and where its idle card's
time went by the program's spans; prints one JSON object.

    python3 perfbench/span_report.py --workload <cell> --seed <n> \
        --seconds <s> [--out <file>]

from the root of a checkout.  The run is ``run.py --trace 1``'s (the
same harness and window); besides its result line, the report gives per
discovery: the card's idle seconds by the innermost span open
(``null``: under none, between discoveries included), each span name's
self seconds and count, the longest idle gaps (seconds, where in the
window they begin, the spans under them), and, for the executors'
``exec.hop`` and ``exec.root`` spans that called K1 or K2, how many
launched device work (matched by the trace's correlation id, as
``DeviceReading.launched_within`` matches).
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent / "src"), str(HERE.parent)]

#: Idle gaps listed, longest first.
TOP = 12


def report(rec: dict, result: dict, lines) -> dict:
    from perfbench import span_readers
    from perfbench import spans as sp
    spans = span_readers.window_spans(rec)
    dev, units = rec["device"], rec["units"]
    idle = sp.gaps([(s, e) for s, e, *_ in dev.device], dev.window)
    pieces = sp.innermost(spans)
    by_name = sp.time_by_name(pieces, idle)
    own = sp.self_ns(spans)
    self_by, count_by = {}, {}
    for sid, _, name, *_ in spans:
        self_by[name] = self_by.get(name, 0) + own[sid]
        count_by[name] = count_by.get(name, 0) + 1
    gaps = []
    for s, e in sorted(idle, key=lambda g: g[0] - g[1])[:TOP]:
        under = sp.time_by_name(pieces, [(s, e)])
        gaps.append([(e - s) / 1e9, (s - dev.window[0]) / 1e9, sorted(
            ([name, ns / 1e9] for name, ns in under.items()),
            key=lambda kv: -kv[1])[:3]])
    launch = {}
    for name in ("exec.hop", "exec.root"):
        calls = [(s, e) for _, _, n, s, e, a in spans
                 if n == name and (a or {}).get("kernel") in ("K1", "K2")]
        seconds, events, hit = dev.launched_within(calls)
        launch[name] = {"spans": len(calls), "launched": hit,
                        "device_events": sum(events.values()),
                        "device_s": seconds}
    per = 1.0 / units
    return {
        "result": result, "notes": list(lines), "units": units,
        "window_s": dev.window_s, "idle_s": sum(by_name.values()) / 1e9,
        "spans": len(spans), "spans_per_discovery": len(spans) * per,
        "idle_s_per_discovery": sorted(
            ([name, ns / 1e9 * per] for name, ns in by_name.items()),
            key=lambda kv: -kv[1]),
        "self_s_per_discovery": sorted(
            ([name, ns / 1e9 * per] for name, ns in self_by.items()),
            key=lambda kv: -kv[1]),
        "count_per_discovery": {n: c * per for n, c in count_by.items()},
        "longest_idle_gaps": gaps, "launched_within": launch}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no run: the report needs a CUDA card", file=sys.stderr)
        return 2
    from perfbench import harness
    kept = {}
    plain = harness.metric_reader

    def keeping(name, here=harness.ROOT):
        reader = plain(name, here)

        class Reader:
            @staticmethod
            def read(rec):
                kept["rec"] = rec
                return reader.read(rec)
        return Reader

    harness.metric_reader = keeping
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                True, t_start=T_START)
    out = report(kept["rec"], result, lines)
    out["card"] = torch.cuda.get_device_name(0)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
