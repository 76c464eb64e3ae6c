"""Compare PRECOUNT / ONDEMAND / HYBRID / TUPLEID end to end on a paper
database, through the PyTorch/CUDA port: ``examples/discover_strategies.py``
on ``repro_torch``.

Full model discovery (lattice construction, strategy pre-phase, bottom-up
hill-climbing with BDeu) is run once per strategy; all four must find the
same model (a counting strategy changes the *cost*, never the *counts*:
asserted here), while time and memory differ as in the paper's Figs. 3-4.
On the card the counts, the Möbius join and the BDeu scores are the
port's hand-written CUDA kernels.

Run:  python examples/discover_strategies_torch.py [dataset] [scale]
                                [--device cpu] [--executor sparse]
      dataset in {UW, Mondial, Hepatitis, Mutagenesis, MovieLens, Financial,
                  IMDb, VisualGenome}; default UW at full scale, on the CUDA
      card (``--device cpu``: on the host), through the strategies' default
      executor, the dense one (``--executor sparse``: the sparse one, whose
      leaf hops are the entity-histogram kernel's).
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import discover_model, make_strategy, paper_benchmark_db

STRATEGIES = ("PRECOUNT", "ONDEMAND", "HYBRID", "TUPLEID")
SEARCH = dict(max_chain_length=2, max_parents=2)
SCORE_RTOL = 1e-3


def main(argv=None) -> dict:
    """Run every strategy on the database the arguments name; returns
    ``{strategy: {"edges", "score", "wall_s", "stats"}}`` (``edges``:
    each lattice point's edge set; ``stats``: the strategy's
    ``stats.as_dict()``).  Raises ``AssertionError`` if two strategies
    learn different models."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", nargs="?", default="UW")
    ap.add_argument("scale", nargs="?", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help='counting device (default: the CUDA card; "cpu" '
                         'for the host)')
    ap.add_argument("--executor", choices=("dense", "sparse"),
                    default="dense")
    args = ap.parse_args(argv)
    db = paper_benchmark_db(args.dataset, seed=0, scale=args.scale)
    print(f"database: {args.dataset} (scale {args.scale}), {db.total_rows} "
          f"rows; {args.executor} executor")

    results = {}
    for name in STRATEGIES:
        t0 = time.perf_counter()
        models, strat = discover_model(
            db, make_strategy(name, executor=args.executor,
                              device=args.device),
            device=args.device, **SEARCH)
        wall = time.perf_counter() - t0
        st = strat.stats.as_dict()
        total = sum(m.score for m in models.values())
        results[name] = dict(
            edges={p: frozenset(m.edges()) for p, m in models.items()},
            score=total, wall_s=wall, stats=st)
        print(f"{name:9s} wall={wall:7.2f}s  "
              f"meta={st['time_metadata']:5.2f} "
              f"pos={st['time_positive']:6.2f} "
              f"neg={st['time_negative']:6.2f}  joins={st['joins']:4d}  "
              f"peakMB={st['peak_bytes'] / 1e6:8.2f}  score={total:.1f}  "
              f"({strat.device})", flush=True)

    # the counting strategy must not change the discovered model
    ref = results[STRATEGIES[0]]
    for name, res in results.items():
        assert res["edges"] == ref["edges"], f"{name} found a different model"
        assert abs(res["score"] - ref["score"]) < SCORE_RTOL * max(
            1.0, abs(ref["score"])), f"{name} scored {res['score']}"
    print(f"\nall {len(STRATEGIES)} strategies discovered the SAME model "
          f"(same edges, same score): only the cost differs.")
    return results


if __name__ == "__main__":
    main()
