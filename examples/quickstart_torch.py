"""Quickstart for the PyTorch/CUDA port: the paper's technique on the card.

The same run as ``examples/quickstart.py`` — HYBRID counts caching plus
hill-climbing on the UW database — through ``repro_torch``: positive
ct-tables are pre-counted per lattice point, negation is post-counted per
family by the Möbius join, and families are scored by BDeu, each of these
as hand-written CUDA kernels when the counts live on the card.

Run:  python examples/quickstart_torch.py               (on the CUDA card)
      python examples/quickstart_torch.py --device cpu  (on the host)
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import discover_model, make_strategy, paper_benchmark_db


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help='counting device (default: the CUDA card; '
                             '"cpu" for the host)')
    args = parser.parse_args(argv)

    db = paper_benchmark_db("UW", seed=0)          # 712-row university DB
    print(f"database: UW-like, {db.total_rows} rows, "
          f"{len(db.relations)} relationships")

    strategy = make_strategy("HYBRID", device=args.device)
    models, strategy = discover_model(db, strategy, max_chain_length=2,
                                      max_parents=2, device=args.device)
    print(f"counting device: {strategy.device}")

    print("\nlearned first-order Bayesian networks (per lattice point):")
    for point, model in models.items():
        rels = ",".join(sorted(point.rels))
        print(f"  lattice point [{rels}]  score={model.score:.1f}")
        for parent, child in model.edges():
            print(f"    {parent} -> {child}")

    st = strategy.stats.as_dict()
    print("\ncounting stats (the paper's metrics):")
    print(f"  table JOIN sweeps      : {st['joins']}")
    print(f"  edge rows scanned      : {st['rows_scanned']}")
    print(f"  positive-ct time       : {st['time_positive']:.2f}s  (pre-counted)")
    print(f"  negative-ct time       : {st['time_negative']:.2f}s  (Möbius, post-counted)")
    print(f"  peak ct-cache bytes    : {st['peak_bytes']:,}")


if __name__ == "__main__":
    main()
