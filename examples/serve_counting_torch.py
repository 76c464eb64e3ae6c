"""Serve counting queries to concurrent clients through the PyTorch port:
the counterpart of ``examples/serve_counting.py``.

Several client threads flood one :class:`~repro_torch.serve.service
.CountingService` with positive-count queries over a schema whose
relationships share one shape — the service coalesces duplicate
in-flight queries, short-circuits cache residents, buckets the rest by
plan signature, and executes each bucket as one stacked evaluation
(K1/K2 launches per hop step on the card) against the shared
byte-budgeted ct-cache.  For comparison the same query stream is first
answered per query through the bare executor.  The service synchronises
the card at the end of each batch, so its latencies are the card's.

Run:  python examples/serve_counting_torch.py [n_clients] [n_rels]
      python examples/serve_counting_torch.py --device cpu   (on the host)
      default: 4 clients x 60 queries each, 8 relationships, the CUDA card.
"""

import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import numpy as np

from repro_torch.core import (Attribute, CostStats, CountingEngine,
                              EntityType, Relationship, Schema,
                              build_lattice, synth_db)
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.serve import CountingService


def flood_schema(n_rels: int) -> Schema:
    ents = (EntityType("item", 500, (Attribute("a0", 3), Attribute("a1", 3))),
            EntityType("tag", 300, (Attribute("b0", 3),)))
    rels = tuple(Relationship(f"Rel{i}", "item", "tag",
                              (Attribute(f"e{i}", 3),))
                 for i in range(n_rels))
    return Schema(ents, rels)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_clients", nargs="?", type=int, default=4)
    parser.add_argument("n_rels", nargs="?", type=int, default=8)
    parser.add_argument("--device", default=None,
                        help='counting device (default: the CUDA card; '
                             '"cpu" for the host)')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    n_clients, n_rels, per_client = args.n_clients, args.n_rels, 60

    schema = flood_schema(n_rels)
    db = synth_db(schema, {f"Rel{i}": 3000 for i in range(n_rels)}, seed=0)
    points = build_lattice(schema, 1)
    print(f"database: {db.total_rows} rows, {n_rels} same-shape "
          f"relationships -> {len(points)} distinct count queries; "
          f"counting on {device}")

    # ---- baseline: per-query dispatch, no batching ----------------------
    eng = CountingEngine(db, "sparse", CostStats(), device=device)
    rng = np.random.default_rng(0)
    stream = [points[i] for i in
              rng.integers(len(points), size=n_clients * per_client)]
    for p in points:                      # first use builds the kernels
        eng.executor.positive(db, eng.plan(p, None))
    synchronize(device)
    t0 = time.perf_counter()
    for p in stream:
        eng.executor.positive(db, eng.plan(p, None))
    synchronize(device)
    t_pq = time.perf_counter() - t0
    print(f"per-query : {len(stream)} queries in {t_pq * 1e3:7.0f} ms "
          f"({len(stream) / t_pq:7.0f} q/s)")

    # ---- service: concurrent clients, micro-batched ---------------------
    eng = CountingEngine(db, "sparse", CostStats(),
                         cache_budget_bytes=64 << 20, device=device)
    svc = CountingService(eng, max_batch_size=n_rels)
    # one warm pass, then drop the warmed tables so clients do real work
    svc.count_many([(p, None) for p in points])
    for key in eng.cache.keys_snapshot():
        eng.cache.discard(key)
    svc.metrics = type(svc.metrics)()

    def client(cid: int):
        crng = np.random.default_rng(cid)
        for _ in range(per_client // 6):
            # submit a burst of tickets, then resolve them — bursts from
            # concurrent clients land in one signature bucket
            tickets = [svc.submit(points[int(crng.integers(len(points)))])
                       for _ in range(6)]
            for t in tickets:
                t.result(timeout=300.0)

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600.0)
    if any(t.is_alive() for t in threads):
        raise SystemExit("a client thread did not finish")
    t_svc = time.perf_counter() - t0
    svc.shutdown(timeout=60.0)
    n = n_clients * per_client
    print(f"service   : {n} queries in {t_svc * 1e3:7.0f} ms "
          f"({n / t_svc:7.0f} q/s) from {n_clients} client threads")

    snap = svc.stats()
    print("\nservice health:")
    print(f"  requests / cache hits / coalesced : "
          f"{snap['requests']} / {snap['cache_hits']} / {snap['coalesced']}")
    print(f"  batches x mean size               : {snap['batches']} x "
          f"{snap['batched_queries'] / max(snap['batches'], 1):.1f}")
    print(f"  bucket exec throughput            : {snap['qps']:.0f} q/s")
    print(f"  queue wait p50 / p99              : "
          f"{snap['queue_wait_hist']['p50_s']} / "
          f"{snap['queue_wait_hist']['p99_s']} s")
    print(f"  end to end p50 / p99              : "
          f"{snap['e2e_hist']['p50_s']} / {snap['e2e_hist']['p99_s']} s")
    print(f"  ct-cache                          : {snap['cache']}")
    print("OK — counting service flood works end-to-end.")


if __name__ == "__main__":
    main()
