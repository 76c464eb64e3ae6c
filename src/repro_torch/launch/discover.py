"""Statistical-relational model discovery over the ranks of a
``torch.distributed`` group (the paper's workload).

HYBRID discovery (lattice -> counting -> BDeu hill-climb, chains of at most
2, at most 2 parents) with the edge tables split over the ranks
(:mod:`repro_torch.core.distributed`); prints the learned models and the
counting stats:

    PYTHONPATH=src python -m repro_torch.launch.discover --db IMDb --scale 0.1
    PYTHONPATH=src python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 -m repro_torch.launch.discover --db UW

Under a launcher of more than one rank, rank 0 discovers through
``executor="sparse_sharded"`` and the other ranks serve its sharded steps
(:func:`~repro_torch.core.distributed.serve_ranks`); alone, the process
is a group of one.  Ranks that share a card use gloo, ranks with a card
each NCCL.  The JAX package's ``--dryrun`` (XLA HLO for a TPU pod) has no
counterpart.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.database import PAPER_DATASETS, paper_benchmark_db
from ..core.device import resolve_device
from ..core.distributed import serve_ranks, stop_ranks
from ..core.search import discover_model
from ..core.strategies import make_strategy
from .mesh import make_local_mesh

TIMEOUT_S = 600.0                  # a collective that waits longer raises


def model_lines(models: Dict) -> List[str]:
    """One line a lattice point: its relationships, score and edge count."""
    return [f"  [{','.join(sorted(point.rels))}] score={model.score:.1f} "
            f"edges={len(model.edges())}" for point, model in models.items()]


def run_local(db_name: str, scale: float, device=None) -> List[str]:
    """Discover on rank 0 with the edge tables split over the group's
    ranks; print and return the per-point lines."""
    device = resolve_device(device)
    db = paper_benchmark_db(db_name, scale=scale)
    mesh = make_local_mesh()
    print(f"database {db_name} (scale {scale}): {db.total_rows} rows; mesh "
          f"{dict(zip(mesh.mesh_dim_names, map(int, mesh.mesh.shape)))}")
    strat = make_strategy("HYBRID", executor="sparse_sharded", device=device)
    models, strat = discover_model(db, strat, max_chain_length=2,
                                   max_parents=2, device=device)
    lines = model_lines(models)
    for line in lines:
        print(line)
    st = strat.stats.as_dict()
    print({k: round(v, 3) if isinstance(v, float) else v
           for k, v in st.items()})
    return lines


def _rank_device(device: Optional[str]) -> torch.device:
    """This rank's device: the host when asked, else the card
    ``LOCAL_RANK`` mod the cards there are."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)                        # raises without a card
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def _init(device: torch.device) -> None:
    """Join the launcher's group (``torch.distributed.run`` sets ``RANK``
    and ``WORLD_SIZE``), or make a group of one."""
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if "WORLD_SIZE" in os.environ:
        world = int(os.environ["WORLD_SIZE"])
        own_card = (device.type == "cuda"
                    and world <= torch.cuda.device_count())
        dist.init_process_group("nccl" if own_card else "gloo",
                                timeout=timeout)
    else:
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--db", choices=PAPER_DATASETS, default="UW")
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default=None,
                    help="where each rank counts (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = _rank_device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    _init(device)
    try:
        if dist.get_rank() == 0:
            run_local(args.db, args.scale, device)
            stop_ranks(device)
        else:
            serve_ranks(make_local_mesh(), device)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
