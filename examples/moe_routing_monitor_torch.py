"""The paper's technique inside the LM, on the PyTorch port: monitor MoE
routing with hybrid count-caching.

A probe batch is traced through a qwen3-MoE model; each layer's top-k
assignments become a relational database (tokens x experts with a
``Routed`` relationship), and HYBRID counting answers contingency
questions, including *negative* relationships ("expert e did NOT see
bucket b tokens"), which the Möbius join answers with no extra pass over
the trace.  The port of ``examples/moe_routing_monitor.py``.

Run:  PYTHONPATH=src python examples/moe_routing_monitor_torch.py --device cpu
(the reduced config on the host; with no ``--device``, on the CUDA card).
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.device import resolve_device  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.train.monitor import (routing_ct, routing_db,  # noqa: E402
                                       routing_trace)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_reduced("qwen3-moe-30b-a3b")
    model = build_model(cfg, device).init(
        torch.Generator(device=device).manual_seed(0))

    b, s = 4, 64
    tokens = torch.randint(0, cfg.vocab, (b, s), device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))
    trace = routing_trace(model, {"tokens": tokens})
    print(f"model: {cfg.name} ({cfg.n_experts} experts, top-{cfg.top_k}); "
          f"trace shape {tuple(trace.shape)}  [L, B, S, K]")

    buckets = tokens % 4                        # token-id buckets
    out = {}
    for layer in (0, cfg.n_layers - 1):
        db = routing_db(trace[layer], buckets, cfg.n_experts)
        tab, stats = routing_ct(db, device=device)
        out[layer] = (tab, stats)
        print(f"\nlayer {layer}: Routed(token, expert) — "
              f"{db.relations['Routed'].num_edges} edges")
        print(f"  complete ct-table axes: "
              f"{[str(v) for v in tab.vars]}  shape "
              f"{tuple(tab.counts.shape)}")
        print(f"  routed pairs {stats['routed_pairs']:.0f} / "
              f"possible {stats['pairs_total']:.0f} "
              f"(fraction {stats['routed_fraction']:.4f}) — "
              f"negative counts from the Möbius join, "
              f"{stats['joins']} JOIN sweep(s)")
    print("\nOK — hybrid count-caching is serving the training loop.")
    return trace, out


if __name__ == "__main__":
    main()
