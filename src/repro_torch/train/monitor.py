"""Hybrid count-cache routing monitor; the JAX package's
``repro.train.monitor``.

The paper's counting applied inside the LM: one layer's MoE routing is a
relational database.  Tokens are entities (a ``bucket`` and a position
bucket ``posq``), experts are entities (a ``group``), and
``Routed(token, expert)`` is a relationship.  HYBRID counting answers its
complete ct-table, including the *negative* rows ("tokens expert e did not
see") through the Möbius join, with no second pass over the assignments.

    trace = routing_trace(model, batch)                  # [L, B, S, K] ids
    db    = routing_db(trace[layer], buckets, cfg.n_experts)
    tab, stats = routing_ct(db)                          # on the card
    tab, stats = routing_ct(db, device="cpu")            # on the host

:func:`routing_trace` returns the routing that each layer's
:func:`repro_torch.models.moe.moe_apply` used, read from the block as it
runs: the router applied to ``rms_norm(x + attention, norm2)``.  The
reference computes the router on ``rms_norm`` of the block's *input*
instead (before the attention), although its docstring says "the MoE
input" (ROADMAP C, facts about the reference).  :func:`routing_db` and
:func:`routing_ct` are the reference's on the same ``eidx``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..core.ct import CtTable
from ..core.database import EntityTable, RelationTable, RelationalDB
from ..core.schema import Attribute, EntityType, Relationship, Schema
from ..core.strategies import Hybrid
from ..core.variables import build_lattice
from ..models.model import LM, _positions_for
from ..models.transformer import block_attend


@torch.no_grad()
def routing_trace(model: LM, batch) -> torch.Tensor:
    """Per-layer top-k expert assignments for a probe batch: int32
    ``[L, B, S, K]`` on the model's device, each layer's the routing its
    MoE used.  Runs the stack unrolled (the monitoring path, not the train
    step), over the model's mesh if it is sharded."""
    cfg = model.cfg
    if not cfg.is_moe:
        raise ValueError("routing_trace requires an MoE config")
    x = model._embed_in(batch)
    positions = _positions_for(cfg, batch, x)
    traces = []
    for blk in model.blocks:
        out = block_attend(blk, x, cfg, positions, True, model.mesh)
        x = out.x
        traces.append(out.eidx.to(torch.int32))
        del out
    return torch.stack(traces)


def routing_db(eidx, buckets, n_experts: int, n_buckets: int = 4,
               n_pos_buckets: int = 4) -> RelationalDB:
    """Relational view of one layer's routing.

    ``eidx`` [B, S, K] expert ids; ``buckets`` [B, S] in ``[0,
    n_buckets)`` (tensors or arrays).  Entities: ``token(bucket, posq)``,
    ``expert(group)`` (4 groups of consecutive experts).  Relationship:
    ``Routed(token, expert)``, a set of (token, expert) pairs."""
    eidx = np.asarray(_host(eidx), np.int32)
    b, s, k = eidx.shape
    n_tok = b * s
    tok_bucket = np.asarray(_host(buckets), np.int32).reshape(n_tok)
    posq = np.broadcast_to(
        (np.arange(s, dtype=np.int32) * n_pos_buckets) // s, (b, s)
    ).reshape(n_tok).copy()
    e_group = (np.arange(n_experts, dtype=np.int32) * 4) // n_experts

    schema = Schema(
        entities=(
            EntityType("token", n_tok, (Attribute("bucket", n_buckets),
                                        Attribute("posq", n_pos_buckets))),
            EntityType("expert", n_experts, (Attribute("group", 4),)),
        ),
        relationships=(
            Relationship("Routed", "token", "expert", ()),
        ),
    )
    src = np.repeat(np.arange(n_tok, dtype=np.int32), k)
    dst = eidx.reshape(n_tok * k)
    pairs = np.unique(src.astype(np.int64) * n_experts + dst)
    src = (pairs // n_experts).astype(np.int32)
    dst = (pairs % n_experts).astype(np.int32)

    db = RelationalDB(
        schema,
        {"token": EntityTable(schema.entity("token"),
                              {"bucket": tok_bucket, "posq": posq}),
         "expert": EntityTable(schema.entity("expert"),
                               {"group": e_group})},
        {"Routed": RelationTable(schema.relationship("Routed"), src, dst,
                                 {})},
    )
    db.validate()
    return db


def routing_ct(db: RelationalDB, device=None
               ) -> Tuple[CtTable, Dict[str, float]]:
    """Complete ct-table over ``(Routed?, bucket, group)`` by HYBRID
    counting on ``device`` (``None``: the CUDA card), and summary stats.
    The ``Routed = F`` rows are the Möbius join's (K3).  It counts over
    the sparse executor, whose leaf hop and histograms are K1 and root
    combine K2; the reference's ``Hybrid()`` counts over the dense one,
    and the counts, exact in either, are the same bits."""
    lattice = build_lattice(db.schema, 1)
    strat = Hybrid(device=device, executor="sparse")
    strat.prepare(db, lattice)
    point = lattice[0]
    keep = point.all_ct_vars(db.schema, include_rind=True)
    keep = tuple(v for v in keep
                 if v.kind == "rind" or v.owner[-1] in ("bucket", "group"))
    tab = strat.family_ct(point, keep)

    rind_ax = next(i for i, v in enumerate(tab.vars) if v.kind == "rind")
    counts = tab.counts.double()
    pos = counts.select(rind_ax, 1)
    neg = counts.select(rind_ax, 0)
    total = float(pos.sum() + neg.sum())
    stats = {
        "pairs_total": total,
        "routed_pairs": float(pos.sum()),
        "unrouted_pairs": float(neg.sum()),
        "routed_fraction": float(pos.sum()) / max(total, 1.0),
        "joins": strat.stats.joins,
        "peak_cache_bytes": strat.stats.peak_bytes,
    }
    return tab, stats


def _host(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else a
