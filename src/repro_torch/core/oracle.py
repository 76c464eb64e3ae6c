"""Brute-force counting oracle (pure numpy, exponential — tiny DBs only).

Enumerates every grounding (one entity per lattice-point variable) and tallies
the exact contingency table, including negative relationships and N/A edge
attributes.  This is the semantic ground truth that ``positive_ct`` and
``complete_ct`` are tested against.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .database import RelationalDB
from .variables import CtVar, LatticePoint


def oracle_ct(db: RelationalDB, point: LatticePoint,
              keep: Sequence[CtVar],
              require_positive: bool = False) -> np.ndarray:
    """Exact dense ct-table over ``keep`` by grounding enumeration.

    ``require_positive=True`` restricts to groundings where every relation of
    the point holds (the positive table, no indicator axes)."""
    keep = tuple(keep)
    vars_ = point.vars
    sizes = [db.entities[v.etype].size for v in vars_]
    # edge lookup: rel -> {(src, dst): {attr: value}}
    edge_maps: Dict[str, Dict[Tuple[int, int], Dict[str, int]]] = {}
    for a in point.atoms:
        rt = db.relations[a.rel]
        m: Dict[Tuple[int, int], Dict[str, int]] = {}
        for i in range(rt.num_edges):
            m[(int(rt.src[i]), int(rt.dst[i]))] = {
                name: int(col[i]) for name, col in rt.attrs.items()}
        edge_maps[a.rel] = m

    shape = tuple(v.card for v in keep)
    out = np.zeros(shape, dtype=np.int64)
    vidx = {v: i for i, v in enumerate(vars_)}

    for tup in itertools.product(*[range(s) for s in sizes]):
        truth: Dict[str, bool] = {}
        eattrs: Dict[str, Optional[Dict[str, int]]] = {}
        for a in point.atoms:
            key = (tup[vidx[a.src]], tup[vidx[a.dst]])
            hit = edge_maps[a.rel].get(key)
            truth[a.rel] = hit is not None
            eattrs[a.rel] = hit
        if require_positive and not all(truth.values()):
            continue
        idx = []
        for cv in keep:
            if cv.kind == "attr":
                var, aname = cv.owner
                ent = db.entities[var.etype]
                idx.append(int(ent.attrs[aname][tup[vidx[var]]]))
            elif cv.kind == "edge":
                rel, aname = cv.owner
                hit = eattrs[rel]
                idx.append(int(hit[aname]) if hit is not None else cv.card - 1)
            else:  # rind
                idx.append(1 if truth[cv.owner[0]] else 0)
        out[tuple(idx)] += 1
    return out
