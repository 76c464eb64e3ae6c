"""TPC-H's database as a discovery deployment, drawn from a seed in plain
NumPy by the specification's rules (TPC-H Standard Specification,
Clause 4.2: rows per scale factor and dbgen's column rules).

The modelled columns: ``n_regionkey`` on nation (region folded into
nation as an attribute), ``c_mktsegment``, ``o_orderstatus`` and
``o_orderpriority``, ``p_mfgr``; supplier has none.  The relationships:
``cust_nation`` (customer -> nation), ``placed`` (customer -> orders),
``lineitem`` (orders -> part, with ``l_returnflag``, ``l_linestatus`` and
``l_shipmode``), ``partsupp`` (part -> supplier) and ``supp_nation``
(supplier -> nation).  Relationships are sets of pairs: where an order
repeats a part, only its first line is kept.

The rules, with SF the scale factor (``cfg["scale_factor"]`` times the
``scale`` the tests shrink it by; nation stays at 25):

* customer SF x 150,000, orders SF x 1,500,000, part SF x 200,000,
  supplier SF x 10,000; 1-7 line items an order, uniform;
* ``c_nationkey``, ``s_nationkey`` uniform over 0-24; ``n_regionkey`` by
  the specification's nation table (:data:`REGION_OF_NATION`);
* ``c_mktsegment``, ``o_orderpriority``, ``p_mfgr`` uniform over 5,
  ``l_shipmode`` over 7;
* ``o_custkey`` uniform over the customers whose key is not divisible
  by 3, ``l_partkey`` uniform over the parts;
* part ``p``'s 4 suppliers: ``(p + i (S/4 + (p - 1)/S)) mod S + 1`` for
  ``i`` in 0..3 (1-based keys, S suppliers, integer division);
* ``o_orderdate`` uniform over [1992-01-01, 1998-12-31 - 151 days]; a
  line ships 1-121 days after it and is received 1-30 days after that;
* ``l_linestatus`` O where the ship date is after 1995-06-17, else F;
  ``l_returnflag`` R or A (uniform) where the receipt date is on or
  before 1995-06-17, else N;
* ``o_orderstatus`` F where all of the order's lines are F, O where all
  are O, else P, over every line before any is dropped.

:func:`generate` returns :func:`perfbench.synth.generate`'s layout, and
renumbers the one database as it does, so every seed counts the same
tables.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

from .synth import Arrays, rng_for, stream

#: ``n_regionkey`` of nations 0-24 (the specification's nation table).
REGION_OF_NATION = (0, 1, 1, 1, 4, 0, 3, 3, 2, 2, 4, 4, 2, 4, 0, 0, 0, 1, 2,
                    3, 4, 2, 3, 3, 1)
#: Rows at SF1 (nation is fixed at 25 at every scale).
ROWS_SF1 = {"customer": 150_000, "orders": 1_500_000, "part": 200_000,
            "supplier": 10_000}
#: Day numbers (since 1970-01-01) of the specification's dates.
START = int(np.datetime64("1992-01-01", "D").astype(np.int64))
END = int(np.datetime64("1998-12-31", "D").astype(np.int64))
CURRENT = int(np.datetime64("1995-06-17", "D").astype(np.int64))
#: Codes of the status columns.
F, O, P = 0, 1, 2                       # o_orderstatus; l_linestatus F, O
R, A, N = 0, 1, 2                       # l_returnflag


def sizes(sf: float) -> Dict[str, int]:
    """Rows of each entity type at scale factor ``sf``."""
    out = {et: max(1, int(round(n * sf))) for et, n in ROWS_SF1.items()}
    out["nation"] = len(REGION_OF_NATION)
    return out


def supplier_keys(n_part: int, n_supp: int) -> np.ndarray:
    """The specification's 4 supplier indices (0-based) of each part,
    ``(n_part, 4)``."""
    pk = np.arange(1, n_part + 1, dtype=np.int64)[:, None]
    i = np.arange(4, dtype=np.int64)[None, :]
    step = n_supp // 4 + (pk - 1) // n_supp
    return (pk + i * step) % n_supp


def draw(cfg: Mapping, seed: int, scale: float = 1.0) -> Arrays:
    """The database by the rules above, drawn from ``seed``."""
    rng = rng_for(seed)
    n = sizes(float(cfg["scale_factor"]) * scale)
    nc, no, np_, ns = (n["customer"], n["orders"], n["part"],
                       n["supplier"])
    i32 = np.int32

    entities = {
        "nation": {"n_regionkey": np.asarray(REGION_OF_NATION, i32)},
        "customer": {"c_mktsegment": rng.integers(0, 5, nc, dtype=i32)},
        "orders": {},
        "part": {"p_mfgr": rng.integers(0, 5, np_, dtype=i32)},
        "supplier": {},
    }
    c_nation = rng.integers(0, 25, nc, dtype=i32)
    s_nation = rng.integers(0, 25, ns, dtype=i32)

    allowed = np.flatnonzero(np.arange(1, nc + 1) % 3 != 0).astype(i32)
    o_cust = allowed[rng.integers(0, allowed.size, no)]
    o_priority = rng.integers(0, 5, no, dtype=i32)
    o_date = rng.integers(START, END - 151 + 1, no)

    per_order = rng.integers(1, 8, no)
    l_order = np.repeat(np.arange(no, dtype=i32), per_order)
    m = l_order.size
    l_part = rng.integers(0, np_, m, dtype=i32)
    ship = o_date[l_order] + rng.integers(1, 122, m)
    receipt = ship + rng.integers(1, 31, m)
    l_shipmode = rng.integers(0, 7, m, dtype=i32)
    l_status = np.where(ship > CURRENT, O, F).astype(i32)
    l_return = np.where(receipt <= CURRENT,
                        rng.integers(R, A + 1, m, dtype=i32), N).astype(i32)

    lines_f = np.bincount(l_order, weights=(l_status == F), minlength=no)
    o_status = np.full(no, P, i32)
    o_status[lines_f == per_order] = F
    o_status[lines_f == 0] = O
    entities["orders"] = {"o_orderstatus": o_status,
                          "o_orderpriority": o_priority}

    # a relationship holds a pair once: an order's repeated part keeps
    # its first line
    key = l_order.astype(np.int64) * np_ + l_part
    first = np.sort(np.unique(key, return_index=True)[1])

    ps = supplier_keys(np_, ns)
    ps_part = np.repeat(np.arange(np_, dtype=np.int64), 4)
    ps_key = ps_part * ns + ps.reshape(-1)
    ps_first = np.sort(np.unique(ps_key, return_index=True)[1])

    relations: Dict[str, Tuple] = {
        "cust_nation": (np.arange(nc, dtype=i32), c_nation, {}),
        "placed": (o_cust.astype(i32), np.arange(no, dtype=i32), {}),
        "lineitem": (l_order[first], l_part[first],
                     {"l_returnflag": l_return[first],
                      "l_linestatus": l_status[first],
                      "l_shipmode": l_shipmode[first]}),
        "partsupp": (ps_part[ps_first].astype(i32),
                     ps.reshape(-1)[ps_first].astype(i32), {}),
        "supp_nation": (np.arange(ns, dtype=i32), s_nation, {}),
    }
    return {"entities": entities, "sizes": n, "relations": relations}


def generate(cfg: Mapping, seed: int, scale: float = 1.0) -> Arrays:
    """The configuration's database (drawn from its ``data_seed``) with
    its entities renumbered and its edges reordered by ``seed``, as
    :func:`perfbench.synth.generate` renumbers its own: every seed counts
    the same tables in another order."""
    base = draw(cfg, int(cfg["data_seed"]), scale)
    rng = stream(seed, 0)
    perm = {et: rng.permutation(n).astype(np.int32)
            for et, n in base["sizes"].items()}
    entities = {}
    for et, cols in base["entities"].items():
        entities[et] = {}
        for name, col in cols.items():
            out = np.empty_like(col)
            out[perm[et]] = col
            entities[et][name] = out
    relations = {}
    for r in cfg["relationships"]:
        src, dst, cols = base["relations"][r["name"]]
        order = rng.permutation(src.shape[0])
        relations[r["name"]] = (perm[r["src"]][src][order],
                                perm[r["dst"]][dst][order],
                                {a: c[order] for a, c in cols.items()})
    return {"entities": entities, "sizes": base["sizes"],
            "relations": relations}
