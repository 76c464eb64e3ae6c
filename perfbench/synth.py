"""The benchmark's databases, drawn from a seed in plain NumPy.

A frozen copy of the arithmetic of ``repro_torch.core.database.synth_db``
and of its paper stand-ins (``paper_benchmark_db``): entity attributes
uniform over their cardinality; each relationship's edges a uniform draw
of distinct ``(src, dst)`` pairs; each edge attribute equal to
``(src's first attribute + dst's first attribute) mod card`` with
probability ``correlation`` and uniform otherwise.  The schema and sizes
come from a configuration file (``configs/<name>.json``), so the
benchmark's inputs stay fixed when the program's own generator changes.
The same arrays go to the program (through its public constructor) and to
the plain reference.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np

Arrays = Dict[str, object]


def rng_for(seed: int) -> np.random.Generator:
    """NumPy's generator for a benchmark seed: any whole number, negative
    ones included, maps to its own stream."""
    seed = int(seed)
    return np.random.default_rng(seed if seed >= 0 else [-seed, 1])


def stream(seed: int, tag: int) -> np.random.Generator:
    """A generator of its own for each ``tag`` (a whole number >= 0),
    apart from the data's and from every other tag's."""
    seed = int(seed)
    return np.random.default_rng([abs(seed), int(seed < 0), 2 + int(tag)])


def sized(n: int, scale: float) -> int:
    """A size of the configuration at ``scale`` (1.0 in every benchmark
    run; tests shrink it), never below 8, as the paper stand-ins do."""
    return max(8, int(n * scale))


def generate(cfg: Mapping, seed: int, scale: float = 1.0) -> Arrays:
    """The database of configuration ``cfg`` for ``seed``: the
    configuration's own database (drawn from its ``data_seed``) with its
    entities renumbered and its edges reordered by ``seed``.  Every count
    is the same under a renumbering, so every seed does the same work
    (the structure search's path depends on the counts) in another order.

    Returns ``{"entities": {etype: {attr: int32[n]}}, "sizes": {etype: n},
    "relations": {rel: (src int32[m], dst int32[m], {attr: int32[m]})}}``.
    """
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


def draw(cfg: Mapping, seed: int, scale: float = 1.0) -> Arrays:
    """The arithmetic of ``synth_db`` over the configuration's schema, drawn
    from ``seed`` (the layout of :func:`generate`)."""
    rng = rng_for(seed)
    corr = float(cfg["correlation"])
    sizes = {e["name"]: sized(e["size"], scale) for e in cfg["entities"]}
    first_attr = {e["name"]: (e["attrs"][0][0] if e["attrs"] else None)
                  for e in cfg["entities"]}
    entities: Dict[str, Dict[str, np.ndarray]] = {}
    for e in cfg["entities"]:
        entities[e["name"]] = {
            name: rng.integers(0, card, size=sizes[e["name"]],
                               dtype=np.int32)
            for name, card in e["attrs"]}
    relations: Dict[str, Tuple] = {}
    for r in cfg["relationships"]:
        m = sized(r["edges"], scale)
        ns, nd = sizes[r["src"]], sizes[r["dst"]]
        over = rng.integers(0, ns * nd, size=min(int(m * 1.3) + 8, ns * nd),
                            dtype=np.int64)
        over.sort()             # np.unique's result, without its hashing
        over = over[np.concatenate(([True], over[1:] != over[:-1]))]
        rng.shuffle(over)
        over = over[:m]
        src = (over // nd).astype(np.int32)
        dst = (over % nd).astype(np.int32)
        if r["src"] == r["dst"]:
            keep = src != dst
            src, dst = src[keep], dst[keep]
        m = src.shape[0]
        a_src, a_dst = first_attr[r["src"]], first_attr[r["dst"]]
        s_anchor = (entities[r["src"]][a_src][src] if a_src is not None
                    else np.zeros(m, np.int32))
        d_anchor = (entities[r["dst"]][a_dst][dst] if a_dst is not None
                    else np.zeros(m, np.int32))
        cols = {}
        for name, card in r["attrs"]:
            noise = rng.integers(0, card, size=m, dtype=np.int32)
            signal = ((s_anchor + d_anchor) % card).astype(np.int32)
            pick = rng.random(m) < corr
            cols[name] = np.where(pick, signal, noise).astype(np.int32)
        relations[r["name"]] = (src, dst, cols)
    return {"entities": entities, "sizes": sizes, "relations": relations}


def schema_spec(cfg: Mapping, arrays: Arrays) -> dict:
    """The schema in the form of the program's ``db_from_arrays``."""
    return {
        "entities": [(e["name"], arrays["sizes"][e["name"]],
                      [tuple(a) for a in e["attrs"]])
                     for e in cfg["entities"]],
        "relationships": [(r["name"], r["src"], r["dst"],
                           [tuple(a) for a in r["attrs"]])
                          for r in cfg["relationships"]],
    }
