"""Integer-coded relational database + synthetic generators.

A :class:`RelationalDB` stands in for the paper's MariaDB input: every
entity table is a dict of ``int32[n]`` attribute columns and every
relationship table is an edge list ``(src int32[m], dst int32[m])`` plus
``int32[m]`` edge-attribute columns.  The arrays stay on the host as numpy;
the executors move index and code arrays to the counting device hop by hop.

The synthetic generator plants real statistical dependencies (attribute
values correlated along edges) so that structure search has signal to find,
and lets benchmarks dial ``rows`` up to the paper's Visual Genome scale
(15.8M rows).  Its numpy RNG calls are those of the JAX reference package,
so the same ``(name, seed, scale)`` gives byte-identical arrays in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Tuple

import numpy as np

from .schema import Attribute, EntityType, Relationship, Schema


@dataclass
class EntityTable:
    type: EntityType
    attrs: Dict[str, np.ndarray]      # name -> int32[size]

    @property
    def size(self) -> int:
        return self.type.size


@dataclass
class RelationTable:
    type: Relationship
    src: np.ndarray                   # int32[m] indices into src entity table
    dst: np.ndarray                   # int32[m]
    attrs: Dict[str, np.ndarray]      # name -> int32[m]

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    @property
    def nbytes(self) -> int:
        """Byte footprint of the edge list + attribute columns."""
        return int(self.src.nbytes) + int(self.dst.nbytes) + sum(
            int(c.nbytes) for c in self.attrs.values())


@dataclass
class RelationalDB:
    schema: Schema
    entities: Dict[str, EntityTable]
    relations: Dict[str, RelationTable]
    version: int = 0

    @property
    def total_rows(self) -> int:
        """Total data facts, comparable to the paper's Table 4 row counts."""
        n = sum(t.size for t in self.entities.values())
        n += sum(t.num_edges for t in self.relations.values())
        return n

    def validate(self) -> None:
        self.schema.validate()
        for name, tab in self.entities.items():
            et = tab.type
            for a in et.attrs:
                col = tab.attrs[a.name]
                assert col.shape == (et.size,), (name, a.name)
                assert col.min() >= 0 and col.max() < a.card
        for name, tab in self.relations.items():
            rt = tab.type
            ns, nd = self.entities[rt.src].size, self.entities[rt.dst].size
            if tab.num_edges:       # empty relationship tables are legal
                assert tab.src.min() >= 0 and tab.src.max() < ns
                assert tab.dst.min() >= 0 and tab.dst.max() < nd
            for a in rt.attrs:
                col = tab.attrs[a.name]
                assert col.shape == tab.src.shape
                if col.size:
                    assert col.min() >= 0 and col.max() < a.card


def db_from_arrays(schema_spec: Mapping,
                   entities: Mapping[str, Mapping[str, np.ndarray]],
                   relations: Mapping[str, Tuple]) -> RelationalDB:
    """Build a :class:`RelationalDB` from plain numpy arrays.

    Args:
        schema_spec: ``{"entities": [(name, size, [(attr, card), ...]),
            ...], "relationships": [(name, src, dst, [(attr, card), ...]),
            ...]}`` — names, sizes and attribute cardinalities in schema
            order.
        entities: ``{etype: {attr: int array[size]}}``.
        relations: ``{rel: (src, dst, {attr: int array[m]})}``.

    Returns:
        A validated database whose arrays are ``int32`` copies of the
        inputs.

    Usage::

        db = db_from_arrays(
            {"entities": [("u", 3, [("g", 2)])],
             "relationships": [("F", "u", "u", [])]},
            {"u": {"g": np.array([0, 1, 1])}},
            {"F": (np.array([0, 1]), np.array([1, 2]), {})})
    """
    ents = tuple(EntityType(name, int(size),
                            tuple(Attribute(a, int(c)) for a, c in attrs))
                 for name, size, attrs in schema_spec["entities"])
    rels = tuple(Relationship(name, src, dst,
                              tuple(Attribute(a, int(c)) for a, c in attrs))
                 for name, src, dst, attrs in schema_spec["relationships"])
    schema = Schema(ents, rels)
    as32 = lambda a: np.array(a, dtype=np.int32)
    etabs = {et.name: EntityTable(et, {a.name: as32(entities[et.name][a.name])
                                       for a in et.attrs})
             for et in ents}
    rtabs = {}
    for rt in rels:
        src, dst, cols = relations[rt.name]
        rtabs[rt.name] = RelationTable(rt, as32(src), as32(dst),
                                       {a.name: as32(cols[a.name])
                                        for a in rt.attrs})
    db = RelationalDB(schema, etabs, rtabs)
    db.validate()
    return db


def synth_db(schema: Schema,
             edges_per_rel: Mapping[str, int],
             seed: int = 0,
             correlation: float = 0.7) -> RelationalDB:
    """Generate a database with planted dependencies.

    ``correlation`` controls how strongly edge attributes depend on the
    endpoint entity attributes (0 = independent, 1 = deterministic), giving
    structure search a recoverable ground truth.
    """
    rng = np.random.default_rng(seed)
    entities: Dict[str, EntityTable] = {}
    for et in schema.entities:
        cols = {a.name: rng.integers(0, a.card, size=et.size, dtype=np.int32)
                for a in et.attrs}
        entities[et.name] = EntityTable(et, cols)

    relations: Dict[str, RelationTable] = {}
    for rt in schema.relationships:
        m = int(edges_per_rel[rt.name])
        ns = schema.entity(rt.src).size
        nd = schema.entity(rt.dst).size
        # unique (src, dst) pairs: relationship tables are keyed by the pair,
        # so the indicator R(x, y) is well defined (see mobius.py).
        over = rng.integers(0, ns * nd, size=min(int(m * 1.3) + 8, ns * nd),
                            dtype=np.int64)
        over = np.unique(over)
        rng.shuffle(over)
        over = over[:m]
        src = (over // nd).astype(np.int32)
        dst = (over % nd).astype(np.int32)
        if rt.is_self:
            # avoid self loops for realism
            keep = src != dst
            src, dst = src[keep], dst[keep]
        m = src.shape[0]
        cols: Dict[str, np.ndarray] = {}
        # plant: edge attr correlates with (src attr0 + dst attr0) mod card
        s_anchor = (entities[rt.src].attrs[schema.entity(rt.src).attrs[0].name][src]
                    if schema.entity(rt.src).attrs else np.zeros(m, np.int32))
        d_anchor = (entities[rt.dst].attrs[schema.entity(rt.dst).attrs[0].name][dst]
                    if schema.entity(rt.dst).attrs else np.zeros(m, np.int32))
        for a in rt.attrs:
            noise = rng.integers(0, a.card, size=m, dtype=np.int32)
            signal = ((s_anchor + d_anchor) % a.card).astype(np.int32)
            pick = rng.random(m) < correlation
            cols[a.name] = np.where(pick, signal, noise).astype(np.int32)
        relations[rt.name] = RelationTable(rt, src, dst, cols)

    db = RelationalDB(schema, entities, relations)
    db.validate()
    return db


# ---------------------------------------------------------------------------
# Paper-benchmark synthetic stand-ins (Table 4 of the paper).
# Row counts mirror the published datasets; schema complexity (number of
# relationships / attribute counts) mirrors the published relationship counts.
# ---------------------------------------------------------------------------

def _uni_schema(n_students: int, n_courses: int, n_profs: int,
                a_card: int = 3) -> Schema:
    att = lambda n: Attribute(n, a_card)
    return Schema(
        entities=(
            EntityType("student", n_students, (att("intelligence"), att("ranking"))),
            EntityType("course", n_courses, (att("difficulty"), att("rating"))),
            EntityType("prof", n_profs, (att("popularity"), att("teachingability"))),
        ),
        relationships=(
            Relationship("Registered", "student", "course", (att("grade"), att("satisfaction"))),
            Relationship("RA", "prof", "student", (att("salary"), att("capability"))),
        ),
    )


def _movie_schema(n_users: int, n_movies: int, a_card: int = 3) -> Schema:
    att = lambda n: Attribute(n, a_card)
    return Schema(
        entities=(
            EntityType("user", n_users, (att("age"), att("gender"), att("occupation"))),
            EntityType("movie", n_movies, (att("year"), att("genre"))),
        ),
        relationships=(
            Relationship("Rated", "user", "movie", (att("rating"),)),
        ),
    )


def _generic_schema(name: str, n_rel: int, n_ent: int, ent_size: int,
                    n_attr: int = 2, a_card: int = 3) -> Schema:
    """A connected schema with ``n_rel`` relationships over ``n_ent`` types."""
    att = lambda n: Attribute(n, a_card)
    ents = tuple(
        EntityType(f"{name}_e{i}", ent_size,
                   tuple(att(f"a{i}_{j}") for j in range(n_attr)))
        for i in range(n_ent)
    )
    rels = []
    for r in range(n_rel):
        s = r % n_ent
        d = (r + 1) % n_ent
        if s == d:
            d = (d + 1) % n_ent
        rels.append(Relationship(f"{name}_R{r}", ents[s].name, ents[d].name,
                                 (att(f"r{r}_a0"),)))
    return Schema(ents, tuple(rels))


def paper_benchmark_db(name: str, seed: int = 0, scale: float = 1.0) -> RelationalDB:
    """Synthetic stand-ins for the paper's 8 databases, matched on total rows
    and relationship count (Table 4).  ``scale`` shrinks them for tests."""
    s = lambda n: max(8, int(n * scale))
    if name == "UW":              # 712 rows, 2 rels
        sch = _uni_schema(s(180), s(140), s(40))
        edges = {"Registered": s(250), "RA": s(100)}
    elif name == "Mondial":       # 870 rows, 2 rels
        sch = _generic_schema("mon", 2, 3, s(120), n_attr=4, a_card=4)
        edges = {"mon_R0": s(300), "mon_R1": s(200)}
    elif name == "Hepatitis":     # 12,927 rows, 3 rels
        sch = _generic_schema("hep", 3, 3, s(1500), n_attr=3, a_card=4)
        edges = {"hep_R0": s(3000), "hep_R1": s(3000), "hep_R2": s(2400)}
    elif name == "Mutagenesis":   # 14,540 rows, 2 rels
        sch = _generic_schema("mut", 2, 2, s(2500), n_attr=2, a_card=3)
        edges = {"mut_R0": s(6000), "mut_R1": s(3500)}
    elif name == "MovieLens":     # 74,402 rows, 1 rel
        sch = _movie_schema(s(941), s(1682))
        edges = {"Rated": s(71779)}
    elif name == "Financial":     # 225,887 rows, 3 rels
        sch = _generic_schema("fin", 3, 3, s(15000), n_attr=3, a_card=4)
        edges = {"fin_R0": s(80000), "fin_R1": s(60000), "fin_R2": s(40000)}
    elif name == "IMDb":          # 1,063,559 rows, 3 rels
        sch = _generic_schema("imdb", 3, 3, s(100000), n_attr=3, a_card=3)
        edges = {"imdb_R0": s(400000), "imdb_R1": s(250000), "imdb_R2": s(113000)}
    elif name == "VisualGenome":  # 15,833,273 rows, 8 rels
        sch = _generic_schema("vg", 8, 4, s(200000), n_attr=1, a_card=3)
        edges = {f"vg_R{i}": s(1900000) for i in range(8)}
    else:
        raise KeyError(name)
    return synth_db(sch, edges, seed=seed)


PAPER_DATASETS = ("UW", "Mondial", "Hepatitis", "Mutagenesis", "MovieLens",
                  "Financial", "IMDb", "VisualGenome")
