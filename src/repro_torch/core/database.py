"""Integer-coded relational database + synthetic generators.

A :class:`RelationalDB` stands in for the paper's MariaDB input: every
entity table is a dict of ``int32[n]`` attribute columns and every
relationship table is an edge list ``(src int32[m], dst int32[m])`` plus
``int32[m]`` edge-attribute columns.  The arrays stay on the host as numpy;
the executors move index and code arrays to the counting device hop by hop.

The store is **versioned and mutable**: :meth:`RelationalDB.insert_facts` /
:meth:`RelationalDB.delete_facts` apply a batch of relationship-fact writes,
bump ``db.version`` and return a :class:`FactDelta` — the exact edge set that
changed, which the engine uses for *delta count maintenance* (positive
ct-tables are multilinear in each relationship's edge multiset, so a cached
table is refreshed by counting just the delta edges; see
:meth:`repro_torch.core.engine.CountingEngine.apply_delta`) and for
fine-grained cache invalidation.  Entity-attribute writes go through
:meth:`RelationalDB.update_attrs`, which returns an :class:`AttrDelta`
carrying the exact ``(entity-type, attribute)`` dependency tags
(:meth:`AttrDelta.dep_tags`) the cache keys its attribute dependencies on.
Writes are validated with vectorised membership tests over int64 pair codes
(:func:`_pair_codes`), never a Python set per write.

The synthetic generator plants real statistical dependencies (attribute
values correlated along edges) so that structure search has signal to find,
and lets benchmarks dial ``rows`` up to the paper's Visual Genome scale
(15.8M rows).  Its numpy RNG calls are those of the JAX reference package,
so the same ``(name, seed, scale)`` gives byte-identical arrays in both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

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

    def pair_set(self) -> set:
        """The ``(src, dst)`` pairs as a python set — convenient for
        tests sampling fresh pairs.  The write paths use the vectorised
        :func:`_pair_codes` membership checks instead."""
        return set(zip(self.src.tolist(), self.dst.tolist()))


def _pair_codes(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Pack (src, dst) index pairs into int64 codes — the vectorised
    membership structure the write paths validate against (entity ids
    are int32, so the pair fits a shifted int64 exactly)."""
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


@dataclass(frozen=True)
class FactDelta:
    """One batch of relationship-fact writes, as applied.

    ``op`` is ``"insert"`` or ``"delete"``; ``src``/``dst``/``attrs`` hold
    the exact edges that changed (for deletes, the attribute values the
    removed edges carried — delta count maintenance subtracts those
    cells).  ``old_version``/``new_version`` bracket the store's version
    bump, so the engine can reject out-of-order application.
    """

    rel: str
    op: str                           # "insert" | "delete"
    src: np.ndarray
    dst: np.ndarray
    attrs: Dict[str, np.ndarray]
    old_version: int
    new_version: int

    @property
    def sign(self) -> int:
        """+1 for inserts, -1 for deletes — the coefficient a cached count
        table adds the delta-edge count with."""
        return 1 if self.op == "insert" else -1

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])

    def as_db(self, db: "RelationalDB") -> "RelationalDB":
        """A *delta view* of ``db``: the same schema and entity tables
        (shared, zero copy) with ``rel``'s table replaced by JUST the delta
        edges.  Counting a pattern on this view yields exactly the delta's
        contribution to the pattern's count (positive counts are linear in
        each relationship's edge multiset)."""
        tab = db.relations[self.rel]
        relations = dict(db.relations)
        relations[self.rel] = RelationTable(tab.type, self.src, self.dst,
                                            dict(self.attrs))
        return RelationalDB(db.schema, db.entities, relations,
                            version=db.version)


@dataclass(frozen=True)
class AttrDelta:
    """One batch of entity-attribute writes, as applied.

    ``rows`` are the entity ids whose attribute columns changed;
    ``old``/``new`` hold the per-attribute value columns before and after
    the write (aligned with ``rows``).  ``old_version``/``new_version``
    bracket the store's version bump as for :class:`FactDelta`.
    """

    etype: str
    rows: np.ndarray                  # int32[k] entity ids
    old: Dict[str, np.ndarray]        # attr name -> int32[k] previous values
    new: Dict[str, np.ndarray]        # attr name -> int32[k] written values
    old_version: int
    new_version: int

    @property
    def num_rows(self) -> int:
        return int(self.rows.shape[0])

    @property
    def attrs(self) -> Tuple[str, ...]:
        return tuple(sorted(self.new))

    def dep_tags(self) -> frozenset:
        """Dependency tags this delta touches, in the cache's dependency
        vocabulary: one ``("attr", etype, name)`` tag per written attribute
        plus the ``("attr*", etype)`` wildcard that full-resolution entries
        depend on (see :func:`repro_torch.core.engine.key_deps`)."""
        tags = {("attr", self.etype, name) for name in self.new}
        tags.add(("attr*", self.etype))
        return frozenset(tags)


@dataclass
class RelationalDB:
    schema: Schema
    entities: Dict[str, EntityTable]
    relations: Dict[str, RelationTable]
    version: int = 0                  # bumped by every applied Fact/AttrDelta

    @property
    def total_rows(self) -> int:
        """Total data facts, comparable to the paper's Table 4 row counts."""
        n = sum(t.size for t in self.entities.values())
        n += sum(t.num_edges for t in self.relations.values())
        return n

    # -- mutable store ------------------------------------------------------
    def _check_new_edges(self, rel: str, src: np.ndarray, dst: np.ndarray,
                         attrs: Dict[str, np.ndarray]) -> None:
        tab = self.relations[rel]
        rt = tab.type
        ns, nd = self.entities[rt.src].size, self.entities[rt.dst].size
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be aligned 1-D index arrays")
        if src.size:
            if src.min() < 0 or src.max() >= ns:
                raise ValueError(f"src index out of range for {rt.src!r}")
            if dst.min() < 0 or dst.max() >= nd:
                raise ValueError(f"dst index out of range for {rt.dst!r}")
        want = {a.name for a in rt.attrs}
        if set(attrs) != want:
            raise ValueError(f"attrs for {rel!r} must provide exactly "
                             f"{sorted(want)}, got {sorted(attrs)}")
        for a in rt.attrs:
            col = attrs[a.name]
            if col.shape != src.shape:
                raise ValueError(f"attr {a.name!r} not aligned with edges")
            if col.size and (col.min() < 0 or col.max() >= a.card):
                raise ValueError(f"attr {a.name!r} value out of range")
        codes = _pair_codes(src, dst)
        if np.unique(codes).size != codes.size:
            raise ValueError(f"duplicate (src, dst) pairs within the batch "
                             f"for {rel!r}")
        dup = np.isin(codes, _pair_codes(tab.src, tab.dst))
        if dup.any():
            existing = sorted(zip(src[dup].tolist(), dst[dup].tolist()))
            raise ValueError(f"edges already present in {rel!r}: "
                             f"{existing[:5]}")

    def insert_facts(self, rel: str, src, dst,
                     attrs: Optional[Mapping[str, np.ndarray]] = None
                     ) -> Optional[FactDelta]:
        """Append a batch of edges to relationship ``rel``; bumps
        ``version`` and returns the applied :class:`FactDelta` (``None``
        for an empty batch — no version bump, nothing to reconcile).

        Args:
            rel: relationship name.
            src / dst: aligned ``int`` index arrays into the endpoint
                entity tables.  ``(src, dst)`` pairs must be new — tables
                are keyed by the pair.
            attrs: one aligned value column per edge attribute of ``rel``
                (required iff the relationship has edge attributes).

        Raises:
            KeyError: unknown relationship.
            ValueError: misaligned/out-of-range arrays, missing or extra
                attribute columns, or duplicate pairs.

        Usage::

            delta = db.insert_facts("Rated", [3, 7], [1, 1],
                                    {"rating": [2, 0]})
        """
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        attrs = {k: np.asarray(v, dtype=np.int32)
                 for k, v in (attrs or {}).items()}
        if src.size == 0:
            return None
        self._check_new_edges(rel, src, dst, attrs)
        tab = self.relations[rel]
        tab.src = np.concatenate([tab.src, src])
        tab.dst = np.concatenate([tab.dst, dst])
        for name in tab.attrs:
            tab.attrs[name] = np.concatenate([tab.attrs[name], attrs[name]])
        old, self.version = self.version, self.version + 1
        return FactDelta(rel, "insert", src, dst, attrs, old, self.version)

    def delete_facts(self, rel: str, src, dst) -> Optional[FactDelta]:
        """Remove a batch of edges (matched by ``(src, dst)`` pair) from
        relationship ``rel``; bumps ``version`` and returns the applied
        :class:`FactDelta`, whose ``attrs`` capture the attribute values
        the removed edges carried (``None`` for an empty batch).

        Raises:
            KeyError: unknown relationship.
            ValueError: a requested pair is not present (or is requested
                twice).

        Usage::

            delta = db.delete_facts("Rated", [3], [1])
        """
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        if src.shape != dst.shape or src.ndim != 1:
            raise ValueError("src/dst must be aligned 1-D index arrays")
        if src.size == 0:
            return None
        tab = self.relations[rel]
        want = _pair_codes(src, dst)
        if np.unique(want).size != want.size:
            raise ValueError(f"duplicate (src, dst) pairs in delete batch "
                             f"for {rel!r}")
        codes = _pair_codes(tab.src, tab.dst)
        mask = np.isin(codes, want)
        if int(mask.sum()) != want.size:
            gone = ~np.isin(want, codes)
            missing = sorted(zip(src[gone].tolist(), dst[gone].tolist()))
            raise ValueError(f"edges not present in {rel!r}: "
                             f"{missing[:5]}")
        removed_attrs = {name: col[mask] for name, col in tab.attrs.items()}
        removed_src, removed_dst = tab.src[mask], tab.dst[mask]
        tab.src, tab.dst = tab.src[~mask], tab.dst[~mask]
        for name in tab.attrs:
            tab.attrs[name] = tab.attrs[name][~mask]
        old, self.version = self.version, self.version + 1
        return FactDelta(rel, "delete", removed_src, removed_dst,
                         removed_attrs, old, self.version)

    def update_attrs(self, etype: str, rows,
                     attrs: Mapping[str, np.ndarray]
                     ) -> Optional[AttrDelta]:
        """Overwrite attribute values for a batch of entities of type
        ``etype``; bumps ``version`` and returns the applied
        :class:`AttrDelta` (``None`` for an empty batch — no version bump).

        Args:
            etype: entity-type name.
            rows: entity ids (row indices) to write; duplicates within the
                batch are rejected (the old-value capture would be
                ambiguous).
            attrs: one aligned value column per attribute to write — a
                subset of the type's attributes is fine, untouched columns
                keep their values.

        Raises:
            KeyError: unknown entity type.
            ValueError: empty ``attrs``, unknown attribute, misaligned or
                out-of-range arrays, or duplicate rows in the batch.

        Usage::

            delta = db.update_attrs("user", [3, 7], {"age": [1, 2]})
        """
        tab = self.entities[etype]
        rows = np.asarray(rows, dtype=np.int32)
        attrs = {k: np.asarray(v, dtype=np.int32) for k, v in attrs.items()}
        if rows.ndim != 1:
            raise ValueError("rows must be a 1-D index array")
        if rows.size == 0:
            return None
        if not attrs:
            raise ValueError("update_attrs needs at least one attribute "
                             "column")
        if rows.min() < 0 or rows.max() >= tab.size:
            raise ValueError(f"row index out of range for {etype!r}")
        if np.unique(rows).size != rows.size:
            raise ValueError(f"duplicate rows in update batch for {etype!r}")
        cards = {a.name: a.card for a in tab.type.attrs}
        for name, col in attrs.items():
            if name not in cards:
                raise ValueError(f"unknown attribute {name!r} for {etype!r}")
            if col.shape != rows.shape:
                raise ValueError(f"attr {name!r} not aligned with rows")
            if col.min() < 0 or col.max() >= cards[name]:
                raise ValueError(f"attr {name!r} value out of range")
        old_vals = {name: tab.attrs[name][rows].copy() for name in attrs}
        for name, col in attrs.items():
            tab.attrs[name][rows] = col
        old, self.version = self.version, self.version + 1
        return AttrDelta(etype, rows, old_vals, attrs, old, self.version)

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
