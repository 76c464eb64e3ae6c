"""Integer-coded relational database + synthetic generators.

A :class:`RelationalDB` stands in for the paper's MariaDB input: every
entity table is a dict of ``int32[n]`` attribute columns and every
relationship table is an edge list ``(src int32[m], dst int32[m])`` plus
``int32[m]`` edge-attribute columns.  The arrays stay on the host as numpy;
the executors move index and code arrays to the counting device (the sparse
executor keeps a copy of each column it reads).  No write changes a column
in place: a write replaces the arrays it changes.

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

A database too large for one counting stack is hash-partitioned by a root
entity type into a :class:`ShardedDatabase` (:func:`shard_database`):
entity tables and the relationships away from the root type are shared by
every shard, the root type's relationships are split by edge.
:meth:`ShardedDatabase.route` decides, per query, whether the shards'
tables sum to the answer (fan-out) or one shard holds it (single), and
:func:`fanout_view` reassembles the unsharded edge tables as one view.

The synthetic generator plants real statistical dependencies (attribute
values correlated along edges) so that structure search has signal to find,
and lets benchmarks dial ``rows`` up to the paper's Visual Genome scale
(15.8M rows).  Its numpy RNG calls are those of the JAX reference package,
so the same ``(name, seed, scale)`` gives byte-identical arrays in both.
"""

from __future__ import annotations

import warnings
import zlib
from dataclasses import dataclass, field, replace as _dc_replace
from typing import Dict, List, Mapping, Optional, Tuple

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
            # a new column in place of the old, never a write into it: a
            # copy of the old array (the sparse executor's) stays true
            new = tab.attrs[name].copy()
            new[rows] = col
            tab.attrs[name] = new
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
# Horizontal partitioning: ShardedDatabase
# ---------------------------------------------------------------------------

class NotRoutableError(ValueError):
    """A counting query cannot be answered by fan-out + count addition over
    the shards of a :class:`ShardedDatabase` (see
    :meth:`ShardedDatabase.route` for the exact condition)."""


def _shard_hash(ids: np.ndarray, n_shards: int) -> np.ndarray:
    """Deterministic multiplicative hash of entity ids onto shard indices
    (Knuth's 2654435761 mod 2^32) — stable across processes and platforms,
    unlike Python's salted ``hash``."""
    h = (ids.astype(np.int64) * 2654435761) & 0xFFFFFFFF
    return (h % n_shards).astype(np.int64)


def _route_key(point) -> int:
    """Stable small hash of a lattice point, used only to spread
    replicated-only queries across shards."""
    return zlib.crc32(str(point).encode())


@dataclass
class ShardedDatabase:
    """A horizontally partitioned :class:`RelationalDB`.

    Every shard is itself a complete, valid ``RelationalDB`` over the SAME
    schema and the SAME entity-id space:

    * **entity tables are replicated** on every shard (they are the small
      attribute tables — ``n_entities`` rows each — and replication keeps
      every edge index valid everywhere);
    * **relationship tables incident to ``root_etype``** are
      hash-partitioned by the ``root_etype`` endpoint of each edge
      (``src`` for self-relationships): every edge lives on exactly one
      shard, and all edges touching the same root entity live together;
    * **other relationship tables are replicated** (every shard sees every
      edge), subject to the size heuristic in :func:`shard_database`.

    Partition assignment goes through a level of indirection: root-entity
    ids hash onto ``n_buckets`` fixed **buckets** and ``bucket_map`` sends
    each bucket to a shard.  The bucket space never changes, so
    :meth:`split_shard` rebalances a hot shard by *moving buckets* — only
    that shard's rows move, every other shard's data (and caches) stay
    untouched.

    Positive-count queries are answered by running the ordinary counting
    stack per shard and merging tables at a front-end
    (:class:`repro_torch.serve.router.CountingRouter`); :meth:`route` decides,
    per query, whether the merge is a fan-out **sum** or a **single-shard**
    lookup.  Use :func:`shard_database` to build one.

    Usage::

        sdb = shard_database(db, n_shards=4)
        assert sdb.route(point)[0] in ("fanout", "single")
    """

    schema: Schema
    shards: Tuple[RelationalDB, ...]
    root_etype: str
    partitioned: frozenset = field(default_factory=frozenset)  # rel names
    n_buckets: int = 0                 # 0 = legacy 1-bucket-per-shard
    bucket_map: Tuple[int, ...] = ()   # bucket -> shard index

    def __post_init__(self) -> None:
        if not self.bucket_map:        # direct construction: identity map
            self.n_buckets = self.n_buckets or len(self.shards)
            self.bucket_map = tuple(b % len(self.shards)
                                    for b in range(self.n_buckets))

    @property
    def n_shards(self) -> int:
        return len(self.shards)

    def shard_of_ids(self, ids: np.ndarray) -> np.ndarray:
        """Shard index of each root-entity id (hash -> bucket -> shard)."""
        buckets = _shard_hash(np.asarray(ids), self.n_buckets)
        return np.asarray(self.bucket_map, dtype=np.int64)[buckets]

    def partitioned_rows(self, shard_id: int) -> int:
        """Rows of partitioned relationship tables living on one shard —
        the size the rebalancing threshold watches (replicated tables are
        everywhere, so they don't distinguish shards)."""
        shard = self.shards[shard_id]
        return sum(shard.relations[r].num_edges for r in self.partitioned)

    # -- writes --------------------------------------------------------------
    def _key_ids(self, rel: str, src: np.ndarray,
                 dst: np.ndarray) -> np.ndarray:
        rt = self.schema.relationship(rel)
        return src if rt.src == self.root_etype else dst

    def insert_facts(self, rel: str, src, dst,
                     attrs: Optional[Mapping[str, np.ndarray]] = None
                     ) -> List[Optional[FactDelta]]:
        """Apply one insert batch across the shards.

        Partitioned relationships: each edge goes to the shard its
        root-entity endpoint hashes to (same assignment as
        :func:`shard_database`).  Replicated relationships: the shared
        table is mutated ONCE and every shard's version bumps.

        Returns:
            One entry per shard, aligned with ``shards``: the
            :class:`FactDelta` that shard must reconcile, or ``None`` when
            the shard received no edges (its data — and caches — are
            untouched).

        Usage::

            deltas = sdb.insert_facts("Rated", src, dst, {"rating": vals})
        """
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        attrs = {k: np.asarray(v, dtype=np.int32)
                 for k, v in (attrs or {}).items()}
        if rel not in self.partitioned:
            return self._apply_replicated(rel, "insert", src, dst, attrs)
        assign = self.shard_of_ids(self._key_ids(rel, src, dst))
        out: List[Optional[FactDelta]] = []
        for s, shard in enumerate(self.shards):
            m = assign == s
            if not m.any():
                out.append(None)
                continue
            out.append(shard.insert_facts(
                rel, src[m], dst[m], {k: v[m] for k, v in attrs.items()}))
        return out

    def delete_facts(self, rel: str, src, dst) -> List[Optional[FactDelta]]:
        """Apply one delete batch across the shards (edges matched by
        ``(src, dst)`` pair; see :meth:`insert_facts` for the routing and
        return convention)."""
        src = np.asarray(src, dtype=np.int32)
        dst = np.asarray(dst, dtype=np.int32)
        if rel not in self.partitioned:
            return self._apply_replicated(rel, "delete", src, dst, {})
        assign = self.shard_of_ids(self._key_ids(rel, src, dst))
        out: List[Optional[FactDelta]] = []
        for s, shard in enumerate(self.shards):
            m = assign == s
            out.append(shard.delete_facts(rel, src[m], dst[m])
                       if m.any() else None)
        return out

    def update_attrs(self, etype: str, rows,
                     attrs: Mapping[str, np.ndarray]
                     ) -> List[Optional[AttrDelta]]:
        """Apply one entity-attribute write batch across the shards.

        Entity tables are SHARED objects replicated to every shard, so the
        columns are mutated ONCE (through shard 0) and every shard's
        version bumps; each shard gets an equivalent :class:`AttrDelta`
        with its own version bracket (same convention as replicated
        relationship writes)."""
        first = self.shards[0].update_attrs(etype, rows, attrs)
        if first is None:
            return [None] * self.n_shards
        out: List[Optional[AttrDelta]] = [first]
        for shard in self.shards[1:]:
            old, shard.version = shard.version, shard.version + 1
            out.append(_dc_replace(first, old_version=old,
                                   new_version=shard.version))
        return out

    def _apply_replicated(self, rel: str, op: str, src: np.ndarray,
                          dst: np.ndarray, attrs: Dict[str, np.ndarray]
                          ) -> List[Optional[FactDelta]]:
        """Replicated tables are SHARED objects: mutate through shard 0,
        then bump the other shards' versions and hand each an equivalent
        delta (same edges, that shard's version bracket)."""
        first = (self.shards[0].insert_facts(rel, src, dst, attrs)
                 if op == "insert"
                 else self.shards[0].delete_facts(rel, src, dst))
        if first is None:
            return [None] * self.n_shards
        out: List[Optional[FactDelta]] = [first]
        for shard in self.shards[1:]:
            old, shard.version = shard.version, shard.version + 1
            out.append(_dc_replace(first, old_version=old,
                                   new_version=shard.version))
        return out

    # -- online rebalancing --------------------------------------------------
    def split_shard(self, shard_id: int) -> "ShardedDatabase":
        """Split one shard by moving half of its hash buckets to a NEW
        shard (index ``n_shards``), re-partitioning only that shard's
        relationship tables.

        The receiver (``self``) is left untouched — in-flight queries
        against the old shard set stay consistent; callers swap to the
        returned :class:`ShardedDatabase` atomically (see
        :meth:`repro_torch.serve.router.CountingRouter.rebalance`).  Entity
        tables and replicated relationship tables are shared with the old
        generation, so a split moves only the partitioned rows of the one
        shard being split.

        Raises:
            IndexError: ``shard_id`` out of range.
            ValueError: the shard owns fewer than two buckets (nothing
                left to split; re-shard with a larger ``n_buckets``).

        Usage::

            sdb2 = sdb.split_shard(0)
            assert sdb2.n_shards == sdb.n_shards + 1
        """
        if not 0 <= shard_id < self.n_shards:
            raise IndexError(f"shard {shard_id} out of range")
        owned = [b for b, s in enumerate(self.bucket_map) if s == shard_id]
        if len(owned) < 2:
            raise ValueError(
                f"shard {shard_id} owns {len(owned)} bucket(s); cannot "
                f"split further (re-shard with a larger n_buckets)")
        new_idx = self.n_shards
        moving = set(owned[len(owned) // 2:])
        new_map = list(self.bucket_map)
        for b in moving:
            new_map[b] = new_idx
        old = self.shards[shard_id]
        keep_rels: Dict[str, RelationTable] = {}
        move_rels: Dict[str, RelationTable] = {}
        for name, tab in old.relations.items():
            if name not in self.partitioned:
                keep_rels[name] = tab          # replicated: shared reference
                move_rels[name] = tab
                continue
            key_ids = tab.src if tab.type.src == self.root_etype else tab.dst
            buckets = _shard_hash(np.asarray(key_ids), self.n_buckets)
            mv = np.isin(buckets, list(moving))
            move_rels[name] = RelationTable(
                tab.type, tab.src[mv], tab.dst[mv],
                {a: col[mv] for a, col in tab.attrs.items()})
            keep_rels[name] = RelationTable(
                tab.type, tab.src[~mv], tab.dst[~mv],
                {a: col[~mv] for a, col in tab.attrs.items()})
        shrunk = RelationalDB(self.schema, old.entities, keep_rels,
                              version=old.version)
        fresh = RelationalDB(self.schema, old.entities, move_rels,
                             version=old.version)
        shards = (self.shards[:shard_id] + (shrunk,)
                  + self.shards[shard_id + 1:] + (fresh,))
        return ShardedDatabase(self.schema, shards, self.root_etype,
                               self.partitioned, self.n_buckets,
                               tuple(new_map))

    def _partition_side_var(self, atom) -> "object":
        """The variable at the partition-key endpoint of a partitioned
        atom: the ``root_etype`` end of the relationship (``src`` wins for
        self-relationships, matching :func:`shard_database`)."""
        rel = self.schema.relationship(atom.rel)
        return atom.src if rel.src == self.root_etype else atom.dst

    def route(self, point) -> Tuple[str, Optional[int]]:
        """Decide how a positive-count query over ``point`` is answered.

        Per-shard counts sum to the true count exactly when every satisfied
        grounding finds ALL of its partitioned edges on one shard.  That
        holds in exactly two cases:

        * no atom of the point uses a partitioned relationship — every
          shard holds the full (replicated) data, so the query is answered
          by ONE shard (summing would over-count ``n_shards``-fold);
        * every partitioned atom touches the *same* first-order variable at
          its partition-key endpoint — that grounding value hashes all the
          edges of the grounding onto one shard, so fan-out + sum is exact.

        Args:
            point: a :class:`~repro_torch.core.variables.LatticePoint`.

        Returns:
            ``("fanout", None)`` — query every shard, add the tables; or
            ``("single", shard_index)`` — query that one shard.

        Raises:
            NotRoutableError: partitioned atoms disagree on the
                partition-key variable (e.g. a chain entering the root
                entity type at two different variables); no additive
                merge over this partitioning exists.
        """
        part_atoms = [a for a in point.atoms if a.rel in self.partitioned]
        if not part_atoms:
            return ("single", _route_key(point) % self.n_shards)
        side_vars = {self._partition_side_var(a) for a in part_atoms}
        if len(side_vars) > 1:
            raise NotRoutableError(
                f"point {point} joins partitioned relationships "
                f"{sorted(a.rel for a in part_atoms)} at different "
                f"{self.root_etype!r} variables {sorted(map(str, side_vars))}; "
                f"per-shard counts are not additive under this partitioning "
                f"(re-shard with a different root_etype or replicate one "
                f"of the relationships)")
        return ("fanout", None)


def _replicated_bytes(db: RelationalDB, root_etype: str) -> int:
    """Bytes of relationship tables that would be REPLICATED to every
    shard under ``root_etype`` — the footprint the partition-side
    heuristic minimises."""
    return sum(tab.nbytes for name, tab in db.relations.items()
               if root_etype not in (tab.type.src, tab.type.dst))


def shard_database(db: RelationalDB, n_shards: int,
                   root_etype: Optional[str] = None,
                   n_buckets: Optional[int] = None,
                   max_replicated_bytes: int = 64 << 20,
                   on_oversized_replicated: str = "warn") -> ShardedDatabase:
    """Hash-partition ``db`` into ``n_shards`` complete sub-databases.

    Relationship tables incident to ``root_etype`` are split by the hash of
    their ``root_etype`` endpoint (the *root entity* of a counting query);
    entity tables and the remaining relationship tables are replicated —
    see :class:`ShardedDatabase` for the exact layout and the merge
    semantics it buys.  Assignment goes through ``n_buckets`` fixed hash
    buckets so :meth:`ShardedDatabase.split_shard` can later rebalance a
    hot shard by moving buckets instead of re-hashing the world.

    Args:
        db: the database to partition (left untouched; shards share its
            entity/replicated arrays and hold views of partitioned ones).
        n_shards: number of shards (>= 1).
        root_etype: entity type whose ids are the partition key.  Defaults
            to the **smaller-footprint partition side**: the incident type
            whose choice replicates the fewest relationship-table bytes
            (ties broken by incident-relationship count, entity size, then
            name).
        n_buckets: size of the fixed bucket space (defaults to
            ``max(64, 8 * n_shards)``); must be >= ``n_shards``.
        max_replicated_bytes: replication heuristic — a relationship table
            larger than this that would be replicated to every shard
            triggers ``on_oversized_replicated``.
        on_oversized_replicated: ``"warn"`` (default) emits a
            ``ResourceWarning``; ``"error"`` refuses with ``ValueError``
            (re-shard with a root type incident to that relationship);
            ``"ignore"`` replicates silently.

    Returns:
        A :class:`ShardedDatabase` whose shards each pass
        :meth:`RelationalDB.validate`.

    Raises:
        ValueError: ``n_shards < 1``, ``n_buckets < n_shards``,
            ``root_etype`` names no entity type / touches no relationship,
            or an oversized replicated table under ``"error"``.

    Usage::

        sdb = shard_database(paper_benchmark_db("UW"), n_shards=2)
        assert sum(s.relations["Registered"].num_edges
                   for s in sdb.shards) == db.relations["Registered"].num_edges
    """
    if n_shards < 1:
        raise ValueError("n_shards must be >= 1")
    if n_buckets is None:
        n_buckets = max(64, 8 * n_shards)
    if n_buckets < n_shards:
        raise ValueError(f"n_buckets={n_buckets} < n_shards={n_shards}")
    incident: Dict[str, int] = {et.name: 0 for et in db.schema.entities}
    for rt in db.schema.relationships:
        incident[rt.src] += 1
        if rt.dst != rt.src:
            incident[rt.dst] += 1
    if root_etype is None:
        candidates = [n for n in incident if incident[n] > 0]
        if not candidates:
            raise ValueError("schema has no relationships to partition")
        root_etype = min(
            candidates,
            key=lambda n: (_replicated_bytes(db, n), -incident[n],
                           -db.schema.entity(n).size, n))
    elif root_etype not in incident:
        raise ValueError(f"unknown entity type {root_etype!r}")
    if incident[root_etype] == 0:
        raise ValueError(f"root_etype {root_etype!r} touches no relationship; "
                         f"nothing would be partitioned")

    partitioned = frozenset(rt.name for rt in db.schema.relationships
                            if root_etype in (rt.src, rt.dst))
    for name, tab in db.relations.items():
        if name in partitioned or tab.nbytes <= max_replicated_bytes:
            continue
        msg = (f"relationship {name!r} ({tab.nbytes} bytes) would be "
               f"replicated to every shard under root_etype="
               f"{root_etype!r} and exceeds max_replicated_bytes="
               f"{max_replicated_bytes}; re-shard with a root type "
               f"incident to it")
        if on_oversized_replicated == "error":
            raise ValueError(msg)
        if on_oversized_replicated == "warn":
            warnings.warn(msg, ResourceWarning, stacklevel=2)

    bucket_map = tuple(b % n_shards for b in range(n_buckets))
    bmap = np.asarray(bucket_map, dtype=np.int64)
    assign: Dict[str, np.ndarray] = {}         # hash each edge list once
    for name in partitioned:
        tab = db.relations[name]
        key_ids = tab.src if tab.type.src == root_etype else tab.dst
        assign[name] = bmap[_shard_hash(np.asarray(key_ids), n_buckets)]
    shards: List[RelationalDB] = []
    for s in range(n_shards):
        relations: Dict[str, RelationTable] = {}
        for name, tab in db.relations.items():
            if name not in partitioned:
                relations[name] = tab          # replicated: shared reference
                continue
            mask = assign[name] == s
            relations[name] = RelationTable(
                tab.type, tab.src[mask], tab.dst[mask],
                {a: col[mask] for a, col in tab.attrs.items()})
        shard = RelationalDB(db.schema, db.entities, relations)
        shard.validate()
        shards.append(shard)
    return ShardedDatabase(db.schema, tuple(shards), root_etype, partitioned,
                           n_buckets, bucket_map)


def fanout_view(dbs, partitioned: frozenset) -> RelationalDB:
    """The UNSHARDED database reassembled from its shards, as one view:
    each partitioned relationship's edge arrays are the shards' arrays
    concatenated (every edge lives on exactly one shard, so the
    concatenation is the whole edge table); entity tables and replicated
    relationship tables are shard 0's, shared with no copy (replicas are
    the same objects on every shard).  Counting a routable fan-out plan on
    this view gives the merged table directly — the same argument that
    makes the fan-out sum exact, with one segment space in place of
    ``len(dbs)``.  The view's version is shard 0's.

    Usage::

        view = fanout_view(sdb.shards, sdb.partitioned)
    """
    dbs = list(dbs)
    relations = dict(dbs[0].relations)
    for name in partitioned:
        parts = [db.relations[name] for db in dbs]
        tab = parts[0]
        relations[name] = RelationTable(
            tab.type, np.concatenate([p.src for p in parts]),
            np.concatenate([p.dst for p in parts]),
            {a: np.concatenate([p.attrs[a] for p in parts])
             for a in tab.attrs})
    return RelationalDB(dbs[0].schema, dbs[0].entities, relations,
                        version=dbs[0].version)


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
