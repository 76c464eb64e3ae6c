"""Relational schema description.

The language bias follows FACTORBASE (Schulte & Qian 2019): first-order
variables range over entity types (one *population variable* per entity type;
self-relationships use a second copy of the variable).  A schema declares

* entity types, each with categorical attributes of known cardinality, and
* binary relationship types between two entity types, each with categorical
  *edge attributes* of known cardinality.

Everything downstream is integer coded: attribute values live in
``[0, card)``.  Edge attributes additionally reserve the value ``card`` as the
``N/A`` slot used when the relationship indicator is false (paper Table 3).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


class _CachedHash:
    """Memoised ``__hash__`` for the frozen descriptor dataclasses.

    Schema and query descriptors key every hot dict on the serve path —
    plan compilation, request coalescing, router/service/engine caches —
    and a recursive dataclass hash over nested tuples is recomputed on
    EVERY lookup (tuple hashes are not cached by CPython).  Computing it
    once per instance keeps a query flood's time in counting, not hashing.
    Hashing stays consistent with field equality: equal field values give
    equal hashes, memoised or not."""

    __hash_seed__: str = ""

    def __hash__(self) -> int:
        h = self.__dict__.get("_hash")
        if h is None:
            fields = tuple(v for k, v in self.__dict__.items()
                           if k != "_hash")
            h = hash((self.__hash_seed__,) + fields)
            object.__setattr__(self, "_hash", h)
        return h


@dataclass(frozen=True)
class Attribute:
    name: str
    card: int  # number of real values (excludes the N/A slot for edge attrs)

    def __post_init__(self) -> None:
        if self.card < 1:
            raise ValueError(f"attribute {self.name!r} needs card >= 1")


@dataclass(frozen=True)
class EntityType:
    name: str
    size: int                         # number of entities
    attrs: Tuple[Attribute, ...] = ()

    def attr(self, name: str) -> Attribute:
        for a in self.attrs:
            if a.name == name:
                return a
        raise KeyError(name)


@dataclass(frozen=True)
class Relationship:
    name: str
    src: str                          # entity type name
    dst: str                          # entity type name
    attrs: Tuple[Attribute, ...] = () # edge attributes

    @property
    def is_self(self) -> bool:
        return self.src == self.dst

    def attr(self, name: str) -> Attribute:
        for a in self.attrs:
            if a.name == name:
                return a
        raise KeyError(name)


@dataclass(frozen=True)
class Schema(_CachedHash):
    entities: Tuple[EntityType, ...]
    relationships: Tuple[Relationship, ...]

    __hash_seed__ = "Schema"
    __hash__ = _CachedHash.__hash__

    def entity(self, name: str) -> EntityType:
        for e in self.entities:
            if e.name == name:
                return e
        raise KeyError(name)

    def relationship(self, name: str) -> Relationship:
        for r in self.relationships:
            if r.name == name:
                return r
        raise KeyError(name)

    def validate(self) -> None:
        enames = [e.name for e in self.entities]
        if len(set(enames)) != len(enames):
            raise ValueError("duplicate entity type names")
        rnames = [r.name for r in self.relationships]
        if len(set(rnames)) != len(rnames):
            raise ValueError("duplicate relationship names")
        for r in self.relationships:
            self.entity(r.src)
            self.entity(r.dst)
