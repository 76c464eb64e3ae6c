"""First-order variables, relationship atoms, lattice points, ct-table axes.

Language bias (per the paper's Related Work): patterns mention only types of
individuals.  We use FACTORBASE population variables — one first-order
variable per entity type, with a second *copy* for the far side of a
self-relationship (``Friend(U0, U1)``).

A **lattice point** is a connected, tree-structured conjunction of distinct
relationship atoms (Figure 2 of the paper).  Tree structure is what makes the
positive count a single-sweep tensor contraction; the benchmark schemas (and
FACTORBASE's own chains) are trees.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import FrozenSet, List, Sequence, Set, Tuple

from .schema import Relationship, Schema, _CachedHash


@dataclass(frozen=True, order=True)
class Var(_CachedHash):
    etype: str
    copy: int = 0

    __hash_seed__ = "Var"
    __hash__ = _CachedHash.__hash__

    def __str__(self) -> str:  # e.g. "student0"
        return f"{self.etype}{self.copy}"


@dataclass(frozen=True, order=True)
class Atom(_CachedHash):
    rel: str
    src: Var
    dst: Var

    __hash_seed__ = "Atom"
    __hash__ = _CachedHash.__hash__

    @property
    def vars(self) -> Tuple[Var, Var]:
        return (self.src, self.dst)


def canonical_atom(rel: Relationship) -> Atom:
    dst_copy = 1 if rel.is_self else 0
    return Atom(rel.name, Var(rel.src, 0), Var(rel.dst, dst_copy))


# --------------------------------------------------------------------------
# ct-table axis descriptors
# --------------------------------------------------------------------------

@dataclass(frozen=True, order=True)
class CtVar(_CachedHash):
    """One axis of a contingency table.

    kind:
      * ``attr`` — entity attribute; owner=(var, attr name); axis size = card.
      * ``edge`` — edge attribute; owner=(rel name, attr name); axis size =
        card + 1, last slot is N/A (used when the indicator is F).
      * ``rind`` — relationship indicator; owner=(rel name,); axis size 2 with
        F=0, T=1.
    """
    kind: str
    owner: Tuple
    card: int

    __hash_seed__ = "CtVar"
    __hash__ = _CachedHash.__hash__

    def __str__(self) -> str:
        if self.kind == "attr":
            var, name = self.owner
            return f"{name}({var})"
        if self.kind == "edge":
            rel, name = self.owner
            return f"{name}[{rel}]"
        return f"{self.owner[0]}?"


def attr_var(var: Var, name: str, card: int) -> CtVar:
    return CtVar("attr", (var, name), card)


def edge_var(rel: str, name: str, card: int) -> CtVar:
    return CtVar("edge", (rel, name), card + 1)   # +1 for N/A


def rind_var(rel: str) -> CtVar:
    return CtVar("rind", (rel,), 2)


# --------------------------------------------------------------------------
# Lattice points
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class LatticePoint(_CachedHash):
    atoms: Tuple[Atom, ...]          # sorted by relationship name

    __hash_seed__ = "LatticePoint"
    __hash__ = _CachedHash.__hash__

    @property
    def rels(self) -> FrozenSet[str]:
        return frozenset(a.rel for a in self.atoms)

    @property
    def vars(self) -> Tuple[Var, ...]:
        vs: Set[Var] = set()
        for a in self.atoms:
            vs.update(a.vars)
        return tuple(sorted(vs))

    @property
    def length(self) -> int:
        return len(self.atoms)

    def __str__(self) -> str:
        return "&".join(f"{a.rel}({a.src},{a.dst})" for a in self.atoms) or "<empty>"

    def all_ct_vars(self, schema: Schema, include_rind: bool = True) -> Tuple[CtVar, ...]:
        """Every ct-table axis associated with this lattice point: all entity
        attributes of its variables, all edge attributes, all indicators."""
        out: List[CtVar] = []
        for v in self.vars:
            for a in schema.entity(v.etype).attrs:
                out.append(attr_var(v, a.name, a.card))
        for atom in self.atoms:
            rel = schema.relationship(atom.rel)
            for a in rel.attrs:
                out.append(edge_var(rel.name, a.name, a.card))
            if include_rind:
                out.append(rind_var(rel.name))
        return tuple(out)


def point_from_rels(schema: Schema, rels: Sequence[str]) -> LatticePoint:
    atoms = tuple(sorted((canonical_atom(schema.relationship(r)) for r in rels)))
    return LatticePoint(atoms)


def _is_connected_tree(atoms: Sequence[Atom]) -> Tuple[bool, bool]:
    """(connected, acyclic) of the var/atom incidence graph."""
    if not atoms:
        return True, True
    vs = sorted({v for a in atoms for v in a.vars})
    idx = {v: i for i, v in enumerate(vs)}
    parent = list(range(len(vs)))

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    acyclic = True
    for a in atoms:
        ri, rj = find(idx[a.src]), find(idx[a.dst])
        if ri == rj:
            acyclic = False
        else:
            parent[ri] = rj
    roots = {find(i) for i in range(len(vs))}
    return len(roots) == 1, acyclic


def connected_components(atoms: Sequence[Atom]) -> List[Tuple[Atom, ...]]:
    """Split a set of atoms into connected components (by shared vars)."""
    remaining = list(atoms)
    comps: List[Tuple[Atom, ...]] = []
    while remaining:
        comp = [remaining.pop()]
        vs = set(comp[0].vars)
        changed = True
        while changed:
            changed = False
            for a in list(remaining):
                if vs & set(a.vars):
                    comp.append(a)
                    vs.update(a.vars)
                    remaining.remove(a)
                    changed = True
        comps.append(tuple(sorted(comp)))
    return comps


def build_lattice(schema: Schema, max_length: int = 2) -> List[LatticePoint]:
    """All connected tree-structured relationship subsets up to ``max_length``,
    ordered bottom-up (shorter chains first) — the relationship lattice of
    Figure 2."""
    rels = [r.name for r in schema.relationships]
    points: List[LatticePoint] = []
    for L in range(1, max_length + 1):
        for combo in itertools.combinations(rels, L):
            atoms = tuple(sorted(canonical_atom(schema.relationship(r))
                                 for r in combo))
            connected, acyclic = _is_connected_tree(atoms)
            if connected and acyclic:
                points.append(LatticePoint(atoms))
    return points
