"""Planner: compile ``(LatticePoint, keep)`` into a backend-agnostic
contraction plan.

The SQL ``INNER JOIN + GROUP BY + COUNT(*)`` of FACTORBASE is, for a
tree-structured lattice point, one message-passing sweep over the point's
variable tree.  The planner decides everything that does NOT depend on how
messages are represented:

* which variable roots the tree (the centre — max degree — so interior
  messages stay one hop wide and the root combine is deferred to a single
  multi-factor reduction);
* the traversal order (a tree of :class:`HopSpec` under each
  :class:`NodeSpec`);
* which attribute axes each factor carries (``keep`` filtered per
  variable / relationship, in canonical schema order);
* the flattened axis order every message will have, so executors agree on
  layout without communicating.

Executors (:mod:`repro_torch.core.executors`) walk the plan and choose the
representation: dense one-hot matrices reduced by matrix products, or raw
``int32`` code arrays + segment-sum scatter-adds.  Plans are
frozen/hashable — they double as cache keys and as batching signatures
(two plans with the same :meth:`ContractionPlan.shape_signature` produce
same-shape ct-tables, which is what lets structure search score families
in one batched call).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

from .schema import Schema
from .variables import Atom, CtVar, LatticePoint, Var, attr_var, edge_var


@dataclass(frozen=True)
class FactorSpec:
    """The 'own attributes' factor of one first-order variable: the kept
    attribute axes of ``var`` in canonical (schema) order."""
    var: Var
    attrs: Tuple[CtVar, ...]

    @property
    def card(self) -> int:
        out = 1
        for v in self.attrs:
            out *= v.card
        return out


@dataclass(frozen=True)
class HopSpec:
    """One join hop: the subtree message of ``child`` pushed through
    ``atom`` to ``parent`` — gather at the child end of the edge list,
    (outer-)multiply in kept edge-attribute axes, segment-sum at the parent
    end.  ``out_vars`` is the flattened axis order of the hop's output."""
    atom: Atom
    child: Var
    parent: Var
    edge_attrs: Tuple[CtVar, ...]
    child_node: "NodeSpec"
    out_vars: Tuple[CtVar, ...]

    @property
    def is_leaf_hop(self) -> bool:
        return not self.child_node.hops


@dataclass(frozen=True)
class NodeSpec:
    """Message spec for the subtree rooted at ``var``: the variable's own
    factor combined with the hop outputs of its children.  ``out_vars`` is
    the flattened axis order of the node's message (own attrs first, then
    each hop's axes in traversal order)."""
    own: FactorSpec
    hops: Tuple[HopSpec, ...]
    out_vars: Tuple[CtVar, ...]

    @property
    def var(self) -> Var:
        return self.own.var


@dataclass(frozen=True)
class ContractionPlan:
    """A compiled positive-count query: root node + requested output order.

    ``out_vars`` is the axis order of the raw contraction result;
    executors transpose to ``keep`` at the end (both orders cover the same
    var set — ``keep`` restricted to axes that exist on the point).
    """
    point: LatticePoint
    keep: Tuple[CtVar, ...]
    root: NodeSpec
    out_vars: Tuple[CtVar, ...]

    @property
    def out_shape(self) -> Tuple[int, ...]:
        return tuple(v.card for v in self.keep)

    def shape_signature(self) -> Tuple[Tuple[str, int], ...]:
        """Batching key: plans with equal signatures yield same-shape
        ct-tables (axis kinds + cards, in output order)."""
        return tuple((v.kind, v.card) for v in self.keep)

    def tree_signature(self) -> Tuple:
        """Structural batching key: the hop-tree topology with per-factor
        attribute cards and per-hop edge-attribute cards, independent of the
        concrete variables/relations involved.  Two plans with equal tree
        signatures run the *same* sequence of contraction operations; add the
        database-dependent array sizes (entity sizes, edge counts) and their
        inputs can be stacked and executed in one batched call."""
        def node(n: NodeSpec) -> Tuple:
            return (tuple(cv.card for cv in n.own.attrs),
                    tuple((tuple(cv.card for cv in h.edge_attrs),
                           node(h.child_node)) for h in n.hops))
        return (node(self.root), self.shape_signature())


def _kept_entity_attrs(schema: Schema, var: Var,
                       keep: Tuple[CtVar, ...]) -> Tuple[CtVar, ...]:
    out: List[CtVar] = []
    for a in schema.entity(var.etype).attrs:
        cv = attr_var(var, a.name, a.card)
        if cv in keep:
            out.append(cv)
    return tuple(out)


def _kept_edge_attrs(schema: Schema, rel: str,
                     keep: Tuple[CtVar, ...]) -> Tuple[CtVar, ...]:
    rt = schema.relationship(rel)
    out: List[CtVar] = []
    for a in rt.attrs:
        cv = edge_var(rel, a.name, a.card)
        if cv in keep:
            out.append(cv)
    return tuple(out)


def compile_plan(schema: Schema, point: LatticePoint,
                 keep: Optional[Sequence[CtVar]] = None) -> ContractionPlan:
    """Compile the positive-count query for ``point`` over ``keep``.

    ``keep`` may contain entity-attr and edge-attr CtVars of the point (rind
    axes are the Möbius join's job, not the contraction's); defaults to all
    of them.  Purely metadata-driven — no data access.
    """
    if keep is None:
        keep = point.all_ct_vars(schema, include_rind=False)
    keep = tuple(keep)
    if not point.atoms:
        raise ValueError("compile_plan needs at least one atom")

    adj: Dict[Var, List[Tuple[Atom, Var]]] = {}
    for a in point.atoms:
        adj.setdefault(a.src, []).append((a, a.dst))
        adj.setdefault(a.dst, []).append((a, a.src))
    root_var = max(point.vars, key=lambda v: len(adj.get(v, ())))

    def build_node(v: Var, parent_atom: Optional[Atom]) -> NodeSpec:
        own = FactorSpec(v, _kept_entity_attrs(schema, v, keep))
        hops: List[HopSpec] = []
        out_vars: List[CtVar] = list(own.attrs)
        for atom, u in adj.get(v, ()):
            if atom is parent_atom:
                continue
            child = build_node(u, atom)
            eattrs = _kept_edge_attrs(schema, atom.rel, keep)
            hop_vars = child.out_vars + eattrs
            hops.append(HopSpec(atom, u, v, eattrs, child, hop_vars))
            out_vars.extend(hop_vars)
        return NodeSpec(own, tuple(hops), tuple(out_vars))

    root = build_node(root_var, None)
    return ContractionPlan(point, keep, root, root.out_vars)


@lru_cache(maxsize=4096)
def _compile_cached(schema: Schema, atoms: Tuple[Atom, ...],
                    keep: Tuple[CtVar, ...]) -> ContractionPlan:
    return compile_plan(schema, LatticePoint(atoms), keep)


def compile_plan_cached(schema: Schema, point: LatticePoint,
                        keep: Tuple[CtVar, ...]) -> ContractionPlan:
    """Memoised :func:`compile_plan` (plans are pure metadata; search
    recompiles the same handful of queries thousands of times)."""
    try:
        return _compile_cached(schema, point.atoms, tuple(keep))
    except TypeError:            # unhashable schema: fall back, don't cache
        return compile_plan(schema, point, keep)


def group_by_signature(plans: Sequence[ContractionPlan],
                       key: str = "shape") -> Dict[Tuple, List[int]]:
    """Group plan *indices* by batching signature, preserving arrival order
    within each group.  ``key="shape"`` buckets by output shape (the
    scheduler's quota unit); ``key="tree"`` buckets by full structural
    signature (the stacked-execution precondition, minus array sizes)."""
    if key not in ("shape", "tree"):
        raise ValueError(f"unknown signature key {key!r}")
    groups: Dict[Tuple, List[int]] = {}
    for i, plan in enumerate(plans):
        sig = (plan.shape_signature() if key == "shape"
               else plan.tree_signature())
        groups.setdefault(sig, []).append(i)
    return groups
