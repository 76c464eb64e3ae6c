"""The plain counting reference: contingency tables, their negative
groundings and BDeu scores, recounted from the generated arrays.

It shares no code and no state with the program: it reads the
configuration and the arrays of :mod:`perfbench.synth`, and describes
axes with its own :class:`Axis`.  Semantics (FACTORBASE's, as the paper
states them): a lattice point is a tree of relationship atoms over
first-order variables, one per entity type (a second copy for the far
side of a self-relationship); a grounding picks one entity per variable;
its cell is given by the variables' attribute values, each atom's edge
attributes (the extra slot ``card``, N/A, where the atom's edge is
absent) and each atom's indicator (0 absent, 1 present).  The complete
table counts every grounding.

How: for each subset ``S`` of the point's atoms, the table of groundings
in which at least the atoms of ``S`` hold is the product of each
connected part's positive count (a sum over the part's joined edges,
done by passing messages along its tree with ``index_add_``) and each
free variable's histogram; the table in which exactly the atoms of ``T``
hold is the alternating sum over ``S`` containing ``T`` (inclusion and
exclusion).  Families are projections of a point's complete table, and
their BDeu scores use ``torch.lgamma``.  Everything runs in ``dtype``
(float64 for the reference, exact below 2^53; the control passes a lower
one) on ``device``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Sequence, Tuple

import torch

from .synth import Arrays

#: Rows of an outer product held at once when summing a root's messages.
CHUNK_ELEMENTS = 1 << 22


class Axis(NamedTuple):
    """One axis of a table: ``kind`` "attr" (owner ``(etype, copy,
    attr)``), "edge" (owner ``(rel, attr)``, length card + 1, the last
    slot N/A) or "rind" (owner ``(rel,)``, length 2)."""
    kind: str
    owner: Tuple
    card: int


Var = Tuple[str, int]                    # (entity type, copy)
Atom = Tuple[str, Var, Var]              # (relationship, src var, dst var)


class Reference:
    """Counts of one generated database.

    Args:
        cfg: the configuration (``configs/<name>.json``).
        arrays: :func:`perfbench.synth.generate`'s arrays.
        device: where to count.
        dtype: the counting precision.
    """

    def __init__(self, cfg: Mapping, arrays: Arrays, device="cpu",
                 dtype=torch.float64):
        self.device = torch.device(device)
        self.dtype = dtype
        self.sizes = dict(arrays["sizes"])
        self.eattrs = {e["name"]: [tuple(a) for a in e["attrs"]]
                       for e in cfg["entities"]}
        self.rels = {r["name"]: (r["src"], r["dst"],
                                 [tuple(a) for a in r["attrs"]])
                     for r in cfg["relationships"]}
        dev = self.device
        self.ecols = {et: {a: torch.as_tensor(col, device=dev).long()
                           for a, col in cols.items()}
                      for et, cols in arrays["entities"].items()}
        self.edges = {}
        for rel, (src, dst, cols) in arrays["relations"].items():
            self.edges[rel] = (
                torch.as_tensor(src, device=dev).long(),
                torch.as_tensor(dst, device=dev).long(),
                {a: torch.as_tensor(c, device=dev).long()
                 for a, c in cols.items()})
        self._complete: Dict[Tuple[str, ...], Tuple] = {}
        self._positive: Dict[Tuple, Tuple] = {}

    # -- descriptors ---------------------------------------------------------
    def atoms(self, rels: Sequence[str]) -> List[Atom]:
        out = []
        for rel in sorted(rels):
            src, dst, _ = self.rels[rel]
            out.append((rel, (src, 0), (dst, 1 if src == dst else 0)))
        return out

    def attr_axes(self, var: Var) -> List[Axis]:
        return [Axis("attr", (var[0], var[1], a), card)
                for a, card in self.eattrs[var[0]]]

    def edge_axes(self, rel: str) -> List[Axis]:
        return [Axis("edge", (rel, a), card + 1)
                for a, card in self.rels[rel][2]]

    def point_axes(self, rels: Sequence[str]) -> List[Axis]:
        """Every axis of a point: its variables' attributes, its atoms'
        edge attributes, its atoms' indicators."""
        atoms = self.atoms(rels)
        vars_ = sorted({v for a in atoms for v in a[1:]})
        axes = [ax for v in vars_ for ax in self.attr_axes(v)]
        axes += [ax for a in atoms for ax in self.edge_axes(a[0])]
        axes += [Axis("rind", (a[0],), 2) for a in atoms]
        return axes

    # -- codes ----------------------------------------------------------------
    def _var_code(self, var: Var) -> Tuple[torch.Tensor, int]:
        n = self.sizes[var[0]]
        code = torch.zeros(n, dtype=torch.long, device=self.device)
        card = 1
        for a, c in self.eattrs[var[0]]:
            code = code * c + self.ecols[var[0]][a]
            card *= c
        return code, card

    def _edge_code(self, rel: str) -> Tuple[torch.Tensor, int]:
        src, _, cols = self.edges[rel]
        code = torch.zeros_like(src)
        card = 1
        for a, c in self.rels[rel][2]:
            code = code * c + cols[a]
            card *= c
        return code, card

    # -- positive counts --------------------------------------------------------
    def positive(self, atoms: Sequence[Atom]) -> Tuple[List[Axis],
                                                       torch.Tensor]:
        """The positive table of one connected tree of atoms: groundings
        of its variables in which every atom holds, over its variables'
        attributes and its atoms' edge attributes (real values only)."""
        key = tuple(sorted(atoms))
        hit = self._positive.get(key)
        if hit is not None:
            return hit
        adj: Dict[Var, List[Tuple[Atom, Var]]] = {}
        for a in key:
            adj.setdefault(a[1], []).append((a, a[2]))
            adj.setdefault(a[2], []).append((a, a[1]))
        root = max(sorted(adj), key=lambda v: len(adj[v]))

        def rows_of(var: Var, parent) -> Tuple[torch.Tensor, List[Axis]]:
            """The product of ``var``'s incoming messages, a row per
            entity, and its axes."""
            msgs = [message(child, var, atom) for atom, child in adj[var]
                    if child != parent]
            n = self.sizes[var[0]]
            out = torch.ones(n, 1, dtype=self.dtype, device=self.device)
            axes: List[Axis] = []
            for m, m_axes in msgs:
                out = (out[:, :, None] * m[:, None, :]).reshape(n, -1)
                axes += m_axes
            return out, axes

        def message(child: Var, parent: Var, atom: Atom):
            """What ``child``'s subtree sends ``parent`` through ``atom``:
            per parent entity, the count of the subtree's groundings by
            the atom's edge attributes, the child's attributes and the
            deeper axes."""
            rows, deeper = rows_of(child, parent)
            src, dst, _ = self.edges[atom[0]]
            xp, xc = (src, dst) if atom[1] == parent else (dst, src)
            ecode, ecard = self._edge_code(atom[0])
            ccode, ccard = self._var_code(child)
            n_p = self.sizes[parent[0]]
            target = (xp * ecard + ecode) * ccard + ccode[xc]
            out = torch.zeros(n_p * ecard * ccard, rows.shape[1],
                              dtype=self.dtype, device=self.device)
            out.index_add_(0, target, rows[xc])
            axes = self.edge_axes(atom[0]) + self.attr_axes(child) + deeper
            return out.reshape(n_p, -1), axes

        msgs = [message(child, root, atom) for atom, child in adj[root]]
        rcode, rcard = self._var_code(root)
        width = 1
        for m, _ in msgs:
            width *= m.shape[1]
        table = torch.zeros(rcard, width, dtype=self.dtype,
                            device=self.device)
        n = self.sizes[root[0]]
        step = max(1, CHUNK_ELEMENTS // width)
        for s in range(0, n, step):
            e = min(n, s + step)
            part = torch.ones(e - s, 1, dtype=self.dtype, device=self.device)
            for m, _ in msgs:
                part = (part[:, :, None] * m[s:e, None, :]).reshape(e - s,
                                                                    -1)
            table.index_add_(0, rcode[s:e], part)
        axes = self.attr_axes(root) + [ax for _, m_axes in msgs
                                       for ax in m_axes]
        shape = [ax.card - (ax.kind == "edge") for ax in axes]
        table = table.reshape(shape)
        # the component's layout: variables' attributes, then edge axes
        vars_ = sorted(adj)
        order = [ax for v in vars_ for ax in self.attr_axes(v)]
        order += [ax for a in key for ax in self.edge_axes(a[0])]
        table = table.permute([axes.index(ax) for ax in order])
        self._positive[key] = (order, table)
        return order, table

    def _hist(self, var: Var) -> torch.Tensor:
        code, card = self._var_code(var)
        counts = torch.bincount(code, minlength=card).to(self.dtype)
        return counts.reshape([c for _, c in self.eattrs[var[0]]])

    # -- complete tables --------------------------------------------------------
    def complete(self, rels: Sequence[str]) -> Tuple[List[Axis],
                                                     torch.Tensor]:
        """The complete table of a point over :meth:`point_axes`."""
        key = tuple(sorted(rels))
        hit = self._complete.get(key)
        if hit is not None:
            return hit
        atoms = self.atoms(key)
        vars_ = sorted({v for a in atoms for v in a[1:]})
        attr_axes = [ax for v in vars_ for ax in self.attr_axes(v)]
        edge_axes = [(j, ax) for j, a in enumerate(atoms)
                     for ax in self.edge_axes(a[0])]
        n = len(atoms)
        n_attr = len(attr_axes)

        pos = {ax: i for i, ax in enumerate(attr_axes)}
        for i, (_, ax) in enumerate(edge_axes):
            pos[ax] = n_attr + i

        def broadcast(t: torch.Tensor, axes: List[Axis]) -> torch.Tensor:
            """``t`` over ``axes`` laid out as an ``atleast`` table: the
            attribute axes, then every edge axis (length 1 where ``t``
            has none)."""
            order = sorted(range(len(axes)), key=lambda i: pos[axes[i]])
            t = t.permute(order)
            shape = [1] * (n_attr + len(edge_axes))
            for k, i in enumerate(order):
                shape[pos[axes[i]]] = t.shape[k]
            return t.reshape(shape)

        atleast = {}
        for subset in range(1 << n):
            chosen = [a for j, a in enumerate(atoms) if subset >> j & 1]
            t = torch.ones([1] * (n_attr + len(edge_axes)),
                           dtype=self.dtype, device=self.device)
            covered = set()
            for comp in _components(chosen):
                axes, table = self.positive(comp)
                t = t * broadcast(table, axes)
                covered.update(v for a in comp for v in a[1:])
            for v in vars_:
                if v in covered:
                    continue
                if self.eattrs[v[0]]:
                    t = t * broadcast(self._hist(v), self.attr_axes(v))
                else:
                    t = t * float(self.sizes[v[0]])
            atleast[subset] = t

        full_shape = ([ax.card for ax in attr_axes]
                      + [ax.card for _, ax in edge_axes] + [2] * n)
        full = torch.zeros(full_shape, dtype=self.dtype, device=self.device)
        for hold in range(1 << n):
            exact = None
            for subset in range(1 << n):
                if subset & hold != hold:
                    continue
                t = atleast[subset]
                extra = subset & ~hold
                dims = [n_attr + i for i, (j, _) in enumerate(edge_axes)
                        if extra >> j & 1]
                if dims:
                    t = t.sum(dim=dims, keepdim=True)
                sign = -1.0 if bin(extra).count("1") % 2 else 1.0
                exact = t * sign if exact is None else exact + t * sign
            index = [slice(None)] * n_attr
            for j, ax in edge_axes:
                index.append(slice(0, ax.card - 1) if hold >> j & 1
                             else slice(ax.card - 1, ax.card))
            index += [1 if hold >> j & 1 else 0 for j in range(n)]
            full[tuple(index)] = exact.expand(full[tuple(index)].shape)
        axes = attr_axes + [ax for _, ax in edge_axes] + [
            Axis("rind", (a[0],), 2) for a in atoms]
        self._complete[key] = (axes, full)
        return axes, full

    def family(self, rels: Sequence[str],
               axes: Sequence[Axis]) -> torch.Tensor:
        """The complete table of a point projected onto ``axes``, in that
        order."""
        all_axes, full = self.complete(rels)
        keep = [all_axes.index(ax) for ax in axes]
        drop = [i for i in range(len(all_axes)) if i not in keep]
        t = full.sum(dim=drop) if drop else full
        rest = [i for i in range(len(all_axes)) if i in keep]
        return t.permute([rest.index(i) for i in keep])


class Rounded:
    """A reference whose family tables are rounded to ``dtype`` once,
    after counting in float64: a control milder than counting in
    ``dtype`` throughout."""

    def __init__(self, ref: Reference, dtype=torch.bfloat16):
        self.ref, self.dtype = ref, dtype

    def family(self, rels: Sequence[str],
               axes: Sequence[Axis]) -> torch.Tensor:
        return self.ref.family(rels, axes).to(self.dtype)


def _components(atoms: Sequence[Atom]) -> List[List[Atom]]:
    """The connected parts of a set of atoms (by shared variables)."""
    parts: List[List[Atom]] = []
    for a in atoms:
        touching = [p for p in parts
                    if any(set(a[1:]) & set(b[1:]) for b in p)]
        merged = [a] + [b for p in touching for b in p]
        parts = [p for p in parts if p not in touching] + [merged]
    return parts


def bdeu(table: torch.Tensor, ess: float = 1.0) -> Tuple[float, float]:
    """The BDeu log marginal likelihood of a family's table, the child's
    axis last (the paper's Eq. 1, Dirichlet parameters ``ess / q`` and
    ``ess / (q r)``), in float64; and its scale, the sum of the magnitudes
    of the log-gamma terms it adds up (a rounding error of the terms is a
    share of that, however far they cancel)."""
    r = table.shape[-1]
    nijk = table.reshape(-1, r).to(torch.float64)
    q = nijk.shape[0]
    a_j = torch.tensor(ess / q, dtype=torch.float64)
    a_jk = torch.tensor(ess / (q * r), dtype=torch.float64)
    lg = torch.lgamma
    terms = (lg(a_j) * q, -lg(nijk.sum(dim=1) + a_j).sum(),
             lg(nijk + a_jk).sum(), -lg(a_jk) * (q * r))
    score = float(sum(terms))
    scale = float(sum(abs(t) for t in terms))
    return score, scale
