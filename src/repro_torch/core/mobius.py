"""The Möbius Join: extend positive ct-tables to complete ct-tables.

Inclusion–exclusion over relationship indicators (Qian, Schulte & Sun 2014):
for a final configuration with relation set ``A`` true and ``B`` false,

    N[A=T, B=F, attrs] = sum_{S subseteq B} (-1)^|S| ct_+[A u S true, attrs]

No access to the original data is needed: every term is a positive ct-table of
a *sub-pattern*, served by a :class:`PositiveProvider` — one of the policies
in :mod:`repro_torch.core.engine` (cached-full for PRECOUNT/HYBRID,
on-demand for ONDEMAND, message recombination for TUPLEID) — with
disconnected sub-patterns factorising into outer products of component
tables and per-variable histograms.

Two equivalent evaluation orders are implemented:

* ``blockwise`` — explicit 3^k-term sum, handles kept edge attributes (whose
  axes only exist while their relation is true; when false they collapse to
  the N/A slot).
* ``butterfly`` — the superset Möbius transform as k passes
  ``F-slice = *-slice − T-slice`` over a [2^k, D] stack; the CUDA kernel
  ``kernels/csrc/mobius.cu`` (K3) runs it on the card.  Used when no
  edge-attr axes are kept.  The ``mobius_fn`` hook is normally the
  executor's negative-phase step
  (:meth:`repro_torch.core.executors.Executor.mobius`).

The butterfly path also batches ACROSS queries: butterfly input stacks of
same-``tree_signature`` families are same-shape by construction, so
:func:`complete_ct_many` stacks them into one ``[B, 2^k, D]`` tensor and
runs a single transform per shape group — one negative-phase launch for a
whole hill-climbing round instead of one per family.

The transform is linear, so a write need not flush the negative phase:
:func:`complete_ct_delta_many` pushes the per-block deltas of a fact delta
through the same batched butterfly and the engine adds the result onto the
resident complete tables (:meth:`repro_torch.core.engine.CountingEngine
.apply_delta`).
"""

from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Set, Tuple

import torch

from .contract import CostStats
from .ct import CtTable
from .variables import CtVar, LatticePoint, Var, connected_components, rind_var


class PositiveProvider(Protocol):
    """Source of positive ct-tables and variable histograms."""

    def positive(self, point: LatticePoint, keep: Tuple[CtVar, ...]) -> CtTable: ...

    def hist(self, var: Var, keep: Tuple[CtVar, ...]) -> CtTable: ...


# --------------------------------------------------------------------------
# superset Möbius transform (plain reference; the CUDA kernel mirrors it)
# --------------------------------------------------------------------------

def superset_mobius(stack: torch.Tensor, k: int) -> torch.Tensor:
    """In the leading ``k`` axes (each of size 2, index 1 = "relation true",
    index 0 = "unconstrained"), replace index 0 with "relation false" by
    applying ``x0 <- x0 - x1`` per axis, axis 0 first.  Equivalent to
    ``N[A] = sum_{S >= A} (-1)^{|S|-|A|} Y[S]``."""
    x = stack
    for i in range(k):
        x1 = x.select(i, 1)
        x0 = x.select(i, 0) - x1
        x = torch.stack([x0, x1], dim=i)
    return x


def butterfly_batch(stacks: Sequence[torch.Tensor], k: int,
                    mobius_fn: Optional[Callable[[torch.Tensor, int],
                                                 torch.Tensor]] = None
                    ) -> List[torch.Tensor]:
    """Apply the superset Möbius transform to MANY same-shape butterfly
    stacks in one call.

    The transform only acts on the leading ``k`` binary axes and is
    elementwise over everything else, so batching is a layout trick: the
    stacks are stacked into ``[B, 2, ..., 2, attrs]``, the batch axis is
    moved to the *trailing* (attribute) side, and ``mobius_fn`` — any
    single-stack transform — runs once over the widened attribute space.
    Results are bit-identical to per-stack application.

    Args:
        stacks: same-shape tensors, each ``(2,)*k + attr_shape``.
        k: number of leading indicator axes.
        mobius_fn: single-stack transform ``(stack, k) -> stack``; defaults
            to :func:`superset_mobius`.

    Returns:
        One transformed tensor per input, in input order.

    Usage::

        outs = butterfly_batch([s1, s2, s3], k)
    """
    stacks = list(stacks)
    if not stacks:
        return []
    fn = mobius_fn if mobius_fn is not None else superset_mobius
    if len(stacks) == 1:
        return [fn(stacks[0], k)]
    out = trailing_batch_transform(torch.stack(stacks), k, fn)
    return list(out.unbind(0))


def trailing_batch_transform(batch: torch.Tensor, k: int,
                             fn: Callable[[torch.Tensor, int], torch.Tensor]
                             ) -> torch.Tensor:
    """The batching layout trick of :func:`butterfly_batch`: move the
    leading batch axis of ``[B, 2..2, attrs]`` to the trailing (attribute)
    side — where the transform is elementwise — apply the single-stack
    ``fn`` once, and move it back."""
    moved = torch.movedim(batch, 0, -1)             # [2..2, attrs, B]
    return torch.movedim(fn(moved, k), -1, 0)


# --------------------------------------------------------------------------
# butterfly plumbing shared by the per-query and batched complete-CT paths
# --------------------------------------------------------------------------

class _ButterflyPlan:
    """Static description of one butterfly-eligible complete-CT query:
    the kept axes split into attrs vs indicator relations, plus the final
    transpose from transform layout to request layout."""

    __slots__ = ("keep", "kept_attrs", "effective", "k", "perm")

    def __init__(self, keep, kept_attrs, effective, k, perm):
        self.keep, self.kept_attrs = keep, kept_attrs
        self.effective, self.k, self.perm = effective, k, perm


def _butterfly_plan(point: LatticePoint,
                    keep: Tuple[CtVar, ...]) -> Optional[_ButterflyPlan]:
    """The butterfly evaluation plan for ``(point, keep)``, or ``None``
    when the query is not butterfly-eligible (kept edge-attr axes need the
    blockwise N/A-slot handling; ``k == 0`` has no indicator axes to
    transform)."""
    kept_attrs = tuple(v for v in keep if v.kind == "attr")
    kept_edges = [v for v in keep if v.kind == "edge"]
    kept_rinds = {v.owner[0] for v in keep if v.kind == "rind"}
    effective = tuple(sorted(kept_rinds))
    k = len(effective)
    if kept_edges or k == 0:
        return None
    # rind axis i = effective[i] ({0:F, 1:T} matches the rind_var
    # convention), attr axis k+j = kept_attrs[j]; one transpose replaces
    # 2^k scatters.
    src_axis = ({rind_var(r).owner: i for i, r in enumerate(effective)}
                | {v.owner: k + j for j, v in enumerate(kept_attrs)})
    perm = tuple(src_axis[v.owner] for v in keep)
    return _ButterflyPlan(keep, kept_attrs, effective, k, perm)


def _butterfly_blocks(point: LatticePoint, bp: _ButterflyPlan,
                      provider: PositiveProvider,
                      memo: Optional[Dict] = None) -> List[torch.Tensor]:
    """The aligned transform-input blocks, one per ``{*,T}^k`` corner in
    ``itertools.product`` order: Y[c] = ct_+(T-set of c) over the kept
    attrs (positive phase of the Möbius join).

    ``memo`` (used by :func:`complete_ct_many`) caches the aligned block
    tensors across a batch of queries: a same-signature flood shares its
    sub-pattern tables — most notably the all-unconstrained block, a pure
    product of histograms identical for every family over the same
    variables — so the per-query assembly runs once per DISTINCT block,
    not once per family."""
    blocks = []
    for bits in itertools.product((0, 1), repeat=bp.k):
        X = {r for r, b in zip(bp.effective, bits) if b == 1}
        blk = None
        mkey = None
        if memo is not None:
            # everything the block depends on: the sub-pattern's atoms,
            # the point's var set (histogram factors), the kept axes
            mkey = (tuple(a for a in point.atoms if a.rel in X),
                    tuple(point.vars), bp.kept_attrs)
            blk = memo.get(mkey)
        if blk is None:
            t = _pattern_table(point, X, bp.kept_attrs, provider)
            blk = t.transpose_to(bp.kept_attrs).counts
            if memo is not None:
                memo[mkey] = blk
        blocks.append(blk)
    return blocks


def _butterfly_stack(point: LatticePoint, bp: _ButterflyPlan,
                     provider: PositiveProvider,
                     memo: Optional[Dict] = None) -> torch.Tensor:
    """The transform input: the blocks of :func:`_butterfly_blocks`
    stacked to ``(2,)*k + attr_shape``."""
    blocks = _butterfly_blocks(point, bp, provider, memo)
    attr_shape = tuple(v.card for v in bp.kept_attrs)
    return torch.stack(blocks).reshape((2,) * bp.k + attr_shape)


def _butterfly_finalise(bp: _ButterflyPlan, out: torch.Tensor) -> CtTable:
    """Transform output -> the complete ct-table in request axis order."""
    final = out.permute(bp.perm) \
        if bp.perm != tuple(range(len(bp.perm))) else out
    return CtTable(bp.keep, final)


# --------------------------------------------------------------------------
# pattern tables: positive count of a relation subset over the point's vars
# --------------------------------------------------------------------------

def _pattern_table(point: LatticePoint, rels: Set[str],
                   keep_axes: Tuple[CtVar, ...],
                   provider: PositiveProvider) -> CtTable:
    """ct_+ of the sub-pattern with ``rels`` true, over all vars of ``point``,
    projected onto ``keep_axes`` (entity attrs + edge attrs of rels)."""
    atoms = tuple(a for a in point.atoms if a.rel in rels)
    out: Optional[CtTable] = None
    covered: Set[Var] = set()
    for comp in connected_components(atoms):
        cp = LatticePoint(comp)
        comp_rels = {a.rel for a in comp}
        ckeep = tuple(v for v in keep_axes
                      if (v.kind == "attr" and v.owner[0] in cp.vars)
                      or (v.kind == "edge" and v.owner[0] in comp_rels))
        t = provider.positive(cp, ckeep)
        out = t if out is None else out.outer(t)
        covered.update(cp.vars)
    for var in point.vars:
        if var in covered:
            continue
        vkeep = tuple(v for v in keep_axes
                      if v.kind == "attr" and v.owner[0] == var)
        h = provider.hist(var, vkeep)
        out = h if out is None else out.outer(h)
    assert out is not None
    return out.transpose_to(tuple(v for v in keep_axes if v in out.vars)) \
        if set(out.vars) == set(keep_axes) else out.project(keep_axes)


def positive_queries(point: LatticePoint, keep: Sequence[CtVar],
                     use_butterfly: bool = True
                     ) -> List[Tuple[LatticePoint, Tuple[CtVar, ...]]]:
    """The positive sub-queries :func:`complete_ct` will request from its
    provider for ``(point, keep)``, in request order.

    This mirrors the Möbius join's own enumeration (butterfly vs blockwise
    branch, relation dropping, connected-component factorisation) without
    touching any data — it is what lets a caller warm a whole round of
    family queries before any Möbius join runs (see
    :meth:`repro_torch.core.strategies.Strategy.family_ct_many`).
    Per-variable histogram queries are omitted: they are cheap, shared,
    and cached on first use.  Duplicates across terms are preserved
    (callers dedupe); every entry is a connected sub-pattern.
    """
    keep = tuple(keep)
    kept_attrs = tuple(v for v in keep if v.kind == "attr")
    kept_edges: Dict[str, List[CtVar]] = {}
    for v in keep:
        if v.kind == "edge":
            kept_edges.setdefault(v.owner[0], []).append(v)
    kept_rinds = {v.owner[0] for v in keep if v.kind == "rind"}
    effective = sorted(set(kept_edges) | kept_rinds)
    k = len(effective)

    out: List[Tuple[LatticePoint, Tuple[CtVar, ...]]] = []

    def pattern(rels: Set[str], keep_axes: Tuple[CtVar, ...]) -> None:
        atoms = tuple(a for a in point.atoms if a.rel in rels)
        for comp in connected_components(atoms):
            cp = LatticePoint(comp)
            comp_rels = {a.rel for a in comp}
            ckeep = tuple(v for v in keep_axes
                          if (v.kind == "attr" and v.owner[0] in cp.vars)
                          or (v.kind == "edge" and v.owner[0] in comp_rels))
            out.append((cp, ckeep))

    if use_butterfly and not kept_edges and k > 0:
        for bits in itertools.product((0, 1), repeat=k):
            pattern({r for r, b in zip(effective, bits) if b == 1},
                    kept_attrs)
    else:
        for r_bits in itertools.product((0, 1), repeat=k):
            A = {r for r, b in zip(effective, r_bits) if b == 1}
            B = [r for r in effective if r not in A]
            axes_A = kept_attrs + tuple(
                v for r in sorted(A) for v in kept_edges.get(r, ()))
            for j in range(len(B) + 1):
                for S in itertools.combinations(B, j):
                    pattern(A | set(S), axes_A)
    return out


# --------------------------------------------------------------------------
# complete ct-table
# --------------------------------------------------------------------------

def complete_ct(point: LatticePoint, keep: Sequence[CtVar],
                provider: PositiveProvider,
                stats: Optional[CostStats] = None,
                use_butterfly: bool = True,
                mobius_fn: Optional[Callable[[torch.Tensor, int],
                                             torch.Tensor]] = None
                ) -> CtTable:
    """Complete ct-table over ``keep`` — the Möbius Join.

    ``keep`` may contain entity-attr axes, edge-attr axes, and relationship
    indicator axes of the point.  Relations with neither a kept indicator nor
    a kept edge attribute impose no constraint once their indicator is summed
    out, so they are dropped from the pattern up front (this is what makes
    HYBRID's per-family tables small).
    """
    keep = tuple(keep)
    kept_attrs = tuple(v for v in keep if v.kind == "attr")
    kept_edges: Dict[str, List[CtVar]] = {}
    for v in keep:
        if v.kind == "edge":
            kept_edges.setdefault(v.owner[0], []).append(v)
    kept_rinds = {v.owner[0] for v in keep if v.kind == "rind"}

    effective = sorted(set(kept_edges) | kept_rinds)
    k = len(effective)

    shape = tuple(v.card for v in keep)
    final: Optional[torch.Tensor] = None   # allocated on the blocks' device

    # blocks for distinct A are disjoint iff every rel with a kept edge axis
    # also has its indicator kept (then the rind bits separate all blocks);
    # a kept edge axis WITHOUT its rind spans the N/A slot that the A-less
    # block writes, so those must accumulate.
    disjoint_blocks = all(v.owner[0] in kept_rinds
                          for v in keep if v.kind == "edge")

    def embed(A: Set[str], table: CtTable) -> None:
        """Write block-A into `final` (assignment when blocks are disjoint,
        accumulation otherwise)."""
        nonlocal final
        starts: List[int] = []
        block_axes: List[CtVar] = []
        for v in keep:
            if v.kind == "rind":
                starts.append(1 if v.owner[0] in A else 0)
            elif v.kind == "edge" and v.owner[0] not in A:
                starts.append(v.card - 1)       # N/A slot
            else:
                starts.append(0)
                block_axes.append(v)
        aligned = table.transpose_to(tuple(block_axes))
        if final is None:
            final = torch.zeros(shape, dtype=torch.float32,
                                device=aligned.counts.device)
        block = aligned.counts.to(final.dtype)
        # expand pinned axes to size 1 for the slice write
        bshape = tuple(v.card if v in block_axes else 1 for v in keep)
        block = block.reshape(bshape)
        idx = tuple(slice(st, st + sh) for st, sh in zip(starts, bshape))
        if disjoint_blocks:
            final[idx] = block
        else:
            final[idx] += block

    bp = _butterfly_plan(point, keep) if use_butterfly else None
    if bp is not None:
        # stack Y[c in {*,T}^k] = ct_+(T-set of c), butterfly to {F,T}^k;
        # with no edge axes the complete table IS the transform output, up
        # to axis order.
        fn = mobius_fn or superset_mobius
        stack = _butterfly_stack(point, bp, provider)
        final = _butterfly_finalise(bp, fn(stack, bp.k)).counts
    else:
        for r_bits in itertools.product((0, 1), repeat=k):
            A = {r for r, b in zip(effective, r_bits) if b == 1}
            B = [r for r in effective if r not in A]
            axes_A = kept_attrs + tuple(
                v for r in sorted(A) for v in kept_edges.get(r, ()))
            acc: Optional[torch.Tensor] = None
            for j in range(len(B) + 1):
                for S in itertools.combinations(B, j):
                    t = _pattern_table(point, A | set(S), axes_A, provider)
                    contrib = t.transpose_to(axes_A).counts
                    sign = -1.0 if j % 2 else 1.0
                    acc = contrib * sign if acc is None else acc + sign * contrib
            assert acc is not None
            embed(A, CtTable(axes_A, acc))

    tab = CtTable(keep, final)
    if stats is not None:
        stats.ct_cells += tab.size
    return tab


def complete_ct_many(queries: Sequence[Tuple[LatticePoint,
                                             Sequence[CtVar]]],
                     provider: PositiveProvider,
                     stats: Optional[CostStats] = None,
                     use_butterfly: bool = True,
                     mobius_fn: Optional[Callable[[torch.Tensor, int],
                                                  torch.Tensor]] = None,
                     mobius_batch_fn: Optional[Callable[
                         [Sequence[torch.Tensor], int],
                         List[torch.Tensor]]] = None,
                     mobius_fused_fn: Optional[Callable[
                         [Sequence[Sequence[torch.Tensor]], int,
                          Tuple[int, ...]],
                         List[torch.Tensor]]] = None) -> List[CtTable]:
    """Complete ct-tables for many ``(point, keep)`` queries, with the
    Möbius negative phase batched across same-shape butterfly stacks.

    Butterfly-eligible queries (no kept edge-attr axes, ``k > 0``) are
    grouped — same-signature families are same-shape by construction —
    and each group runs ONE transform.  With ``mobius_fused_fn`` (normally
    the executor's :meth:`~repro_torch.core.executors.Executor
    .mobius_batch_fused`) the groups are keyed by ``(attr shape, k,
    finalise perm)`` and the *aligned blocks* go straight into the batched
    transform, which also applies the finalise transpose.  Without it,
    stacks are assembled per query and ``mobius_batch_fn`` (normally
    :meth:`~repro_torch.core.executors.Executor.mobius_batch`) transforms
    each ``(stack shape, k)`` group.  Everything else (blockwise queries,
    ``k == 0``) falls back to :func:`complete_ct` per query.

    Args:
        queries: ``(point, keep)`` pairs; ``keep`` may contain attr and
            rind axes of the point (edge-attr axes force the blockwise
            fallback, exactly as in :func:`complete_ct`).
        provider: positive-table source (a policy from
            :mod:`repro_torch.core.engine`).
        stats: optional :class:`~repro_torch.core.contract.CostStats`;
            ``ct_cells`` accounting matches the per-query path.
        use_butterfly / mobius_fn: as for :func:`complete_ct`.
        mobius_batch_fn: batched transform ``(stacks, k) -> [stack]``;
            defaults to :func:`butterfly_batch` over ``mobius_fn``.
        mobius_fused_fn: fused batched transform ``(block_lists, k, perm)
            -> [table tensor]``; preferred over ``mobius_batch_fn`` when
            given.

    Returns:
        One :class:`~repro_torch.core.ct.CtTable` per query, positionally
        aligned with ``queries`` and numerically identical to per-query
        :func:`complete_ct`.

    Usage::

        tabs = complete_ct_many([(point, keep) for keep in keeps], policy,
                                mobius_fused_fn=executor.mobius_batch_fused)
    """
    queries = [(point, tuple(keep)) for point, keep in queries]
    if mobius_batch_fn is None:
        mobius_batch_fn = lambda stacks, k: butterfly_batch(
            stacks, k, mobius_fn)
    results: List[Optional[CtTable]] = [None] * len(queries)
    eligible: List[Tuple[int, _ButterflyPlan, List[torch.Tensor]]] = []
    memo: Dict = {}          # cross-query block reuse within this batch
    for i, (point, keep) in enumerate(queries):
        bp = _butterfly_plan(point, keep) if use_butterfly else None
        if bp is None:
            results[i] = complete_ct(point, keep, provider, stats,
                                     use_butterfly=use_butterfly,
                                     mobius_fn=mobius_fn)
        else:
            eligible.append((i, bp,
                             _butterfly_blocks(point, bp, provider, memo)))
    if mobius_fused_fn is not None:
        groups: Dict[Tuple, List] = {}
        for item in eligible:
            _, bp, _ = item
            attr_shape = tuple(v.card for v in bp.kept_attrs)
            groups.setdefault((attr_shape, bp.k, bp.perm), []).append(item)
        for (_, k, perm), members in groups.items():
            outs = mobius_fused_fn([blks for _, _, blks in members], k,
                                   perm)
            for (i, bp, _), arr in zip(members, outs):
                tab = CtTable(bp.keep, arr)     # already in request layout
                if stats is not None:
                    stats.ct_cells += tab.size
                results[i] = tab
        return results
    groups2: Dict[Tuple, List[Tuple[int, _ButterflyPlan, torch.Tensor]]] = {}
    for i, bp, blks in eligible:
        attr_shape = tuple(v.card for v in bp.kept_attrs)
        stack = torch.stack(blks).reshape((2,) * bp.k + attr_shape)
        groups2.setdefault((tuple(stack.shape), bp.k), []).append(
            (i, bp, stack))
    for (_, k), members in groups2.items():
        outs = mobius_batch_fn([s for _, _, s in members], k)
        for (i, bp, _), out in zip(members, outs):
            tab = _butterfly_finalise(bp, out)
            if stats is not None:
                stats.ct_cells += tab.size
            results[i] = tab
    return results


# --------------------------------------------------------------------------
# delta propagation THROUGH the butterfly: writes stop flushing the
# negative phase
# --------------------------------------------------------------------------

def _butterfly_delta_blocks(point: LatticePoint, bp: _ButterflyPlan,
                            rel: str, provider: PositiveProvider,
                            memo: Dict, zeros: Dict) -> List[torch.Tensor]:
    """Transform-input blocks of the COMPLETE-table *delta* for a write to
    ``rel``, in the same ``{*,T}^k`` corner order as
    :func:`_butterfly_blocks`.

    Each corner's block is the positive table of the sub-pattern with
    corner set ``X`` true, so it depends on ``rel``'s edge table iff
    ``rel in X`` (atoms of other relations never enter the sub-pattern —
    see :func:`_pattern_table`).  Corners without ``rel`` therefore have an
    exactly-zero delta and are explicit zero blocks; corners with ``rel``
    evaluate the SAME pattern assembly against a *delta provider*
    (positives contracted over the
    :meth:`~repro_torch.core.database.FactDelta.as_db` view), which by
    multilinearity yields the exact per-block delta as long as the point
    uses ``rel`` in exactly one atom (callers guard this).

    ``memo``/``zeros`` are shared across a batch of queries: delta blocks
    dedupe by sub-pattern exactly like the full path's blocks, and one
    zero tensor serves every corner of a given ``(attr shape, dtype,
    device)``.
    """
    real: Dict[Tuple[int, ...], torch.Tensor] = {}
    corners = list(itertools.product((0, 1), repeat=bp.k))
    for bits in corners:
        X = {r for r, b in zip(bp.effective, bits) if b == 1}
        if rel not in X:
            continue
        mkey = (tuple(a for a in point.atoms if a.rel in X),
                tuple(point.vars), bp.kept_attrs)
        blk = memo.get(mkey)
        if blk is None:
            t = _pattern_table(point, X, bp.kept_attrs, provider)
            blk = memo[mkey] = t.transpose_to(bp.kept_attrs).counts
        real[bits] = blk
    attr_shape = tuple(v.card for v in bp.kept_attrs)
    like = next(iter(real.values()))
    zkey = (attr_shape, like.dtype, like.device)
    zblk = zeros.get(zkey)
    if zblk is None:
        zblk = zeros[zkey] = torch.zeros(attr_shape, dtype=like.dtype,
                                         device=like.device)
    return [real.get(bits, zblk) for bits in corners]


def _blockwise_ct_delta(point: LatticePoint, keep: Tuple[CtVar, ...],
                        rel: str, provider: PositiveProvider,
                        memo: Dict) -> CtTable:
    """Blockwise complete-table delta for queries the butterfly cannot
    serve (kept edge-attr axes need the N/A-slot block assembly).

    Mirrors :func:`complete_ct`'s blockwise branch, but keeps only the
    inclusion–exclusion terms whose pattern contains ``rel`` — every other
    term is independent of ``rel``'s edge multiset, so its delta is
    exactly zero.  ``provider`` serves delta positives, so the assembled
    tensor is the exact signed-magnitude delta of the resident table;
    callers guard that ``rel`` appears in exactly one atom.  ``memo``
    dedupes pattern tables across a batch of queries, with the same keying
    as :func:`_butterfly_delta_blocks`.
    """
    kept_attrs = tuple(v for v in keep if v.kind == "attr")
    kept_edges: Dict[str, List[CtVar]] = {}
    for v in keep:
        if v.kind == "edge":
            kept_edges.setdefault(v.owner[0], []).append(v)
    kept_rinds = {v.owner[0] for v in keep if v.kind == "rind"}
    effective = sorted(set(kept_edges) | kept_rinds)
    shape = tuple(v.card for v in keep)
    final: Optional[torch.Tensor] = None   # allocated on the blocks' device
    disjoint_blocks = all(v.owner[0] in kept_rinds
                          for v in keep if v.kind == "edge")
    for r_bits in itertools.product((0, 1), repeat=len(effective)):
        A = {r for r, b in zip(effective, r_bits) if b == 1}
        B = [r for r in effective if r not in A]
        axes_A = kept_attrs + tuple(
            v for r in sorted(A) for v in kept_edges.get(r, ()))
        acc: Optional[torch.Tensor] = None
        for j in range(len(B) + 1):
            for S in itertools.combinations(B, j):
                X = A | set(S)
                if rel not in X:
                    continue                  # term independent of rel
                mkey = (tuple(a for a in point.atoms if a.rel in X),
                        tuple(point.vars), axes_A)
                blk = memo.get(mkey)
                if blk is None:
                    t = _pattern_table(point, X, axes_A, provider)
                    blk = memo[mkey] = t.transpose_to(axes_A).counts
                sign = -1.0 if j % 2 else 1.0
                acc = blk * sign if acc is None else acc + sign * blk
        if acc is None:
            continue                          # block independent of rel
        starts: List[int] = []
        block_axes: List[CtVar] = []
        for v in keep:
            if v.kind == "rind":
                starts.append(1 if v.owner[0] in A else 0)
            elif v.kind == "edge" and v.owner[0] not in A:
                starts.append(v.card - 1)     # N/A slot
            else:
                starts.append(0)
                block_axes.append(v)
        aligned = CtTable(axes_A, acc).transpose_to(tuple(block_axes))
        if final is None:
            final = torch.zeros(shape, dtype=torch.float32,
                                device=aligned.counts.device)
        bshape = tuple(v.card if v in block_axes else 1 for v in keep)
        block = aligned.counts.to(final.dtype).reshape(bshape)
        idx = tuple(slice(s, s + sh) for s, sh in zip(starts, bshape))
        if disjoint_blocks:
            final[idx] = block
        else:
            final[idx] += block
    assert final is not None, "rel is in no term: the caller's guard failed"
    return CtTable(keep, final)


def complete_ct_delta_many(queries: Sequence[Tuple[LatticePoint,
                                                   Sequence[CtVar]]],
                           rel: str,
                           provider: PositiveProvider,
                           stats: Optional[CostStats] = None,
                           mobius_fn: Optional[Callable[
                               [torch.Tensor, int], torch.Tensor]] = None,
                           mobius_batch_fn: Optional[Callable[
                               [Sequence[torch.Tensor], int],
                               List[torch.Tensor]]] = None,
                           mobius_fused_fn: Optional[Callable[
                               [Sequence[Sequence[torch.Tensor]], int,
                                Tuple[int, ...]],
                               List[torch.Tensor]]] = None
                           ) -> List[Tuple[str, Optional[CtTable]]]:
    """Delta tables for many resident complete-CT queries after a write to
    ``rel``, with the negative phase batched exactly like
    :func:`complete_ct_many`.

    The Möbius transform is linear in its input blocks, so the delta of a
    complete table is the transform of the per-block deltas — no resident
    data is re-read and no full butterfly recompute happens.  ``provider``
    must serve *delta* positives: contractions over the
    :meth:`~repro_torch.core.database.FactDelta.as_db` view, so that (by
    multilinearity of positive counts in each relation's edge multiset)
    each affected block's delta is exact; the engine adds
    ``delta.sign * result`` onto the resident table.  With
    ``mobius_fused_fn`` (the executor's
    :meth:`~repro_torch.core.executors.Executor.mobius_batch_fused`) each
    ``(shape, perm)`` group is one K3 launch on the card.

    Args:
        queries: ``(point, keep)`` pairs for the RESIDENT entries being
            maintained.
        rel: the relationship the delta wrote.
        provider: delta-positive source (full-valued ``hist``; the engine
            wraps its executor in a view-backed provider).
        stats / mobius_fn / mobius_batch_fn / mobius_fused_fn: as for
            :func:`complete_ct_many`.

    Returns:
        One ``(status, table)`` per query, positionally aligned:

        * ``("delta", ct)`` — ``ct`` is the exact signed-magnitude delta in
          request axis order; add ``sign * ct`` to the resident table;
        * ``("zero", None)`` — the entry provably does not depend on
          ``rel``'s edges (indicator summed out): retain unchanged;
        * ``("fallback", None)`` — not delta-propagatable: ``rel``
          appears in more than one atom, where the delta view
          under-counts cross terms; the caller invalidates.
          (Kept edge-attr axes take the blockwise N/A-slot assembly
          instead of the transform — :func:`_blockwise_ct_delta` — but
          still yield ``"delta"``.)

    Usage::

        outs = complete_ct_delta_many(queries, delta.rel, delta_provider,
                                      mobius_fused_fn=ex.mobius_batch_fused)
    """
    queries = [(point, tuple(keep)) for point, keep in queries]
    if mobius_batch_fn is None:
        mobius_batch_fn = lambda stacks, k: butterfly_batch(
            stacks, k, mobius_fn)
    results: List[Tuple[str, Optional[CtTable]]] = \
        [("fallback", None)] * len(queries)
    eligible: List[Tuple[int, _ButterflyPlan, List[torch.Tensor]]] = []
    memo: Dict = {}
    zeros: Dict = {}
    for i, (point, keep) in enumerate(queries):
        bp = _butterfly_plan(point, keep)
        effective = bp.effective if bp is not None else tuple(
            {v.owner[0] for v in keep if v.kind in ("edge", "rind")})
        if rel not in effective:
            # rel's indicator is summed out (or rel is not in the pattern
            # at all): every transform block is independent of rel's edge
            # table, so the resident value is already exact
            results[i] = ("zero", None)
            continue
        if sum(1 for a in point.atoms if a.rel == rel) != 1:
            continue                          # cross terms: fallback
        if bp is None:
            # kept edge-attr axes: same linearity, blockwise assembly
            tab = _blockwise_ct_delta(point, keep, rel, provider, memo)
            if stats is not None:
                stats.ct_cells += tab.size
            results[i] = ("delta", tab)
            continue
        eligible.append((i, bp, _butterfly_delta_blocks(
            point, bp, rel, provider, memo, zeros)))
    if mobius_fused_fn is not None:
        groups: Dict[Tuple, List] = {}
        for item in eligible:
            _, bp, _ = item
            attr_shape = tuple(v.card for v in bp.kept_attrs)
            groups.setdefault((attr_shape, bp.k, bp.perm), []).append(item)
        for (_, k, perm), members in groups.items():
            outs = mobius_fused_fn([blks for _, _, blks in members], k,
                                   perm)
            for (i, bp, _), arr in zip(members, outs):
                tab = CtTable(bp.keep, arr)   # already in request layout
                if stats is not None:
                    stats.ct_cells += tab.size
                results[i] = ("delta", tab)
        return results
    groups2: Dict[Tuple, List[Tuple[int, _ButterflyPlan, torch.Tensor]]] = {}
    for i, bp, blks in eligible:
        attr_shape = tuple(v.card for v in bp.kept_attrs)
        stack = torch.stack(blks).reshape((2,) * bp.k + attr_shape)
        groups2.setdefault((tuple(stack.shape), bp.k), []).append(
            (i, bp, stack))
    for (_, k), members in groups2.items():
        outs = mobius_batch_fn([s for _, _, s in members], k)
        for (i, bp, _), out in zip(members, outs):
            tab = _butterfly_finalise(bp, out)
            if stats is not None:
                stats.ct_cells += tab.size
            results[i] = ("delta", tab)
    return results


def butterfly_delta(point: LatticePoint, keep: Sequence[CtVar], rel: str,
                    provider: PositiveProvider,
                    stats: Optional[CostStats] = None,
                    mobius_fn: Optional[Callable[[torch.Tensor, int],
                                                 torch.Tensor]] = None
                    ) -> Tuple[str, Optional[CtTable]]:
    """Single-query convenience over :func:`complete_ct_delta_many` — the
    ``(status, delta table)`` for one resident complete-CT entry after a
    write to ``rel``."""
    return complete_ct_delta_many([(point, keep)], rel, provider, stats,
                                  mobius_fn=mobius_fn)[0]
