"""Executors: pluggable backends that evaluate contraction plans.

The planner (:mod:`repro_torch.core.plan`) fixes the traversal; an executor
picks the message representation:

* :class:`DenseExecutor` — the one-hot path: per-variable one-hot attribute
  encodings, per-relationship ``gather → (outer) multiply → segment-sum``
  hops, chunked Khatri-Rao reduction at the root.  Every hop costs
  O(edges × D) multiply-accumulates and materialises (n, D) messages.

* :class:`SparseExecutor` — the code path: attribute combinations are
  mixed-radix ``int32`` codes, never one-hot.  A leaf hop is a single
  segment sum of ones over flattened ``(parent, code)`` keys — O(nnz)
  scatter-adds over the raw edge list with no per-entity one-hot
  materialisation — and the root combine segment-sums child messages by the
  root's own code.  Positive ct-tables therefore scale in ``nnz`` rather
  than ``entities × D``, which is what makes the paper's
  VisualGenome-scale configuration reachable.

Both executors expose the same interface (``positive`` / ``hist`` /
``leaf_hop`` / ``root_reduce`` / ``mobius``) so strategies, the Möbius join
and the tuple-ID variant are executor-agnostic.  Every segment sum goes
through :func:`repro_torch.kernels.ops.segsum_ones` (K1) or
:func:`~repro_torch.kernels.ops.segsum_rows` (K2), and the negative-phase
step through :func:`~repro_torch.kernels.ops.mobius` (K3): the CUDA kernels
for tensors on the card, their plain versions on the host.

Database arrays stay on the host as numpy; each hop moves the index and
code arrays it needs to the executor's ``device``.

:meth:`Executor.positive_batch` evaluates many plans at once.  Plans with
equal :func:`plan_stack_key` run the same operations on arrays of the same
sizes; the JAX package stacks their input packs and ``vmap``s one traced
evaluator.  The port's kernels are ``ctypes`` calls on raw pointers, which
``torch.func.vmap`` cannot trace, so a group is evaluated as ONE problem
instead: each plan's index and code arithmetic runs on the host as it does
for one plan, plan ``i``'s segment ids are offset by ``i`` segment spaces
and its gathers by ``i`` entity tables, and each hop step of the whole
group is one K1 or K2 launch whose result splits into per-plan tables.
:meth:`Executor.positive` is the group of one.  Counts are integers below
2^24, so the tables equal the one-plan tables bit for bit.

Each plan of a group reads its own database, so the group may span many
databases of one schema and one size: the tenants of a registry
(:meth:`Executor.positive_batch_multi`) or the shards of a router
(:meth:`Executor.positive_stacked_merged`, which also sums the shards'
tables).  :meth:`Executor.positive_fanout_merged` instead evaluates a
fan-out flood once on the shards' edge tables laid end to end
(:func:`~repro_torch.core.database.fanout_view`), which is the merged
answer itself.  The JAX package's padded input packs (``plan_input_arrays``,
``_ArrayCursor``, ``fanout_input_arrays``) have no counterpart: a group
here needs no equal-length arrays.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..obs.trace import NULL_TRACER
from .contract import CostStats, _khatri_rao_reduce, _onehot
from .ct import CtTable, sum_partials
from .database import RelationalDB, fanout_view
from .device import resolve_device
from .plan import ContractionPlan, FactorSpec, HopSpec, NodeSpec
from .variables import Atom, CtVar, Var

_MAX_CHUNK_CELLS = 32_000_000
_INT32_LIMIT = 2 ** 31 - 1


def project_columns(m: torch.Tensor, mvars: Tuple[CtVar, ...],
                    keep: Sequence[CtVar]
                    ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
    """Marginalise the column axes of an entity-indexed message matrix
    ``(n, prod cards(mvars))`` onto the vars present in ``keep``."""
    want = tuple(v for v in mvars if v in keep)
    if want == tuple(mvars):
        return m, tuple(mvars)
    wide = m.reshape((m.shape[0],) + tuple(v.card for v in mvars))
    dropped = tuple(i + 1 for i, v in enumerate(mvars) if v not in keep)
    if dropped:
        wide = torch.sum(wide, dim=dropped)
    return wide.reshape(m.shape[0], -1), want


def _finalise(flat: torch.Tensor, mvars: Sequence[CtVar],
              keep: Sequence[CtVar], stats: Optional[CostStats]) -> CtTable:
    mvars = tuple(mvars)
    counts = flat.reshape(tuple(v.card for v in mvars)) if mvars \
        else flat.reshape(())
    tab = CtTable(mvars, counts)
    order = tuple(v for v in keep if v in tab.vars)
    if order != tab.vars:
        tab = tab.transpose_to(order)
    if stats is not None:
        stats.ct_cells += tab.size
    return tab


def _host_to(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """An ``int32`` index/code array moved to ``device``."""
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int32)).to(
        device)


class Executor:
    """Backend interface: evaluate plans against a database on ``device``
    (``None`` = the CUDA card)."""

    name = "base"

    def __init__(self, dtype=torch.float32, mobius_fn=None, device=None):
        self.dtype = dtype
        self.device = resolve_device(device)
        self._mobius_fn = mobius_fn
        # request tracer for dispatch spans (NULL_TRACER is free)
        self.tracer = NULL_TRACER

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """:func:`_host_to` this executor's device, as an ``exec.upload``
        span (``bytes``)."""
        with self.tracer.span("exec.upload") as sp:
            if self.tracer.enabled:
                sp.set(bytes=4 * int(np.size(arr)))
            return _host_to(arr, self.device)

    # -- negative phase -----------------------------------------------------
    def mobius(self, stack: torch.Tensor, k: int) -> torch.Tensor:
        """Superset Möbius transform over the leading ``k`` binary axes —
        the Möbius join's butterfly step (K3 on the card)."""
        if self._mobius_fn is not None:
            return self._mobius_fn(stack, k)
        shape = tuple(stack.shape)
        d = int(np.prod(shape[k:], dtype=np.int64))
        x = stack.reshape(1, 1 << k, d).contiguous()
        return ops.mobius(x).reshape(shape)

    def mobius_batch(self, stacks: Sequence[torch.Tensor],
                     k: int) -> List[torch.Tensor]:
        """Batched negative phase: one transform over MANY same-shape
        butterfly stacks, stacked along a leading batch axis.  Results are
        bit-identical to per-stack :meth:`mobius` (the transform is
        elementwise across the batch axis).

        Args:
            stacks: same-shape tensors, each ``(2,)*k + attr_shape``.
            k: number of leading indicator axes.

        Returns:
            One transformed tensor per input, in input order.

        Usage::

            outs = executor.mobius_batch(stacks, k)
        """
        stacks = list(stacks)
        if not stacks:
            return []
        if len(stacks) == 1 or self._mobius_fn is not None:
            return [self.mobius(s, k) for s in stacks]
        shape = tuple(stacks[0].shape)
        b = len(stacks)
        d = int(np.prod(shape[k:], dtype=np.int64))
        with self.tracer.span("exec.mobius_batch", stacks=b, k=k):
            out = ops.mobius(torch.stack(stacks).reshape(b, 1 << k, d))
        return list(out.reshape((b,) + shape).unbind(0))

    def mobius_batch_fused(self, block_lists: Sequence[Sequence[torch.Tensor]],
                           k: int, perm: Tuple[int, ...]
                           ) -> List[torch.Tensor]:
        """Batched negative phase from raw blocks: butterfly-stack
        assembly, superset transform and the finalise transpose for many
        same-shape queries, with ONE transform launch per ``(shape, perm)``
        group.  The blocks of all queries are stacked straight into the
        kernel's ``[B, 2^k, D]`` layout (batch first), so no transpose
        surrounds the transform.  Results are bit-identical to per-query
        :meth:`mobius` (same subtractions, same order).

        Args:
            block_lists: one sequence of ``2**k`` aligned blocks per
                query, each of the same attr shape, in the
                ``itertools.product((0, 1), repeat=k)`` order the
                butterfly stack is built in.
            k: number of leading indicator axes.
            perm: the finalise transpose from transform layout
                (``(2,)*k`` + attr axes) to request layout — shared by
                the whole group.

        Returns:
            One complete-table tensor per query (request layout), in
            input order.

        Usage::

            outs = executor.mobius_batch_fused(blocks, k, bp.perm)
        """
        block_lists = [list(bs) for bs in block_lists]
        if not block_lists:
            return []
        attr_shape = tuple(block_lists[0][0].shape)
        b = len(block_lists)
        d = int(np.prod(attr_shape, dtype=np.int64))
        flat = [blk for bs in block_lists for blk in bs]
        with self.tracer.span("exec.mobius_batch_fused", stacks=b, k=k):
            x = torch.stack(flat).reshape(b, 1 << k, d)
            if self._mobius_fn is not None:
                y = torch.stack([self._mobius_fn(
                    x[i].reshape((2,) * k + attr_shape), k)
                    for i in range(b)])
            else:
                y = ops.mobius(x)
            y = y.reshape((b,) + (2,) * k + attr_shape)
            tperm = (0,) + tuple(p + 1 for p in perm)
            if tperm != tuple(range(len(tperm))):
                y = y.permute(tperm)
        return list(y.unbind(0))

    def local_mode(self):
        """Context for tiny side computations — the engine's delta count
        maintenance runs its delta-edge contractions inside it.  The
        single-device executors are already local (a no-op); a sharded
        backend would drop to its single-device primitives here, so that a
        handful of delta edges never pays collectives."""
        return nullcontext()

    # -- positive phase -----------------------------------------------------
    def positive(self, db: RelationalDB, plan: ContractionPlan,
                 stats: Optional[CostStats] = None) -> CtTable:
        """Evaluate a compiled plan: one message per root hop, then the
        root combine (the one-plan case of :meth:`positive_batch`)."""
        return self._evaluate([db], [plan], [stats])[0]

    def positive_batch(self, db: RelationalDB,
                       plans: Sequence[ContractionPlan],
                       stats: Optional[CostStats] = None) -> List[CtTable]:
        """Evaluate many compiled plans at once.

        Plans whose computations are structurally identical (equal
        :func:`plan_stack_key` — same hop-tree topology, entity sizes,
        bucketed edge counts and axis cards) are evaluated together, one
        kernel launch per hop step for the whole group, in the largest
        sub-batches whose segment spaces, laid end to end, fit int32 (one
        plan over it raises ``OverflowError`` as :meth:`positive` does).

        Args:
            db: the database the plans were compiled against.
            plans: compiled :class:`~repro_torch.core.plan.ContractionPlan`
                sequence (any mix of signatures).
            stats: optional :class:`~repro_torch.core.contract.CostStats`;
                join, row and cell accounting matches the unbatched path
                exactly.

        Returns:
            One :class:`~repro_torch.core.ct.CtTable` per plan, positionally
            aligned with ``plans`` and bit-identical to the unbatched path
            (counts are integers below 2^24, so the reordered sums are
            exact).

        Usage::

            tabs = executor.positive_batch(db, plans)
        """
        return self._batched([db] * len(plans), plans,
                             [stats] * len(plans), "exec.positive_batch")

    def _batched(self, dbs: Sequence[RelationalDB],
                 plans: Sequence[ContractionPlan],
                 stats: Sequence[Optional[CostStats]],
                 span: str) -> List[CtTable]:
        """Group ``(dbs[i], plans[i])`` items by :func:`plan_stack_key` and
        evaluate each group in int32-sized sub-batches (see
        :meth:`positive_batch`); one table per item, in input order."""
        results: List[Optional[CtTable]] = [None] * len(plans)
        groups: dict = {}
        for i, (db, plan) in enumerate(zip(dbs, plans)):
            groups.setdefault(plan_stack_key(db, plan), []).append(i)
        for idxs in groups.values():
            per = max(1, _INT32_LIMIT
                      // self._stack_space(dbs[idxs[0]], plans[idxs[0]]))
            for lo in range(0, len(idxs), per):
                part = idxs[lo:lo + per]
                with self.tracer.span(span, plans=len(part)):
                    tabs = self._evaluate([dbs[i] for i in part],
                                          [plans[i] for i in part],
                                          [stats[i] for i in part])
                for i, tab in zip(part, tabs):
                    results[i] = tab
        return results                                     # type: ignore

    def _evaluate(self, dbs: Sequence[RelationalDB],
                  plans: Sequence[ContractionPlan],
                  stats: Sequence[Optional[CostStats]]) -> List[CtTable]:
        """Stack-compatible plans as one problem, plan ``i`` against
        ``dbs[i]`` (whose entity sizes the stack key holds equal): each
        root hop of the whole group is one message matrix (plan ``i``'s
        entity rows ``i`` tables down), then one root combine; one table
        per plan, with plan ``i``'s joins, rows and cells in
        ``stats[i]``."""
        roots = [p.root for p in plans]
        factors = [self._hop_group(dbs, [r.hops[j] for r in roots], stats)
                   for j in range(len(roots[0].hops))]
        return self._root(dbs, [r.own for r in roots], factors,
                          [p.keep for p in plans], stats)

    # -- many databases -----------------------------------------------------
    def positive_batch_multi(self, dbs: Sequence[RelationalDB],
                             plans: Sequence[ContractionPlan],
                             stats_list: Optional[Sequence[
                                 Optional[CostStats]]] = None
                             ) -> List[CtTable]:
        """:meth:`positive_batch` across MANY databases: item ``i`` is
        ``plans[i]`` evaluated against ``dbs[i]``.

        The stack key holds the entity sizes, topology, cards and
        bucketed edge counts a group shares; each plan's index and code
        arrays come from its own database, laid end to end as the group's
        plans' are.  So same-shape plans of *different* databases — the
        tenants of one registry, the shards of one router — share one
        K1/K2 launch per hop step.

        Args:
            dbs: one database per plan (repeats allowed and common).
            plans: compiled plans, positionally paired with ``dbs``.
            stats_list: optional per-item
                :class:`~repro_torch.core.contract.CostStats` (typically
                each tenant engine's); accounting matches each database
                running its own plans.

        Returns:
            One :class:`~repro_torch.core.ct.CtTable` per item, in input
            order, bit-identical to evaluating each ``(db, plan)`` pair
            alone (integer counts below 2^24).

        Usage::

            tabs = executor.positive_batch_multi(dbs, plans)
        """
        stats = (list(stats_list) if stats_list is not None
                 else [None] * len(plans))
        return self._batched(list(dbs), list(plans), stats,
                             "exec.positive_batch_multi")

    def positive_stacked_merged(self, dbs: Sequence[RelationalDB],
                                plans: Sequence[ContractionPlan],
                                stats_list: Optional[Sequence[
                                    Optional[CostStats]]] = None
                                ) -> Tuple[List[List[CtTable]],
                                           List[CtTable]]:
        """A whole cross-shard flood group at once: every shard's plans
        in one :meth:`positive_batch_multi` evaluation (shard-major), and
        the per-plan tables summed over the shards (one stacked sum per
        table shape) — the per-shard tables for the shard services'
        caches and the merged tables for the router, from one call.

        The caller (``CountingRouter._flush_fused``) pre-checks that the
        SAME plan objects run on every shard with equal
        :func:`plan_stack_key` (entity tables are replicated and edge
        counts bucket alike, so this is the common case).

        Returns:
            ``(per_shard, merged)`` — ``per_shard[s][q]`` is shard ``s``'s
            table for plan ``q``; ``merged[q]`` is their exact sum.
        """
        dbs, plans = list(dbs), list(plans)
        n, m = len(dbs), len(plans)
        stats = (list(stats_list) if stats_list is not None
                 else [None] * n)
        tabs = self.positive_batch_multi(
            [db for db in dbs for _ in plans], plans * n,
            [st for st in stats for _ in plans])
        per_shard = [tabs[s * m:(s + 1) * m] for s in range(n)]
        merged, _ = sum_partials([[per_shard[s][q] for s in range(n)]
                                  for q in range(m)])
        return per_shard, merged

    def positive_fanout_merged(self, dbs: Sequence[RelationalDB],
                               plans: Sequence[ContractionPlan],
                               partitioned: frozenset,
                               stats_list: Optional[Sequence[
                                   Optional[CostStats]]] = None
                               ) -> List[CtTable]:
        """Merged fan-out tables at SINGLE-DATABASE cost: the shards' edge
        tables are reassembled into one view of the unsharded database
        (:func:`~repro_torch.core.database.fanout_view`: partitioned
        relationships concatenated, everything else shard 0's, no copy)
        and the plans are evaluated once on it — the answer IS the merged
        table, by the same argument that makes the fan-out sum exact
        (every partitioned edge lives on exactly one shard; replicated
        tables are the same on every shard).

        The caller pre-checks a routable fan-out group (equal
        :func:`fanout_stack_key`).  Joins and rows are accounted per shard
        in ``stats_list``, cells in the first.

        Returns:
            One merged :class:`~repro_torch.core.ct.CtTable` per plan.
        """
        dbs, plans = list(dbs), list(plans)
        view = fanout_view(dbs, partitioned)
        tabs = self._batched([view] * len(plans), plans,
                             [None] * len(plans), "exec.positive_fanout")
        if stats_list:
            for db, st in zip(dbs, stats_list):
                if st is not None:
                    for p in plans:
                        _count_plan_joins(db, p, st)
            if stats_list[0] is not None:
                stats_list[0].ct_cells += sum(t.size for t in tabs)
        return tabs

    def _hop_group(self, dbs: Sequence[RelationalDB],
                   hops: Sequence[HopSpec],
                   stats: Sequence[Optional[CostStats]]
                   ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        """The messages ``(b * n_parent, D)`` of ``b`` aligned hops (rows
        plan-major, hop ``i`` over ``dbs[i]``), each including its child's
        entire subtree, with each plan's column vars."""
        raise NotImplementedError

    def _root(self, dbs: Sequence[RelationalDB], owns: Sequence[FactorSpec],
              factors: Sequence[Tuple[torch.Tensor,
                                      List[Tuple[CtVar, ...]]]],
              keeps: Sequence[Sequence[CtVar]],
              stats: Sequence[Optional[CostStats]]) -> List[CtTable]:
        """Combine ``b`` aligned root variables' own attributes with
        factor matrices ``(b * n_root, D_i)`` (each with its per-plan
        vars) into one ct-table per plan."""
        raise NotImplementedError

    def _stack_space(self, db: RelationalDB, plan: ContractionPlan) -> int:
        """The largest index space one plan's evaluation addresses; a
        group of ``b`` plans addresses ``b`` times it."""
        raise NotImplementedError

    def hop_message(self, db: RelationalDB, hop: HopSpec,
                    stats: Optional[CostStats] = None
                    ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        """Full message matrix ``(n_parent, D)`` of one root-adjacent hop,
        including the child's entire subtree."""
        m, mvars = self._hop_group([db], [hop], [stats])
        return m, mvars[0]

    def hist(self, db: RelationalDB, var: Var, attrs: Tuple[CtVar, ...],
             stats: Optional[CostStats] = None) -> CtTable:
        raise NotImplementedError

    def leaf_hop(self, db: RelationalDB, atom: Atom, child: Var, parent: Var,
                 child_attrs: Tuple[CtVar, ...],
                 edge_attrs: Tuple[CtVar, ...],
                 stats: Optional[CostStats] = None
                 ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        """Message matrix ``(n_parent, D)`` a bare child variable sends
        through one relationship — the tuple-ID precompute primitive."""
        fs = FactorSpec(child, tuple(child_attrs))
        leaf = NodeSpec(fs, (), fs.attrs)
        hop = HopSpec(atom, child, parent, tuple(edge_attrs), leaf,
                      fs.attrs + tuple(edge_attrs))
        return self.hop_message(db, hop, stats)

    def root_reduce(self, db: RelationalDB, own: FactorSpec,
                    factors: Sequence[Tuple[torch.Tensor, Tuple[CtVar, ...]]],
                    keep: Sequence[CtVar],
                    stats: Optional[CostStats] = None) -> CtTable:
        """Combine the root variable's own attributes with entity-indexed
        factor matrices ``(n_root, D_i)`` into a ct-table."""
        return self._root([db], [own],
                          [(m, [tuple(vs)]) for m, vs in factors],
                          [keep], [stats])[0]


# ---------------------------------------------------------------------------
# shared edge-list bookkeeping
# ---------------------------------------------------------------------------

def _hop_indices(db: RelationalDB, atom: Atom, child: Var, parent: Var):
    rt = db.relations[atom.rel]
    if child == atom.src and parent == atom.dst:
        return rt, rt.src, rt.dst, db.entities[atom.dst.etype].size
    if child == atom.dst and parent == atom.src:
        return rt, rt.dst, rt.src, db.entities[atom.src.etype].size
    raise AssertionError("atom does not connect child/parent")


# ---------------------------------------------------------------------------
# stack groups: plans that run the same operations on same-size arrays
# ---------------------------------------------------------------------------

def _edge_bucket(n: int) -> int:
    """Bucketed edge-array length: the next power of two at or above
    ``n`` (floor 16), so that plans with nearby edge counts share a stack
    key."""
    if n <= 0:
        return 0
    return max(16, 1 << max(n - 1, 0).bit_length())


def plan_stack_key(db: RelationalDB, plan: ContractionPlan) -> Tuple:
    """Stacked-execution key, equal to the JAX package's: plans with equal
    keys against the same database run the same operation sequence on
    arrays of the same sizes (hop-tree topology + entity sizes + bucketed
    edge counts + axis cards), so they are evaluated as one group.  Edge
    counts are bucketed (:func:`_edge_bucket`) as in the JAX package,
    whose stacked packs must have equal shapes; the port lays the group's
    edge lists end to end and pads nothing."""
    def node(n: NodeSpec) -> Tuple:
        hops = []
        for h in n.hops:
            _, g, _, n_parent = _hop_indices(db, h.atom, h.child, h.parent)
            hops.append((_edge_bucket(int(np.asarray(g).shape[0])), n_parent,
                         tuple(cv.card for cv in h.edge_attrs),
                         node(h.child_node)))
        return (db.entities[n.var.etype].size,
                tuple(cv.card for cv in n.own.attrs), tuple(hops))
    return node(plan.root)


def _end_to_end(arrs: Sequence[np.ndarray], step: int = 0) -> np.ndarray:
    """Plans' int32 host arrays laid end to end as one array, plan ``i``'s
    indices raised by ``i * step`` (into the ``i``-th of the group's index
    spaces); one plan's array as it is."""
    if len(arrs) == 1:
        return np.asarray(arrs[0])
    out = np.empty(sum(len(a) for a in arrs), dtype=np.int32)
    off = 0
    for i, a in enumerate(arrs):
        np.add(a, i * step, out=out[off:off + len(a)], casting="unsafe")
        off += len(a)
    return out


def _rows(flat: torch.Tensor, b: int) -> List[torch.Tensor]:
    """A group's flat result split into its ``b`` plans' results.  A
    group's rows are copies, so that each plan's table owns its storage as
    a one-plan table does (a cached table must not pin its group's)."""
    rows = list(flat.reshape(b, -1).unbind(0))
    return rows if b == 1 else [r.clone() for r in rows]


def fanout_stack_key(dbs: Sequence[RelationalDB], plan: ContractionPlan,
                     partitioned: frozenset) -> Tuple:
    """Stacking key of a plan's reassembled fan-out evaluation
    (:func:`~repro_torch.core.database.fanout_view`), equal to the JAX
    package's: :func:`plan_stack_key` with each partitioned
    relationship's edge length the SUM of the shards' bucketed lengths.
    Shards bucket their edge counts apart, so one plan's per-shard keys
    may differ; this key is one per plan, and plans with equal keys share
    one fan-out evaluation."""
    def node(n: NodeSpec) -> Tuple:
        hops = []
        for h in n.hops:
            lens = []
            for db in dbs:
                _, g, _, n_parent = _hop_indices(db, h.atom, h.child,
                                                 h.parent)
                lens.append(_edge_bucket(int(np.asarray(g).shape[0])))
            length = sum(lens) if h.atom.rel in partitioned else lens[0]
            hops.append((length, n_parent,
                         tuple(cv.card for cv in h.edge_attrs),
                         node(h.child_node)))
        return (dbs[0].entities[n.var.etype].size,
                tuple(cv.card for cv in n.own.attrs), tuple(hops))
    return node(plan.root)


def _count_plan_joins(db: RelationalDB, plan: ContractionPlan,
                      stats: CostStats) -> None:
    """The per-hop join and row accounting of evaluating ``plan`` on
    ``db``, without evaluating it."""
    def node(n: NodeSpec) -> None:
        for h in n.hops:
            node(h.child_node)
            _, g, _, _ = _hop_indices(db, h.atom, h.child, h.parent)
            stats.joins += 1
            stats.rows_scanned += int(np.asarray(g).shape[0])
    node(plan.root)


# ---------------------------------------------------------------------------
# dense executor (one-hot contraction)
# ---------------------------------------------------------------------------

def gather_hop(child: torch.Tensor, gidx: torch.Tensor, sidx: torch.Tensor,
               cols: Sequence[torch.Tensor], cards: Sequence[int],
               total: int, w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A dense hop on its device: the child message's rows gathered by
    edge (times the edge weights ``w``, if given), expanded by each edge
    attribute's one-hot (card+1, NA empty), then K2 into ``total`` parent
    segments."""
    m = child[gidx.long()]                                    # (edges, D)
    if w is not None:
        m = m * w[:, None]
    for col, card in zip(cols, cards):
        hot = _onehot(col, card, m.dtype)
        n, d = m.shape
        m = (m[:, :, None] * hot[:, None, :]).reshape(n, d * card)
    return ops.segsum_rows(sidx, m.contiguous(), total)


class DenseExecutor(Executor):
    name = "dense"

    def _entity_factor(self, dbs: Sequence[RelationalDB],
                       fss: Sequence[FactorSpec]
                       ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        """The one-hot attribute message ``(b * n, prod cards)`` of ``b``
        aligned entity factors (factor ``i`` over ``dbs[i]``), rows
        plan-major."""
        n = dbs[0].entities[fss[0].var.etype].size
        msg = torch.ones((len(fss) * n, 1), dtype=self.dtype,
                         device=self.device)
        for k, cv in enumerate(fss[0].attrs):
            col = _end_to_end([np.asarray(db.entities[fs.var.etype].attrs[
                fs.attrs[k].owner[1]]) for db, fs in zip(dbs, fss)])
            hot = _onehot(self._upload(col), cv.card, self.dtype)
            nn, d = msg.shape
            msg = (msg[:, :, None] * hot[:, None, :]).reshape(nn, d * cv.card)
        return msg, [tuple(fs.attrs) for fs in fss]

    def _hop(self, dbs: Sequence[RelationalDB], hops: Sequence[HopSpec],
             child_msg: torch.Tensor,
             child_vars: Sequence[Tuple[CtVar, ...]],
             stats: Sequence[Optional[CostStats]]
             ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        tracer = self.tracer
        with tracer.span("exec.hop") as span:
            with tracer.span("exec.host_ids") as ids:
                idx = [_hop_indices(db, h.atom, h.child, h.parent)
                       for db, h in zip(dbs, hops)]
                n_parent = idx[0][3]
                for st, (_, g, _, _) in zip(stats, idx):
                    if st is not None:
                        st.joins += 1
                        st.rows_scanned += int(np.asarray(g).shape[0])
                # plan i reads the i-th child table and writes the i-th
                # parent one
                gathers = _end_to_end([g for _, g, _, _ in idx],
                                      dbs[0].entities[
                                          hops[0].child.etype].size)
                cols = [_end_to_end([np.asarray(rt.attrs[
                    h.edge_attrs[k].owner[1]])
                    for h, (rt, _, _, _) in zip(hops, idx)])
                    for k in range(len(hops[0].edge_attrs))]
                scatters = _end_to_end([s for _, _, s, _ in idx], n_parent)
                if tracer.enabled:
                    ids.set(edges=len(gathers))
            cards = [cv.card for cv in hops[0].edge_attrs]
            if tracer.enabled:
                span.set(kernel="K2", edges=len(gathers),
                         segments=len(hops) * n_parent,
                         width=int(child_msg.shape[1] * np.prod(
                             cards, dtype=np.int64)))
            out = self._hop_sum(gathers, scatters, cols, cards, child_msg,
                                len(hops) * n_parent).to(self.dtype)
        return out, [tuple(vs) + tuple(h.edge_attrs)
                     for vs, h in zip(child_vars, hops)]

    def _hop_sum(self, gathers: np.ndarray, scatters: np.ndarray,
                 cols: Sequence[np.ndarray], cards: Sequence[int],
                 child_msg: torch.Tensor, total: int) -> torch.Tensor:
        """The hop's device step (K2): host edge arrays in, the
        ``(total, D)`` parent message out."""
        return gather_hop(child_msg, self._upload(gathers),
                          self._upload(scatters),
                          [self._upload(c) for c in cols], cards, total)

    def _node_message(self, dbs: Sequence[RelationalDB],
                      nodes: Sequence[NodeSpec],
                      stats: Sequence[Optional[CostStats]]
                      ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        msg, mvars = self._entity_factor(dbs, [n.own for n in nodes])
        for j in range(len(nodes[0].hops)):
            h, hvars = self._hop_group(dbs, [n.hops[j] for n in nodes],
                                       stats)
            n, d = msg.shape
            msg = (msg[:, :, None] * h[:, None, :]).reshape(n, d * h.shape[1])
            mvars = [a + b for a, b in zip(mvars, hvars)]
        return msg, mvars

    def _hop_group(self, dbs: Sequence[RelationalDB],
                   hops: Sequence[HopSpec],
                   stats: Sequence[Optional[CostStats]]
                   ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        child_msg, child_vars = self._node_message(
            dbs, [h.child_node for h in hops], stats)
        return self._hop(dbs, hops, child_msg, child_vars, stats)

    def hist(self, db: RelationalDB, var: Var, attrs: Tuple[CtVar, ...],
             stats: Optional[CostStats] = None) -> CtTable:
        msg, (mvars,) = self._entity_factor([db], [FactorSpec(var,
                                                              tuple(attrs))])
        flat = torch.sum(msg, dim=0)
        counts = flat.reshape(tuple(v.card for v in mvars)) if mvars \
            else flat[0]
        return CtTable(mvars, counts)

    def _root(self, dbs: Sequence[RelationalDB], owns: Sequence[FactorSpec],
              factors: Sequence[Tuple[torch.Tensor,
                                      List[Tuple[CtVar, ...]]]],
              keeps: Sequence[Sequence[CtVar]],
              stats: Sequence[Optional[CostStats]]) -> List[CtTable]:
        b = len(owns)
        with self.tracer.span("exec.root") as sp:
            fs = [self._entity_factor(dbs, owns)] + list(factors)
            if self.tracer.enabled:
                sp.set(kernel="matmul", rows=int(fs[0][0].shape[0]))
            # each axis carries its var in every plan, so that the reduce's
            # widest-last reorder applies to all plans at once
            flat, axes = _khatri_rao_reduce(
                [(m, list(zip(*vs))) for m, vs in fs], batch=b)
        return [_finalise(row, tuple(ax[i] for ax in axes), keep, st)
                for i, (row, keep, st) in enumerate(
                    zip(_rows(flat, b), keeps, stats))]

    def _stack_space(self, db: RelationalDB, plan: ContractionPlan) -> int:
        def node(n: NodeSpec) -> int:
            return max([1] + [max(db.entities[h.parent.etype].size,
                                  db.entities[h.child.etype].size,
                                  node(h.child_node)) for h in n.hops])
        return node(plan.root)


# ---------------------------------------------------------------------------
# sparse executor (int32 codes + segment sums over edge lists)
# ---------------------------------------------------------------------------

class _SparseMsg:
    """Per-entity messages of ``b`` aligned nodes: per plan a mixed-radix
    scalar code over its ``svars`` (one value per entity — exact, no
    one-hot), plus an optional dense block ``(b * n, D)`` over each plan's
    ``dvars`` (present only after an aggregation made the distribution
    genuinely multi-valued)."""

    __slots__ = ("codes", "ds", "svars", "dense", "dvars")

    def __init__(self, codes, ds, svars, dense, dvars):
        self.codes, self.ds, self.svars = codes, ds, svars
        self.dense, self.dvars = dense, dvars


def _np_codes(cols: List[np.ndarray], cards: List[int]) -> np.ndarray:
    code = np.zeros(len(cols[0]) if cols else 0, dtype=np.int64)
    for col, card in zip(cols, cards):
        code = code * card + col.astype(np.int64)
    return code


def _kr_segment_sum(code: torch.Tensor, mats: Sequence[torch.Tensor],
                    ds: int, dtype) -> torch.Tensor:
    """Chunked Khatri-Rao expansion + segment-sum accumulation:
    ``out[c, :] = sum_{i: code[i]=c} ⊗_m mats[m][i, :]`` as a ``(ds,
    prod_D)`` table, chunking rows so the expansion never materialises
    more than ``_MAX_CHUNK_CELLS`` cells.  Each chunk is one K2 call that
    adds into the same table."""
    d_prod = int(np.prod([m.shape[1] for m in mats], dtype=np.int64))
    n = int(mats[0].shape[0])
    chunk = max(64, min(max(n, 1), _MAX_CHUNK_CELLS // max(d_prod, 1)))
    out = torch.zeros((ds, d_prod), dtype=torch.float32,
                      device=mats[0].device)
    for s in range(0, n, chunk):
        kr = mats[0][s:s + chunk]
        for m in mats[1:]:
            blk = m[s:s + chunk]
            kr = (kr[:, :, None] * blk[:, None, :]).reshape(kr.shape[0], -1)
        ops.segsum_rows(code[s:s + chunk], kr.contiguous(), ds, out=out)
    return out.to(dtype)


class SparseExecutor(Executor):
    name = "sparse"

    def _entity_code(self, db: RelationalDB, fs: FactorSpec
                     ) -> Tuple[Optional[np.ndarray], int]:
        """Mixed-radix host-side code per entity.  Kept as numpy: codes are
        consumed by host index arithmetic in ``_hop``; only the final
        segment-id array ever moves to the device."""
        if not fs.attrs:
            return None, 1
        tab = db.entities[fs.var.etype]
        cols = [np.asarray(tab.attrs[cv.owner[1]]) for cv in fs.attrs]
        code = _np_codes(cols, [cv.card for cv in fs.attrs])
        return code.astype(np.int32), fs.card

    def _hop(self, dbs: Sequence[RelationalDB], hops: Sequence[HopSpec],
             msg: _SparseMsg, stats: Sequence[Optional[CostStats]]
             ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        """Push ``b`` aligned child messages through one relationship each.
        Scalar-coded axes travel as index arithmetic inside the segment
        ids; only genuinely dense axes (from deeper aggregations) are
        carried as row vectors.  Plan ``i`` (over ``dbs[i]``) scatters into
        the ``i``-th of ``b`` segment spaces laid end to end: one launch for
        the group."""
        tracer = self.tracer
        with tracer.span("exec.hop") as span:
            with tracer.span("exec.host_ids") as ids:
                seg_np, gathers, n_parent, ds, total, out_vars = \
                    self._hop_ids(dbs, hops, msg, stats)
                if tracer.enabled:
                    ids.set(edges=int(seg_np.shape[0]))
            b = len(hops)
            if tracer.enabled:
                span.set(kernel="K1" if msg.dense is None else "K2",
                         edges=int(seg_np.shape[0]), segments=b * total,
                         width=1 if msg.dense is None
                         else int(msg.dense.shape[1]))
            if msg.dense is None:
                flat = self._edge_segment_sum(seg_np, None, b * total)
                return flat.reshape(b * n_parent, ds), out_vars
            rows = msg.dense[self._upload(gathers).long()]
            agg = self._edge_segment_sum(seg_np, rows, b * total)
        return agg.reshape(b * n_parent, ds * msg.dense.shape[1]), out_vars

    def _hop_ids(self, dbs: Sequence[RelationalDB], hops: Sequence[HopSpec],
                 msg: _SparseMsg, stats: Sequence[Optional[CostStats]]):
        """The host's side of :meth:`_hop`: the group's segment ids (one
        int32 array), the dense rows' gather indices (``None`` for a leaf
        hop), the parent count, the per-parent code space and the segment
        space of one plan, and each plan's output vars."""
        idx = [_hop_indices(db, h.atom, h.child, h.parent)
               for db, h in zip(dbs, hops)]
        n_parent = idx[0][3]
        ds = msg.ds
        for cv in hops[0].edge_attrs:
            ds *= cv.card
        total = n_parent * ds
        if total > _INT32_LIMIT:
            raise OverflowError(
                f"sparse hop segment space {total} exceeds int32; use the "
                f"dense executor or reduce kept axes")
        sizes = [int(np.asarray(g).shape[0]) for _, g, _, _ in idx]
        # each plan's ids go straight into its slice of one int32 array:
        # every id is below the group's b * total, which fits int32
        seg_np = np.empty(sum(sizes), dtype=np.int32)
        out_vars: List[Tuple[CtVar, ...]] = []
        off = 0
        for i, (hop, (rt, gather_idx, scatter_idx, _), n) in enumerate(
                zip(hops, idx, sizes)):
            seg = seg_np[off:off + n]
            off += n
            np.multiply(scatter_idx, ds, out=seg, casting="unsafe")
            # per-edge scalar code: child code gathered at the child end of
            # the edge, extended with this relationship's kept edge attrs
            ecode = None if msg.codes[i] is None \
                else msg.codes[i][np.asarray(gather_idx)]
            svars = tuple(msg.svars[i])
            for cv in hop.edge_attrs:
                col = np.asarray(rt.attrs[cv.owner[1]], dtype=np.int32)
                ecode = col if ecode is None else ecode * cv.card + col
                svars = svars + (cv,)
            if ecode is not None:
                seg += ecode
            if i:   # plan i scatters into the i-th of b segment spaces
                seg += i * total
            out_vars.append(svars if msg.dense is None
                            else svars + tuple(msg.dvars[i]))
            if stats[i] is not None:
                stats[i].joins += 1
                stats[i].rows_scanned += n
        gathers = None if msg.dense is None else _end_to_end(
            [g for _, g, _, _ in idx],
            dbs[0].entities[hops[0].child.etype].size)
        return seg_np, gathers, n_parent, ds, total, out_vars

    def _edge_segment_sum(self, seg_np: np.ndarray,
                          rows: Optional[torch.Tensor],
                          total: int) -> torch.Tensor:
        """Device step of one sparse hop: scatter-add per-edge contributions
        into the flattened ``(parent, code)`` segment space.  ``rows`` is
        ``None`` for a leaf hop (each edge contributes 1, K1) or the
        gathered dense block ``(edges, Dd)`` (K2)."""
        seg = self._upload(seg_np)
        if rows is None:
            ones = torch.ones(seg.shape[0], dtype=torch.float32,
                              device=self.device)
            return ops.segsum_ones(seg, ones, total).to(self.dtype)
        return ops.segsum_rows(seg, rows.contiguous(), total).to(self.dtype)

    def _node_message(self, dbs: Sequence[RelationalDB],
                      nodes: Sequence[NodeSpec],
                      stats: Sequence[Optional[CostStats]]) -> _SparseMsg:
        codes = [self._entity_code(db, n.own) for db, n in zip(dbs, nodes)]
        dense: Optional[torch.Tensor] = None
        dvars: List[Tuple[CtVar, ...]] = [() for _ in nodes]
        for j in range(len(nodes[0].hops)):
            h, hvars = self._hop_group(dbs, [n.hops[j] for n in nodes],
                                       stats)
            if dense is None:
                dense, dvars = h, hvars
            else:
                n, d = dense.shape
                dense = (dense[:, :, None] * h[:, None, :]).reshape(
                    n, d * h.shape[1])
                dvars = [a + b for a, b in zip(dvars, hvars)]
        return _SparseMsg([c for c, _ in codes], codes[0][1],
                          [tuple(n.own.attrs) for n in nodes], dense, dvars)

    def _hop_group(self, dbs: Sequence[RelationalDB],
                   hops: Sequence[HopSpec],
                   stats: Sequence[Optional[CostStats]]
                   ) -> Tuple[torch.Tensor, List[Tuple[CtVar, ...]]]:
        child = self._node_message(dbs, [h.child_node for h in hops], stats)
        return self._hop(dbs, hops, child, stats)

    def _ones_segment_sum(self, code: torch.Tensor, ds: int) -> torch.Tensor:
        """Segment sum of ones — the histogram primitive (K1)."""
        ones = torch.ones(code.shape[0], dtype=torch.float32,
                          device=self.device)
        return ops.segsum_ones(code, ones, ds).to(self.dtype)

    def _code_tensor(self, code: Optional[np.ndarray],
                     n: int) -> torch.Tensor:
        """A host entity code (``None``: no kept attributes, all 0) as an
        ``int32`` tensor on the device."""
        return (torch.zeros(n, dtype=torch.int32, device=self.device)
                if code is None else self._upload(code))

    def _reduce_by_code(self, code_t: torch.Tensor, ds: int,
                        factors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``out[c, :] = sum_{i: code[i]=c} ⊗_f factors[f][i, :]`` —
        the root combine as one segment-sum (chunked when the Khatri-Rao
        expansion would not fit), as an ``exec.root`` span."""
        with self.tracer.span("exec.root") as sp:
            if self.tracer.enabled:
                sp.set(kernel="K2" if factors else "K1",
                       rows=int(code_t.shape[0]))
            if not factors:
                return self._ones_segment_sum(code_t, ds)
            if len(factors) == 1:
                return ops.segsum_rows(code_t, factors[0].contiguous(),
                                       ds).to(self.dtype).reshape(-1)
            return _kr_segment_sum(code_t, factors, ds,
                                   self.dtype).reshape(-1)

    def hist(self, db: RelationalDB, var: Var, attrs: Tuple[CtVar, ...],
             stats: Optional[CostStats] = None) -> CtTable:
        fs = FactorSpec(var, tuple(attrs))
        code, ds = self._entity_code(db, fs)
        n = db.entities[var.etype].size
        flat = self._reduce_by_code(self._code_tensor(code, n), ds, ())
        if not fs.attrs:
            return CtTable((), flat[0])
        return CtTable(fs.attrs, flat.reshape(tuple(v.card for v in fs.attrs)))

    def _root(self, dbs: Sequence[RelationalDB], owns: Sequence[FactorSpec],
              factors: Sequence[Tuple[torch.Tensor,
                                      List[Tuple[CtVar, ...]]]],
              keeps: Sequence[Sequence[CtVar]],
              stats: Sequence[Optional[CostStats]]) -> List[CtTable]:
        b = len(owns)
        n = dbs[0].entities[owns[0].var.etype].size
        codes = [self._entity_code(db, own) for db, own in zip(dbs, owns)]
        ds = codes[0][1]
        if b == 1:
            code_t = self._code_tensor(codes[0][0], n)
        else:   # plan i's root codes index the i-th of b code spaces
            code_t = self._upload(_end_to_end(
                [np.zeros(n, dtype=np.int32) if c is None else c
                 for c, _ in codes], ds))
        flat = self._reduce_by_code(code_t, b * ds, [m for m, _ in factors])
        mvars = [tuple(own.attrs) for own in owns]
        for _, vs in factors:
            mvars = [a + tuple(v) for a, v in zip(mvars, vs)]
        return [_finalise(row, mv, keep, st)
                for row, mv, keep, st in zip(_rows(flat, b), mvars, keeps,
                                             stats)]

    def _stack_space(self, db: RelationalDB, plan: ContractionPlan) -> int:
        def node(n: NodeSpec) -> int:
            spaces = [1]
            for h in n.hops:
                ds = h.child_node.own.card
                for cv in h.edge_attrs:
                    ds *= cv.card
                spaces += [db.entities[h.parent.etype].size * ds,
                           node(h.child_node)]
            return max(spaces)
        return max(plan.root.own.card, node(plan.root))


EXECUTORS = {"dense": DenseExecutor, "sparse": SparseExecutor}


def make_executor(name, **kw) -> Executor:
    """Resolve an executor by name (or pass an instance through).  Keyword
    arguments (``dtype``, ``mobius_fn``, ``device`` — ``None`` = the CUDA
    card) go to the executor's constructor."""
    if isinstance(name, Executor):
        return name
    return EXECUTORS[name.lower()](**kw)
