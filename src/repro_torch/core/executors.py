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
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..kernels import ops
from ..obs.profile import annotate
from ..obs.trace import NULL_TRACER
from .contract import CostStats, _khatri_rao_reduce, _onehot
from .ct import CtTable
from .database import RelationalDB
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
        with self.tracer.span("exec.mobius_batch", stacks=b, k=k), \
                annotate("exec.mobius_batch"):
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
        with self.tracer.span("exec.mobius_batch_fused", stacks=b, k=k), \
                annotate("exec.mobius_batch_fused"):
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

    # -- positive phase -----------------------------------------------------
    def positive(self, db: RelationalDB, plan: ContractionPlan,
                 stats: Optional[CostStats] = None) -> CtTable:
        """Evaluate a compiled plan: one message per root hop, then the
        root combine.  Backends only implement the two primitives."""
        factors = [self.hop_message(db, hop, stats) for hop in plan.root.hops]
        return self.root_reduce(db, plan.root.own, factors, plan.keep, stats)

    def hop_message(self, db: RelationalDB, hop: HopSpec,
                    stats: Optional[CostStats] = None
                    ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        """Full message matrix ``(n_parent, D)`` of one root-adjacent hop,
        including the child's entire subtree."""
        raise NotImplementedError

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
        raise NotImplementedError


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
# dense executor (one-hot contraction)
# ---------------------------------------------------------------------------

class DenseExecutor(Executor):
    name = "dense"

    def _entity_factor(self, db: RelationalDB, fs: FactorSpec
                       ) -> Tuple[torch.Tensor, List[CtVar]]:
        tab = db.entities[fs.var.etype]
        msg = torch.ones((tab.size, 1), dtype=self.dtype, device=self.device)
        mvars: List[CtVar] = []
        for cv in fs.attrs:
            hot = _onehot(_host_to(tab.attrs[cv.owner[1]], self.device),
                          cv.card, self.dtype)
            n, d = msg.shape
            msg = (msg[:, :, None] * hot[:, None, :]).reshape(n, d * cv.card)
            mvars.append(cv)
        return msg, mvars

    def _hop(self, db: RelationalDB, hop: HopSpec, child_msg: torch.Tensor,
             child_vars: List[CtVar], stats: Optional[CostStats]
             ) -> Tuple[torch.Tensor, List[CtVar]]:
        rt, gather_idx, scatter_idx, n_parent = _hop_indices(
            db, hop.atom, hop.child, hop.parent)
        m = child_msg[_host_to(gather_idx, self.device).long()]   # (edges, D)
        mvars = list(child_vars)
        for cv in hop.edge_attrs:
            hot = _onehot(_host_to(rt.attrs[cv.owner[1]], self.device),
                          cv.card, self.dtype)            # card+1, NA empty
            n, d = m.shape
            m = (m[:, :, None] * hot[:, None, :]).reshape(n, d * cv.card)
            mvars.append(cv)
        out = ops.segsum_rows(_host_to(scatter_idx, self.device),
                              m.contiguous(), n_parent).to(self.dtype)
        if stats is not None:
            stats.joins += 1
            stats.rows_scanned += int(gather_idx.shape[0])
        return out, mvars

    def _node_message(self, db: RelationalDB, node: NodeSpec,
                      stats: Optional[CostStats]
                      ) -> Tuple[torch.Tensor, List[CtVar]]:
        msg, mvars = self._entity_factor(db, node.own)
        for hop in node.hops:
            child_msg, child_vars = self._node_message(db, hop.child_node,
                                                       stats)
            h, hvars = self._hop(db, hop, child_msg, child_vars, stats)
            n, d = msg.shape
            msg = (msg[:, :, None] * h[:, None, :]).reshape(n, d * h.shape[1])
            mvars = mvars + hvars
        return msg, mvars

    def hop_message(self, db: RelationalDB, hop: HopSpec,
                    stats: Optional[CostStats] = None
                    ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        child_msg, child_vars = self._node_message(db, hop.child_node, stats)
        m, mvars = self._hop(db, hop, child_msg, child_vars, stats)
        return m, tuple(mvars)

    def hist(self, db: RelationalDB, var: Var, attrs: Tuple[CtVar, ...],
             stats: Optional[CostStats] = None) -> CtTable:
        msg, mvars = self._entity_factor(db, FactorSpec(var, tuple(attrs)))
        flat = torch.sum(msg, dim=0)
        counts = flat.reshape(tuple(v.card for v in mvars)) if mvars \
            else flat[0]
        return CtTable(tuple(mvars), counts)

    def root_reduce(self, db: RelationalDB, own: FactorSpec,
                    factors: Sequence[Tuple[torch.Tensor, Tuple[CtVar, ...]]],
                    keep: Sequence[CtVar],
                    stats: Optional[CostStats] = None) -> CtTable:
        fs: List[Tuple[torch.Tensor, List[CtVar]]] = [
            self._entity_factor(db, own)]
        fs.extend((m, list(vs)) for m, vs in factors)
        flat, mvars = _khatri_rao_reduce(fs)
        return _finalise(flat, mvars, keep, stats)


# ---------------------------------------------------------------------------
# sparse executor (int32 codes + segment sums over edge lists)
# ---------------------------------------------------------------------------

class _SparseMsg:
    """Per-entity message: a mixed-radix scalar code over ``svars`` (one
    value per entity — exact, no one-hot) plus an optional dense block over
    ``dvars`` (present only after an aggregation made the distribution
    genuinely multi-valued)."""

    __slots__ = ("code", "ds", "svars", "dense", "dvars")

    def __init__(self, code, ds, svars, dense, dvars):
        self.code, self.ds, self.svars = code, ds, svars
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

    def _hop(self, db: RelationalDB, hop: HopSpec, msg: _SparseMsg,
             stats: Optional[CostStats]
             ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        """Push a child message through one relationship.  Scalar-coded axes
        travel as index arithmetic inside the segment ids; only genuinely
        dense axes (from deeper aggregations) are carried as row vectors."""
        rt, gather_idx, scatter_idx, n_parent = _hop_indices(
            db, hop.atom, hop.child, hop.parent)
        gather_np = np.asarray(gather_idx)
        n_edges = int(gather_np.shape[0])

        # per-edge scalar code: child code gathered at the child end of the
        # edge, extended with this relationship's kept edge attributes
        ds = msg.ds
        if msg.code is not None:
            ecode = msg.code[gather_np].astype(np.int64)
        else:
            ecode = np.zeros(n_edges, dtype=np.int64)
        svars = tuple(msg.svars)
        for cv in hop.edge_attrs:
            ecode = ecode * cv.card + np.asarray(
                rt.attrs[cv.owner[1]]).astype(np.int64)
            ds *= cv.card
            svars = svars + (cv,)

        total = n_parent * ds
        if total > _INT32_LIMIT:
            raise OverflowError(
                f"sparse hop segment space {total} exceeds int32; use the "
                f"dense executor or reduce kept axes")
        seg_np = (np.asarray(scatter_idx).astype(np.int64) * ds
                  + ecode).astype(np.int32)
        if msg.dense is None:
            flat = self._edge_segment_sum(seg_np, None, total)
            out = flat.reshape(n_parent, ds)
            out_vars = svars
        else:
            rows = msg.dense[_host_to(gather_np, self.device).long()]
            agg = self._edge_segment_sum(seg_np, rows, total)
            out = agg.reshape(n_parent, ds * msg.dense.shape[1])
            out_vars = svars + tuple(msg.dvars)
        if stats is not None:
            stats.joins += 1
            stats.rows_scanned += n_edges
        return out, out_vars

    def _edge_segment_sum(self, seg_np: np.ndarray,
                          rows: Optional[torch.Tensor],
                          total: int) -> torch.Tensor:
        """Device step of one sparse hop: scatter-add per-edge contributions
        into the flattened ``(parent, code)`` segment space.  ``rows`` is
        ``None`` for a leaf hop (each edge contributes 1, K1) or the
        gathered dense block ``(edges, Dd)`` (K2)."""
        seg = _host_to(seg_np, self.device)
        if rows is None:
            ones = torch.ones(seg.shape[0], dtype=torch.float32,
                              device=self.device)
            return ops.segsum_ones(seg, ones, total).to(self.dtype)
        return ops.segsum_rows(seg, rows.contiguous(), total).to(self.dtype)

    def _node_message(self, db: RelationalDB, node: NodeSpec,
                      stats: Optional[CostStats]) -> _SparseMsg:
        code, ds = self._entity_code(db, node.own)
        dense: Optional[torch.Tensor] = None
        dvars: Tuple[CtVar, ...] = ()
        for hop in node.hops:
            child = self._node_message(db, hop.child_node, stats)
            h, hvars = self._hop(db, hop, child, stats)
            if dense is None:
                dense, dvars = h, hvars
            else:
                n, d = dense.shape
                dense = (dense[:, :, None] * h[:, None, :]).reshape(
                    n, d * h.shape[1])
                dvars = dvars + hvars
        return _SparseMsg(code, ds, tuple(node.own.attrs), dense, dvars)

    def _ones_segment_sum(self, code: torch.Tensor, ds: int) -> torch.Tensor:
        """Segment sum of ones — the histogram primitive (K1)."""
        ones = torch.ones(code.shape[0], dtype=torch.float32,
                          device=self.device)
        return ops.segsum_ones(code, ones, ds).to(self.dtype)

    def _reduce_by_code(self, code: Optional[np.ndarray], ds: int, n: int,
                        factors: Sequence[torch.Tensor]) -> torch.Tensor:
        """``out[c, :] = sum_{i: code[i]=c} ⊗_f factors[f][i, :]`` —
        the root combine as one segment-sum (chunked when the Khatri-Rao
        expansion would not fit)."""
        code_t = (torch.zeros(n, dtype=torch.int32, device=self.device)
                  if code is None else _host_to(code, self.device))
        if not factors:
            return self._ones_segment_sum(code_t, ds)
        if len(factors) == 1:
            return ops.segsum_rows(code_t, factors[0].contiguous(),
                                   ds).to(self.dtype).reshape(-1)
        return _kr_segment_sum(code_t, factors, ds, self.dtype).reshape(-1)

    def hop_message(self, db: RelationalDB, hop: HopSpec,
                    stats: Optional[CostStats] = None
                    ) -> Tuple[torch.Tensor, Tuple[CtVar, ...]]:
        child = self._node_message(db, hop.child_node, stats)
        return self._hop(db, hop, child, stats)

    def hist(self, db: RelationalDB, var: Var, attrs: Tuple[CtVar, ...],
             stats: Optional[CostStats] = None) -> CtTable:
        fs = FactorSpec(var, tuple(attrs))
        code, ds = self._entity_code(db, fs)
        n = db.entities[var.etype].size
        flat = self._reduce_by_code(code, ds, n, ())
        if not fs.attrs:
            return CtTable((), flat[0])
        return CtTable(fs.attrs, flat.reshape(tuple(v.card for v in fs.attrs)))

    def root_reduce(self, db: RelationalDB, own: FactorSpec,
                    factors: Sequence[Tuple[torch.Tensor, Tuple[CtVar, ...]]],
                    keep: Sequence[CtVar],
                    stats: Optional[CostStats] = None) -> CtTable:
        code, ds = self._entity_code(db, own)
        n = db.entities[own.var.etype].size
        mvars: List[CtVar] = list(own.attrs)
        mats: List[torch.Tensor] = []
        for m, vs in factors:
            mats.append(m)
            mvars.extend(vs)
        flat = self._reduce_by_code(code, ds, n, mats)
        return _finalise(flat, mvars, keep, stats)


EXECUTORS = {"dense": DenseExecutor, "sparse": SparseExecutor}


def make_executor(name, **kw) -> Executor:
    """Resolve an executor by name (or pass an instance through).  Keyword
    arguments (``dtype``, ``mobius_fn``, ``device`` — ``None`` = the CUDA
    card) go to the executor's constructor."""
    if isinstance(name, Executor):
        return name
    return EXECUTORS[name.lower()](**kw)
