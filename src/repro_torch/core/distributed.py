"""Distributed relational counting over the ranks of a ``torch.distributed``
group.

Counting is linear in edge rows, so the JOIN sweep data-parallelises
perfectly: split every relationship's edge list over the ``data`` axis of a
mesh of ranks, run the hop's segment sum on each rank's rows, and sum the
per-rank partial tables with one reduction.  Entity-indexed messages stay
whole on each rank (they are small: n_entities x value-space); the value
space can be split over ``model`` for the dense hop and the Möbius
transform, which are elementwise across the attribute axes.

Two mesh-sharded counting paths live here, mirroring the two executors:

* :func:`sharded_positive_ct` — the dense one-hot path: the dense
  executor's plan walk, its hop step (K2) run over the ranks;
* :class:`ShardedSparseExecutor` — the O(nnz) path: a drop-in
  :class:`~repro_torch.core.executors.SparseExecutor` whose two device
  steps (the hop's scatter-add, the root combine) run over the ranks.  It
  walks :class:`~repro_torch.core.plan.ContractionPlan` unchanged, so every
  strategy, the Möbius join and the cache work over it as over any
  registered executor (``EXECUTORS["sparse_sharded"]``).

**One controller, as in JAX.**  The JAX package runs ``shard_map`` from a
single controller.  Here rank 0 is the controller: it runs the whole
program (search, services, router), and the ranks above 0 are workers that
loop in :func:`serve_ranks`.  A program where every rank ran the same code
would not issue its collectives in one order: the counting service's
dispatcher forms batches by timing, and a router runs one service thread
per shard.  So each sharded step, under one lock for the process's group
held from its header to its reduction:

1. broadcasts a fixed-size header from rank 0 (the step's kind, its
   integer parameters, the shapes and dtypes of its inputs);
2. scatters each rank its inputs (its contiguous slice of the padded rows);
3. runs the step on every rank's slice, on that rank's device (K1 or K2,
   K3 for the Möbius blocks);
4. sums the ranks' outputs with one reduction to rank 0, which takes the
   place of the ``psum``.

A worker only ever answers the header it receives, so the ranks' sequences
of collectives cannot differ.  Every step is linear in its inputs and zero
on zero inputs: padding rows (weight 0) and ranks with nothing to do (a
replica along an axis the step does not split, given zero inputs) add
exactly 0.  Counts are integers below 2^24, so the sharded tables equal the
single-device ones bit for bit.

All collectives run on the default group.  A mesh
(:class:`~torch.distributed.device_mesh.DeviceMesh`, e.g. from
:func:`repro_torch.launch.mesh.make_local_mesh`) is the layout of its
ranks: which split rows (``data``) and which split columns (``model``).
Under gloo, which takes no CUDA tensor for ``scatter`` or ``reduce``, the
collectives go through host buffers (pinned where a rank counts on a card);
under NCCL, through each rank's card.  Ranks that share one card use gloo:
NCCL refuses two ranks on one device.

This is the scale-out path for the paper's technique: the 15.8M-row Visual
Genome sweep becomes 15.8M / ranks rows a rank with one reduction a hop.
For partitioned *databases* (one service per shard) see
:mod:`repro_torch.core.database` (``ShardedDatabase``) and
:mod:`repro_torch.serve.router`; a router built with
``executor="sparse_sharded"`` runs one such executor per shard, all over the
one group.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..kernels import ops
from ..parallel.collectives import buffer, stage_device, staged
from .contract import CostStats
from .ct import CtTable
from .database import RelationalDB
from .device import resolve_device
from .executors import (EXECUTORS, DenseExecutor, SparseExecutor,
                        _kr_segment_sum, gather_hop)
from .plan import compile_plan
from .variables import CtVar, LatticePoint

_HEADER = 64                       # int64 slots of a step's header
_DTYPES = (torch.int32, torch.int64, torch.float32)
# step kinds; _STOP ends serve_ranks
(_STOP, _ONES, _ROWS, _KR, _DENSE_HOP, _MOBIUS, _COUNTS,
 _RESET) = range(8)

#: The process's group lock: a sharded step holds it from its header to its
#: reduction, so that steps from the controller's threads (a service's
#: dispatcher, a router's shard services, each with its own executor) never
#: interleave their collectives.
_GROUP_LOCK = threading.Lock()


def _pad_to(arr: np.ndarray, mult: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad axis 0 to a multiple of ``mult``; returns (padded, weight_mask)."""
    n = arr.shape[0]
    target = ((n + mult - 1) // mult) * mult
    pad = target - n
    w = np.ones(target, dtype=np.float32)
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
        w[n:] = 0.0
    return arr, w


def _split(t: torch.Tensor, n: int) -> List[torch.Tensor]:
    """``t`` (rows a multiple of ``n``) as ``n`` contiguous row slices."""
    return list(t.reshape((n, -1) + tuple(t.shape[1:])).unbind(0))


def _world() -> int:
    """Ranks of the default group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _axis_size(mesh, axis: str) -> int:
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")
    return int(mesh.mesh.shape[names.index(axis)])


def _roles(mesh, axes: Sequence[str]) -> List[Optional[Tuple[int, ...]]]:
    """Per rank of the default group, its coordinates along ``axes`` — the
    slice of rows (and block of columns) it takes — or ``None`` for a
    replica: a rank whose coordinate on any other axis is not 0 takes no
    part of the work (it is given zeros)."""
    names = tuple(mesh.mesh_dim_names)
    ranks = mesh.mesh
    if ranks.numel() != _world():
        raise ValueError(f"a mesh of {ranks.numel()} ranks over a group of "
                         f"{_world()}")
    roles: List[Optional[Tuple[int, ...]]] = [None] * ranks.numel()
    for coord in np.ndindex(*ranks.shape):
        if any(c for c, name in zip(coord, names) if name not in axes):
            continue
        roles[int(ranks[coord])] = tuple(coord[names.index(a)] for a in axes)
    return roles


# ---------------------------------------------------------------------------
# the steps: what every rank runs on its slice (``params`` are the header's
# integers, ``xs`` the rank's inputs on its device)
# ---------------------------------------------------------------------------

def _step_ones(params, xs, device) -> torch.Tensor:
    """K1: the leaf hop or the factor-free root reduce, masked weights."""
    (total,) = params
    seg, w = xs
    return ops.segsum_ones(seg, w, total)


def _step_rows(params, xs, device) -> torch.Tensor:
    """K2: the dense-message hop on zero-padded rows."""
    (total,) = params
    seg, rows = xs
    return ops.segsum_rows(seg, rows, total)


def _step_kr(params, xs, device) -> torch.Tensor:
    """The root combine: Khatri-Rao chunks of the factors, each a K2 call."""
    (ds,) = params
    code, *mats = xs
    return _kr_segment_sum(code, mats, ds, torch.float32)


def _place(block: torch.Tensor, index: int, n_blocks: int) -> torch.Tensor:
    """``block`` as columns ``index`` of ``n_blocks`` equal blocks of a
    zeroed table: the reduction sums disjoint blocks, so it also assembles
    the ranks' blocks of columns."""
    width = block.shape[-1]
    out = block.new_zeros(tuple(block.shape[:-1]) + (n_blocks * width,))
    out[..., index * width:(index + 1) * width] = block
    return out


def _step_dense_hop(params, xs, device) -> torch.Tensor:
    """The one-hot path's hop on a rank's rows and block of child columns:
    gather, mask, expand by the edge attributes' one-hots, K2."""
    total, n_blocks, *cards = params
    block, child, gidx, sidx, w, *cols = xs
    part = gather_hop(child, gidx, sidx, cols, cards, total, w)
    return _place(part, int(block[0]), n_blocks)


def _step_mobius(params, xs, device) -> torch.Tensor:
    """K3 on a rank's block of the flattened attribute axis."""
    (n_blocks,) = params
    block, x = xs
    return _place(ops.mobius(x), int(block[0]), n_blocks)


def _step_counts(params, xs, device) -> torch.Tensor:
    """The rank's kernel launch and plain-call counts, in its row."""
    (world,) = params
    out = torch.zeros((world, 2, len(ops.KERNELS)), dtype=torch.int64)
    out[dist.get_rank()] = torch.tensor(
        [[ops.LAUNCHES[k] for k in ops.KERNELS],
         [ops.PLAIN_CALLS[k] for k in ops.KERNELS]])
    return out.to(device)


def _step_reset(params, xs, device) -> torch.Tensor:
    ops.reset_counts()
    return torch.zeros(1, dtype=torch.int64, device=device)


_STEPS = {_ONES: _step_ones, _ROWS: _step_rows, _KR: _step_kr,
          _DENSE_HOP: _step_dense_hop, _MOBIUS: _step_mobius,
          _COUNTS: _step_counts, _RESET: _step_reset}


# ---------------------------------------------------------------------------
# the protocol: rank 0 drives, every other rank serves
# ---------------------------------------------------------------------------

def _header(op: int, params: Sequence[int],
            inputs: Sequence[torch.Tensor]) -> List[int]:
    h = [op, len(params), *map(int, params), len(inputs)]
    for t in inputs:
        h += [_DTYPES.index(t.dtype), t.dim(), *map(int, t.shape)]
    if len(h) > _HEADER:
        raise ValueError(f"a step of {len(inputs)} inputs does not fit the "
                         f"{_HEADER}-slot header")
    return h + [0] * (_HEADER - len(h))


def _parse(h: Sequence[int]):
    op, n = h[0], h[1]
    params, i = list(h[2:2 + n]), 2 + n
    specs = []
    for _ in range(h[i]):
        dt, nd = h[i + 1], h[i + 2]
        specs.append((_DTYPES[dt], tuple(h[i + 3:i + 3 + nd])))
        i += 2 + nd
    return op, params, specs


def _run(op: int, params: Sequence[int],
         per_rank: Sequence[Optional[Sequence[torch.Tensor]]],
         device: torch.device) -> Tuple[torch.Tensor, int, int]:
    """Drive one step from rank 0.  ``per_rank[r]`` is rank ``r``'s inputs
    (``None``: zeros shaped as the others'; every rank's inputs have equal
    shapes).  Returns the reduced output on ``device`` and the bytes
    scattered and reduced.

    A step that fails once its header is out leaves the workers inside
    its collectives, so it destroys the group: every later step raises
    here, and the workers' collectives fail, instead of pairing with the
    next step's.

    Raises:
        RuntimeError: called on a rank other than 0, with no group (none
            was made, or a failed step destroyed it), or the step failed.
    """
    if not dist.is_initialized():
        raise RuntimeError("a sharded step with no process group (none was "
                           "initialised, or a failed step destroyed it)")
    if dist.get_rank() != 0:
        raise RuntimeError("sharded steps are driven from rank 0; the other "
                           "ranks serve them (serve_ranks)")
    stage = stage_device(device)
    i0 = next(i for i, x in enumerate(per_rank) if x is not None)
    first = per_rank[i0]
    copies: Dict[int, torch.Tensor] = {}    # one staged copy a tensor: the
    for x in per_rank:                       # ranks of a column block share
        for t in x or ():
            if id(t) not in copies:
                copies[id(t)] = staged(t, stage)
    zeros = [torch.zeros_like(copies[id(t)]) for t in first]
    ins = [[copies[id(t)] for t in x] if x is not None else zeros
           for x in per_rank]
    header = torch.tensor(_header(op, params, first), dtype=torch.int64,
                          device=stage)
    n_in = sum(t.numel() * t.element_size() for x in ins for t in x)
    with _GROUP_LOCK:
        if not dist.is_initialized():      # destroyed while this one waited
            raise RuntimeError("a failed sharded step destroyed the group")
        try:
            dist.broadcast(header, 0)
            mine = []
            for i, t in enumerate(first):
                buf = buffer(tuple(t.shape), t.dtype, stage, device)
                dist.scatter(buf, [x[i] for x in ins], src=0)
                mine.append(buf.to(device))
            out = staged(_STEPS[op](params, mine, device), stage)
            dist.reduce(out, 0)
        except BaseException:
            dist.destroy_process_group()
            raise
    return out.to(device), n_in, out.numel() * out.element_size()


def serve_ranks(mesh=None, device=None) -> int:
    """A worker's loop (ranks above 0): receive a step's header and inputs
    from rank 0, run the step on this rank's slice on ``device``, join the
    reduction; until rank 0 sends the stop header (:func:`stop_ranks`).
    Holds no database.

    Args:
        mesh: the layout of the group's ranks (checked to cover the
            group); every step names its own roles, so it is not needed.
        device: where this rank counts (``None`` = the CUDA card).

    Returns:
        The number of steps served.

    Raises:
        RuntimeError: called on rank 0, or a collective failed (a rank
            left, the group's timeout passed).

    Usage::

        serve_ranks(make_local_mesh(), device="cuda:0")
    """
    device = resolve_device(device)
    if dist.get_rank() == 0:
        raise RuntimeError("rank 0 drives the steps; serve_ranks is for the "
                           "other ranks")
    if mesh is not None and mesh.mesh.numel() != _world():
        raise ValueError(f"a mesh of {mesh.mesh.numel()} ranks over a group "
                         f"of {_world()}")
    stage = stage_device(device)
    served = 0
    while True:
        header = torch.empty(_HEADER, dtype=torch.int64, device=stage)
        dist.broadcast(header, 0)
        op, params, specs = _parse(header.tolist())
        if op == _STOP:
            return served
        xs = []
        for dtype, shape in specs:
            buf = buffer(shape, dtype, stage, device)
            dist.scatter(buf, None, src=0)
            xs.append(buf.to(device))
        out = staged(_STEPS[op](params, xs, device), stage)
        dist.reduce(out, 0)
        served += 1


def stop_ranks(device=None) -> None:
    """End every worker's :func:`serve_ranks` loop (rank 0; ``device`` is
    rank 0's, for the header's staging under NCCL)."""
    if _world() == 1:
        return
    header = torch.tensor(_header(_STOP, (), ()), dtype=torch.int64,
                          device=stage_device(resolve_device(device)))
    with _GROUP_LOCK:
        dist.broadcast(header, 0)


def rank_counts(device=None) -> List[Dict[str, Dict[str, int]]]:
    """Every rank's kernel launch and plain-version call counts
    (``ops.LAUNCHES`` and ``ops.PLAIN_CALLS`` of each process), rank 0
    first."""
    world = _world()
    if world == 1:
        return [dict(launches=dict(ops.LAUNCHES),
                     plain_calls=dict(ops.PLAIN_CALLS))]
    out, _, _ = _run(_COUNTS, (world,), [[] for _ in range(world)],
                     resolve_device(device))
    return [dict(launches=dict(zip(ops.KERNELS, map(int, row[0]))),
                 plain_calls=dict(zip(ops.KERNELS, map(int, row[1]))))
            for row in out.cpu()]


def reset_rank_counts(device=None) -> None:
    """Set every rank's launch and plain-call counts to 0."""
    world = _world()
    if world == 1:
        ops.reset_counts()
        return
    _run(_RESET, (), [[] for _ in range(world)], resolve_device(device))


# ---------------------------------------------------------------------------
# the dense one-hot path over a mesh
# ---------------------------------------------------------------------------

class _MeshDenseExecutor(DenseExecutor):
    """:class:`~repro_torch.core.executors.DenseExecutor` whose hop step
    runs over a mesh: the edge rows (padded to a multiple of the ``axis``
    size, with a 0/1 weight mask) split over ``axis``, and, where the mesh
    has a ``model`` axis larger than 1 that divides the child's width, the
    child's columns in contiguous blocks over ``model`` (reduced over
    ``data``, assembled over ``model`` by the one reduction).  The plan
    walk and the chunked root combine are inherited."""

    def __init__(self, mesh, axis: str, dtype, device):
        super().__init__(dtype=dtype, device=device)
        self.mesh, self.axis = mesh, axis
        self.n_rows = _axis_size(mesh, axis)
        self.n_model = (_axis_size(mesh, "model")
                        if "model" in tuple(mesh.mesh_dim_names) else 1)

    def _hop_sum(self, gathers, scatters, cols, cards, child_msg, total):
        n = self.n_rows
        n_blocks = self.n_model if (self.n_model > 1 and child_msg.shape[1]
                                    % self.n_model == 0) else 1
        gidx, w = _pad_to(np.asarray(gathers, dtype=np.int32), n)
        rows = [_split(torch.from_numpy(a), n) for a in (
            gidx, _pad_to(np.asarray(scatters, dtype=np.int32), n)[0], w,
            *(_pad_to(np.asarray(c, dtype=np.int32), n)[0] for c in cols))]
        child = child_msg.float()
        width = child.shape[1] // n_blocks
        blocks = [child[:, b * width:(b + 1) * width].contiguous()
                  for b in range(n_blocks)]
        params = (total, n_blocks, *cards)
        roles = _roles(self.mesh, (self.axis, "model") if n_blocks > 1
                       else (self.axis,))
        per_rank = [None if role is None else
                    [torch.tensor([role[-1] if n_blocks > 1 else 0],
                                  dtype=torch.int64),
                     blocks[role[-1] if n_blocks > 1 else 0],
                     *(r[role[0]] for r in rows)]
                    for role in roles]
        if _world() == 1:                          # a mesh of one rank
            return _step_dense_hop(params, [t.to(self.device)
                                            for t in per_rank[0]],
                                   self.device)
        out, _, _ = _run(_DENSE_HOP, params, per_rank, self.device)
        return out


def sharded_positive_ct(db: RelationalDB, point: LatticePoint,
                        keep: Optional[Sequence[CtVar]] = None,
                        *, mesh, axis: str = "data",
                        dtype=torch.float32,
                        stats: Optional[CostStats] = None,
                        device=None) -> CtTable:
    """Positive ct-table (dense one-hot path) with edge tables split over
    ``axis`` of ``mesh``.

    Semantically identical to :func:`repro_torch.core.contract.positive_ct`
    (tested against it): the same plan on the dense executor, each tree
    hop one sharded step (local partial counts with K2, one reduction).
    When the mesh also has a ``model`` axis larger than 1 that divides a
    hop's child width, each ``model`` rank takes a contiguous block of the
    child's columns (and so of the hop's output columns): reduced over
    ``data``, assembled over ``model``.

    Args:
        db: the database to count over.
        point: lattice point (>= 1 relationship atom).
        keep: ct-table axes to keep; defaults to every entity/edge
            attribute of the point (no indicator axes — positives only).
        mesh: the rank layout (keyword-only), covering the default group.
        axis: mesh axis to split edge rows over.
        dtype: accumulation dtype of the counts.
        stats: optional :class:`~repro_torch.core.contract.CostStats` to
            record join/row accounting into.
        device: where rank 0 counts (``None`` = the CUDA card).

    Returns:
        The positive :class:`~repro_torch.core.ct.CtTable` over ``keep``.

    Raises:
        ValueError: ``axis`` is not an axis of ``mesh``.

    Usage::

        tab = sharded_positive_ct(db, point, mesh=mesh, axis="data")
    """
    plan = compile_plan(db.schema, point, keep)
    return _MeshDenseExecutor(mesh, axis, dtype, device).positive(db, plan,
                                                                  stats)


# ---------------------------------------------------------------------------
# sharded sparse executor: the O(nnz) path over the ranks
# ---------------------------------------------------------------------------

class ShardedSparseExecutor(SparseExecutor):
    """:class:`~repro_torch.core.executors.SparseExecutor` with its
    segment-sum device steps split over one mesh axis.

    The plan walk, the mixed-radix code arithmetic and the caching
    semantics are inherited unchanged; only the two device steps change:

    * **edge scatter-add** (:meth:`_edge_segment_sum`) — the hop's edge
      list (padded to a multiple of the rank count, with a 0/1 weight mask)
      is split over ``axis``; each rank scatters its contiguous slice into
      the full ``(parent, code)`` segment space (K1 with the mask as its
      weights for a leaf hop, K2 on zero-padded rows for a dense-message
      hop) and one SUM reduction merges them.  This is the Möbius-join
      parallelisation of Qian & Schulte: sufficient statistics are sums
      over data partitions.
    * **root combine** (:meth:`_reduce_by_code`) — entity rows (root codes
      and factor matrices) are split over ``axis`` the same way: K1 under
      the mask with no factors, the Khatri-Rao K2 chunks on zero-padded
      factor rows otherwise; one reduction of the ``(root_card, D)``
      partial tables merges them.  ``hist`` takes this path too.

    With one rank (``n_ranks == 1``), or inside :meth:`local_mode`, both are
    the inherited single-device steps, bit for bit.  With more, every batch
    path (``positive_batch``, ``positive_batch_multi``,
    ``positive_stacked_merged``, ``positive_fanout_merged``) runs plan by
    plan, so that each plan's steps are its own sequence of collectives:
    scaling out a *flood* of queries is the database-sharding router's job
    (:mod:`repro_torch.serve.router`), while this class scales out one
    large contraction.  The tables are equal either way.

    ``step_counts`` counts the sharded steps by key (kind, segment space,
    padded rows, widths); ``bytes_scattered`` and ``bytes_reduced`` the
    bytes they moved.

    Args:
        dtype / mobius_fn / device: as for
            :class:`~repro_torch.core.executors.Executor` (``device`` is
            rank 0's).
        mesh: the rank layout; defaults to a 1-D mesh named ``(axis,)``
            over the default group's ranks when one is initialised, and one
            rank otherwise.
        axis: mesh axis name to split edge/entity rows over.

    Raises:
        ValueError: ``axis`` is not an axis of ``mesh``.

    Usage::

        ex = ShardedSparseExecutor(mesh=make_local_mesh(), device="cuda:0")
        tab = CountingEngine(db, ex).contract(point, keep)
    """

    name = "sparse_sharded"

    def __init__(self, dtype=torch.float32, mobius_fn=None, device=None,
                 mesh=None, axis: str = "data"):
        super().__init__(dtype=dtype, mobius_fn=mobius_fn, device=device)
        if mesh is None and _world() > 1:
            mesh = DeviceMesh(self.device.type, torch.arange(_world()),
                              mesh_dim_names=(axis,), _init_backend=False)
        self.mesh, self.axis = mesh, axis
        self.n_ranks = 1 if mesh is None else _axis_size(mesh, axis)
        self._roles = _roles(mesh, (axis,)) if self.n_ranks > 1 else None
        self.step_counts: Dict[Tuple, int] = {}
        self.bytes_scattered = 0
        self.bytes_reduced = 0
        self._count_lock = threading.Lock()
        self._force_local = False      # see local_mode()

    @contextmanager
    def local_mode(self):
        """Run the device steps UNSHARDED inside this context.  The
        engine's delta count maintenance contracts a handful of delta
        edges per cached entry — padding those to the ranks and paying a
        reduction per hop costs more than the count itself, so the delta
        path drops to the inherited single-device segment sums (exact
        either way; counts are integers), and issues no collective.  Not
        re-entrant across threads: callers hold the service's execution
        fence."""
        prev, self._force_local = self._force_local, True
        try:
            yield self
        finally:
            self._force_local = prev

    def _local(self) -> bool:
        return self.n_ranks == 1 or self._force_local

    def _sharded(self, key: Tuple, op: int, params: Sequence[int],
                 slots: Sequence[Sequence[torch.Tensor]]) -> torch.Tensor:
        """One sharded step: slot ``i``'s inputs to the rank at coordinate
        ``i`` of ``axis``, zeros to replicas."""
        per_rank = [None if role is None else slots[role[0]]
                    for role in self._roles]
        out, n_in, n_out = _run(op, params, per_rank, self.device)
        with self._count_lock:
            self.step_counts[key] = self.step_counts.get(key, 0) + 1
            self.bytes_scattered += n_in
            self.bytes_reduced += n_out
        return out

    # -- device steps, sharded ----------------------------------------------
    def _edge_segment_sum(self, seg_np: np.ndarray,
                          rows: Optional[torch.Tensor],
                          total: int) -> torch.Tensor:
        if self._local():
            return super()._edge_segment_sum(seg_np, rows, total)
        n = self.n_ranks
        seg, w = _pad_to(seg_np, n)
        segs = _split(torch.from_numpy(seg), n)
        if rows is None:
            ws = _split(torch.from_numpy(w), n)
            out = self._sharded(("edge_ones", total, int(seg.shape[0])),
                                _ONES, (total,), list(zip(segs, ws)))
            return out.to(self.dtype)
        rows_p = F.pad(rows.float(), (0, 0, 0, seg.shape[0] - rows.shape[0]))
        out = self._sharded(("edge_dense", total, int(seg.shape[0]),
                             int(rows_p.shape[1])), _ROWS, (total,),
                            list(zip(segs, _split(rows_p, n))))
        return out.to(self.dtype)

    def _reduce_by_code(self, code_t: torch.Tensor, ds: int,
                        factors: Sequence[torch.Tensor]) -> torch.Tensor:
        if self._local():
            return super()._reduce_by_code(code_t, ds, factors)
        n = self.n_ranks
        code_p, w = _pad_to(code_t.cpu().numpy(), n)
        codes = _split(torch.from_numpy(code_p), n)
        n_pad = int(code_p.shape[0])
        if not factors:
            out = self._sharded(("reduce_ones", ds, n_pad), _ONES, (ds,),
                                list(zip(codes, _split(torch.from_numpy(w),
                                                       n))))
            return out.to(self.dtype)
        # no weight mask here: the factor rows are zero-padded, so padding
        # contributes nothing to segment 0
        mats = [_split(F.pad(f.float(), (0, 0, 0, n_pad - f.shape[0])), n)
                for f in factors]
        widths = tuple(int(m[0].shape[1]) for m in mats)
        out = self._sharded(("reduce_kr", ds, n_pad, widths), _KR, (ds,),
                            [[codes[r]] + [m[r] for m in mats]
                             for r in range(n)])
        return out.to(self.dtype).reshape(-1)

    # -- batching -----------------------------------------------------------
    def _batched(self, dbs, plans, stats, span: str) -> List[CtTable]:
        # stacking plans over the ranks is deliberately avoided: one plan's
        # steps are already split over them, and query-level fan-out belongs
        # to the serve router.  With one rank (or in local mode) nothing is
        # sharded, so the inherited stacked path keeps flood dispatch fast.
        if self._local():
            return super()._batched(dbs, plans, stats, span)
        out = []
        for db, plan, st in zip(dbs, plans, stats):
            with self.tracer.span(span, plans=1):
                out.append(self._evaluate([db], [plan], [st])[0])
        return out


EXECUTORS["sparse_sharded"] = ShardedSparseExecutor


def sharded_sparse_positive_ct(db: RelationalDB, point: LatticePoint,
                               keep: Optional[Sequence[CtVar]] = None,
                               *, mesh=None, axis: str = "data",
                               dtype=torch.float32,
                               stats: Optional[CostStats] = None,
                               device=None) -> CtTable:
    """Positive ct-table via the sparse O(nnz) path, edge lists split over
    ``axis`` of ``mesh``.

    Convenience wrapper: compiles the :class:`~repro_torch.core.plan
    .ContractionPlan` for ``(point, keep)`` and evaluates it with a
    :class:`ShardedSparseExecutor`.  Numerically identical to the
    single-device sparse executor (and to :func:`sharded_positive_ct`, the
    dense path).

    Args:
        db: the database to count over.
        point: lattice point (>= 1 relationship atom).
        keep: ct-table axes to keep; defaults to every entity/edge
            attribute of the point (no indicator axes — positives only).
        mesh / axis: the rank layout and the axis to split rows over;
            ``mesh=None`` is a 1-D mesh over the default group's ranks.
        dtype: accumulation dtype of the counts.
        stats: optional :class:`~repro_torch.core.contract.CostStats` to
            record join/row accounting into.
        device: where rank 0 counts (``None`` = the CUDA card).

    Returns:
        The positive :class:`~repro_torch.core.ct.CtTable` over ``keep``.

    Usage::

        tab = sharded_sparse_positive_ct(db, point, mesh=mesh)
    """
    from .plan import compile_plan_cached
    if keep is None:
        keep = point.all_ct_vars(db.schema, include_rind=False)
    ex = ShardedSparseExecutor(dtype=dtype, mesh=mesh, axis=axis,
                               device=device)
    plan = compile_plan_cached(db.schema, point, tuple(keep))
    return ex.positive(db, plan, stats)


def merge_stacked(stacked: torch.Tensor) -> torch.Tensor:
    """Sum of a ``(n_partials, ...)`` stack of same-shape count tables, in
    one stacked ``torch.sum``.

    The JAX package merges with a ``psum`` because there each partial lives
    on its own device.  Here one controller holds every partial on its own
    card, so the merge is that one sum and issues no collective (the
    router's :class:`~repro_torch.serve.batching.TableMerger` sums the same
    way).  Exact: counts are integers, so the bits are equal below 2^24.

    Usage::

        merged = merge_stacked(torch.stack([tab_a, tab_b]))
    """
    return torch.sum(stacked, dim=0)


def superset_mobius_sharded(stack: torch.Tensor, k: int, *, mesh,
                            axis: str = "model") -> torch.Tensor:
    """Möbius butterfly with the flattened attribute axis split over
    ``axis``: the transform is elementwise across attributes, so each rank
    runs K3 on its contiguous block and the blocks need nothing from each
    other; the reduction only assembles them.

    Args:
        stack: the butterfly input (float32); the leading ``k`` axes are
            the binary indicator axes, the rest is the attribute value
            space.
        k: number of leading indicator axes to transform over.
        mesh / axis: the rank layout and the axis to split attributes over.

    Returns:
        The transformed stack, same shape as ``stack``.

    Usage::

        neg = superset_mobius_sharded(stack, k, mesh=mesh, axis="model")
    """
    shape = tuple(stack.shape)
    d = int(np.prod(shape[k:], dtype=np.int64))
    x = stack.reshape(1, 1 << k, d).contiguous()
    n = _axis_size(mesh, axis)
    if n == 1:
        return ops.mobius(x).reshape(shape)
    width = -(-d // n)
    xp = F.pad(x, (0, n * width - d))
    roles = _roles(mesh, (axis,))
    per_rank = [None if role is None else
                [torch.tensor([role[0]], dtype=torch.int64),
                 xp[:, :, role[0] * width:(role[0] + 1) * width].contiguous()]
                for role in roles]
    out, _, _ = _run(_MOBIUS, (n,), per_rank, stack.device)
    return out[:, :, :d].reshape(shape)
