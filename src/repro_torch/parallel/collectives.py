"""The collectives of multi-rank training, their autograd pairs, and the
staging of a card tensor through the host that every collective of the
port shares.

Every training collective here runs on one axis's process group of a
:class:`~repro_torch.parallel.mesh.Mesh` (never the default group), and is
the identity on a group of one rank.  Where a tensor goes for a
collective is :func:`stage_device`'s answer: a card tensor under gloo goes
to a pinned host buffer (:func:`staged`, :func:`buffer`), the collective
runs on the host and the result comes back to the card (gloo's CUDA
support is partial and differs by collective; one path for all of them
keeps the ranks' behaviour alike); under NCCL it would stay on the card.
:data:`STAGED` counts the bytes moved each way.  A backend that cannot run
a collective raises: nothing swaps one backend for another.  The sharded
counting of :mod:`repro_torch.core.distributed` stages its tensors with
the same three helpers.

The autograd pairs are Megatron's:

* :func:`gather` — all-gather along a dim; the backward reduce-scatters
  (``sum``: the gathered tensor is used differently on each rank, as an
  FSDP weight is) or keeps this rank's slice (``split``: the ranks use it
  alike, so their gradients are equal).
* :func:`split` — this rank's slice along a dim; the backward all-gathers.
* :func:`reduce` — all-reduce (a sum of partial products); the backward
  is the identity.
* :func:`copy_to` — the identity; the backward all-reduces (the input of a
  column-parallel product, whose gradient each rank holds a part of).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict

import torch
import torch.distributed as dist

#: the collectives run (``calls``), the host seconds spent in them,
#: staging included (``seconds``), and the bytes moved between a card and
#: the host for gloo (``to_host``, ``to_card``)
STAGED: Dict[str, float] = {"to_host": 0, "to_card": 0, "calls": 0,
                            "seconds": 0.0}
_LOCK = threading.Lock()


def reset_staged() -> None:
    with _LOCK:
        for k in STAGED:
            STAGED[k] = 0.0 if k == "seconds" else 0


def _count(key: str, n: float) -> None:
    with _LOCK:
        STAGED[key] += n


# ------------------------------------------------------------- staging ---

def stage_device(device: torch.device, group=None) -> torch.device:
    """Where a collective on ``group`` (``None``: the default group) reads
    and writes a tensor of ``device``: ``device`` under NCCL, the host
    under any other backend (gloo takes no CUDA tensor for ``scatter`` or
    ``reduce``, among others)."""
    return device if dist.get_backend(group) == "nccl" \
        else torch.device("cpu")


def staged(t: torch.Tensor, stage: torch.device) -> torch.Tensor:
    """``t`` contiguous on ``stage``: a pinned host copy of a card tensor."""
    if t.device == stage:
        return t.contiguous()
    out = torch.empty(tuple(t.shape), dtype=t.dtype, device=stage,
                      pin_memory=stage.type == "cpu" and t.is_cuda)
    out.copy_(t)
    return out


def buffer(shape, dtype, stage: torch.device,
           device: torch.device) -> torch.Tensor:
    """A receive buffer on ``stage`` (pinned when the rank computes on a
    card and stages on the host)."""
    return torch.empty(tuple(shape), dtype=dtype, device=stage,
                       pin_memory=stage.type == "cpu"
                       and device.type == "cuda")


def _stage_in(x: torch.Tensor, stage: torch.device) -> torch.Tensor:
    """:func:`staged`, counting the bytes a card tensor moves to the
    host."""
    out = staged(x, stage)
    if out.device != x.device:
        _count("to_host", out.numel() * out.element_size())
    return out


def _stage_out(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result back on ``like``'s device, counted."""
    if t.device == like.device:
        return t
    _count("to_card", t.numel() * t.element_size())
    return t.to(like.device, non_blocking=True)


@contextmanager
def _timed(x: torch.Tensor, stage: torch.device):
    """Counts one collective and the host seconds it took.  A card tensor
    that goes through the host waits for the card's queued work first
    (its copy to the host would), outside the count: the seconds are the
    collective's and its copies', not the work before it."""
    if x.is_cuda and stage.type == "cpu":
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _LOCK:
            STAGED["calls"] += 1
            STAGED["seconds"] += time.perf_counter() - t0


# the names of the tensor collectives in this torch (newer releases rename
# them to ``*_single``)
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` (``sum`` or ``max``) over the group's ranks,
    as a new tensor."""
    x = x.detach()              # no gradient here: the pairs below take it
    if _size(group) == 1:
        return x.clone()
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    stage = stage_device(x.device, group)
    with _timed(x, stage):
        buf = _stage_in(x, stage)
        if buf is x:
            buf = x.clone()
        dist.all_reduce(buf, op=red, group=group)
        return _stage_out(buf, x)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors concatenated along ``dim`` in rank order."""
    x = x.detach()              # no gradient here: the pairs below take it
    n = _size(group)
    if n == 1:
        return x
    stage = stage_device(x.device, group)
    with _timed(x, stage):
        buf = _stage_in(x.movedim(dim, 0), stage)
        out = buffer((n * buf.shape[0],) + tuple(buf.shape[1:]), buf.dtype,
                     stage, x.device)
        _ALL_GATHER(out, buf, group=group)
        return _stage_out(out, x).movedim(0, dim).contiguous()


def reduce_scatter(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' tensors summed, and this rank's slice of the sum along
    ``dim``."""
    x = x.detach()              # no gradient here: the pairs below take it
    n = _size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    stage = stage_device(x.device, group)
    with _timed(x, stage):
        buf = _stage_in(x.movedim(dim, 0), stage)
        out = buffer((buf.shape[0] // n,) + tuple(buf.shape[1:]), buf.dtype,
                     stage, x.device)
        _REDUCE_SCATTER(out, buf, group=group)
        return _stage_out(out, x).movedim(0, dim).contiguous()


def take(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (no communication)."""
    n = _size(group)
    if n == 1:
        return x
    size = x.shape[dim] // n
    if size * n != x.shape[dim]:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    return x.narrow(dim, dist.get_rank(group) * size, size).contiguous()


# ----------------------------------------------------------- autograd ---

class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, backward):
        ctx.dim, ctx.group, ctx.backward = dim, group, backward
        return all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.backward == "sum":
            return reduce_scatter(g, ctx.dim, ctx.group), None, None, None
        return take(g, ctx.dim, ctx.group), None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return take(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.dim, ctx.group), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def gather(x: torch.Tensor, dim: int, group,
           backward: str = "sum") -> torch.Tensor:
    """All-gather along ``dim``; backward ``"sum"`` (reduce-scatter) or
    ``"split"`` (this rank's slice)."""
    if _size(group) == 1:
        return x
    if backward not in ("sum", "split"):
        raise ValueError(backward)
    return _Gather.apply(x, dim, group, backward)


def split(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """This rank's slice along ``dim``; the backward all-gathers."""
    if _size(group) == 1:
        return x
    return _Split.apply(x, dim, group)


def reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over the group; the backward is the identity."""
    if _size(group) == 1:
        return x
    return _Reduce.apply(x, group)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the backward sums the gradient over the group."""
    if _size(group) == 1:
        return x
    return _CopyTo.apply(x, group)
