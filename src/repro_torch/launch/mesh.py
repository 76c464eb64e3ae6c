"""Local rank meshes, and the worker processes that serve a controller.

Defined as functions: importing this module starts no process and touches
no group.  The JAX package's ``make_production_mesh`` (a 256- or 512-chip
TPU pod) and its TPU v5e constants have no counterpart here.

Two kinds of mesh:

* :func:`make_local_mesh`, for sharded counting: a
  :class:`~torch.distributed.device_mesh.DeviceMesh` over the default
  group's ranks, made as a layout only.  Every collective of the port's
  sharded counting runs on the default group, driven by rank 0
  (:mod:`repro_torch.core.distributed`), so making it issues no collective
  and needs no other rank.
* :func:`make_train_mesh`, for training: every rank runs the same step on
  its own shards (SPMD), so each axis needs a process group of its own, and
  every rank of the default group must call it.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
from typing import List

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.device import resolve_device
from ..core.distributed import serve_ranks, stop_ranks
from ..parallel.mesh import Mesh


def make_local_mesh(model_axis: int = 1) -> DeviceMesh:
    """The default group's ranks as a ``(data, model)`` mesh of shape
    ``(world // model_axis, model_axis)``, rank-major (device type
    ``"cuda"`` where a card is available: a label, since the mesh holds no
    group of its own).

    Args:
        model_axis: ranks along ``model``; must divide the world size.

    Raises:
        RuntimeError: no default group is initialised.
        ValueError: ``model_axis`` does not divide the world size.

    Usage::

        mesh = make_local_mesh()            # (world, 1)
        mesh = make_local_mesh(2)           # (world // 2, 2)
    """
    if not dist.is_initialized():
        raise RuntimeError("initialise the default group first "
                           "(torch.distributed.init_process_group)")
    world = dist.get_world_size()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    return DeviceMesh("cuda" if torch.cuda.is_available() else "cpu",
                      torch.arange(world).reshape(world // model_axis,
                                                  model_axis),
                      mesh_dim_names=("data", "model"), _init_backend=False)


def make_train_mesh(model_axis: int = 1, device=None) -> Mesh:
    """The default group's ranks as a ``(data, model)`` training mesh of
    shape ``(world // model_axis, model_axis)``, rank-major as
    :func:`make_local_mesh`, with a new process group (the default
    group's backend) for each data column and each model row.  A
    collective: every rank of the default group calls it, in the same
    order; no collective of training runs on the default group itself.

    Args:
        model_axis: ranks along ``model``; must divide the world size.
        device: where this rank's shards live (``None``: the CUDA card).

    Raises:
        RuntimeError: no default group is initialised.
        ValueError: ``model_axis`` does not divide the world size.
    """
    if not dist.is_initialized():
        raise RuntimeError("initialise the default group first "
                           "(torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if model_axis < 1 or world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world} ranks")
    n_data = world // model_axis
    layout = np.arange(world).reshape(n_data, model_axis)
    groups = {}
    for d in range(n_data):                       # every rank makes every
        g = dist.new_group(layout[d].tolist())    # group, in one order
        if d == rank // model_axis:
            groups["model"] = g
    for m in range(model_axis):
        g = dist.new_group(layout[:, m].tolist())
        if m == rank % model_axis:
            groups["data"] = g
    return Mesh({"data": n_data, "model": model_axis}, rank, groups,
                resolve_device(device))


def init_group(rank: int, world: int, init_file: str,
               backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Join the default group of ``world`` ranks that meet at the
    :class:`~torch.distributed.FileStore` ``init_file`` (no TCP port); a
    collective that waits longer than ``timeout_s`` raises."""
    dist.init_process_group(
        backend, store=dist.FileStore(init_file, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))


def serve_main(rank: int, world: int, init_file: str, backend: str,
               device: str, timeout_s: float) -> None:
    """A worker process's body: join the group, serve rank 0's steps until
    it stops them, leave the group."""
    if device == "cpu":
        torch.set_num_threads(1)
    init_group(rank, world, init_file, backend, timeout_s)
    try:
        serve_ranks(make_local_mesh(), device)
    finally:
        dist.destroy_process_group()


def spawn_ranks(world: int, init_file: str, device, backend: str = "gloo",
                timeout_s: float = 300.0, target=serve_main
                ) -> List[multiprocessing.process.BaseProcess]:
    """Start ranks ``1 .. world-1`` as worker processes (``spawn``, never
    ``fork`` with CUDA live), each running ``target(rank, world, init_file,
    backend, device, timeout_s)``; the caller joins the group as rank 0
    with :func:`init_group`.  Workers counting on the host run with one
    thread each (``OMP_NUM_THREADS=1``).

    Usage::

        procs = spawn_ranks(4, str(tmp / "group"), "cpu")
        init_group(0, 4, str(tmp / "group"))
        ...
        stop_spawned(procs, "cpu")
    """
    device = str(resolve_device(device))
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, daemon=True,
                         args=(r, world, init_file, backend, device,
                               timeout_s))
             for r in range(1, world)]
    prev = os.environ.get("OMP_NUM_THREADS")
    if device == "cpu":
        os.environ["OMP_NUM_THREADS"] = "1"
    try:
        for p in procs:
            p.start()
    finally:
        if device == "cpu":
            if prev is None:
                os.environ.pop("OMP_NUM_THREADS", None)
            else:
                os.environ["OMP_NUM_THREADS"] = prev
    return procs


def stop_spawned(procs, device, timeout_s: float = 60.0) -> List[int]:
    """Stop the workers' loops, wait for them, leave the group (rank 0).

    Returns:
        The workers' exit codes.

    Raises:
        RuntimeError: a worker exited with another code than 0 or did not
            exit within ``timeout_s`` (it is then killed).
    """
    try:
        stop_ranks(device)
    finally:
        codes = []
        for p in procs:
            p.join(timeout_s)
            if p.is_alive():
                p.kill()
                p.join(timeout_s)
            codes.append(p.exitcode)
        if dist.is_initialized():
            dist.destroy_process_group()
    if any(code != 0 for code in codes):
        raise RuntimeError(f"worker exit codes {codes}")
    return codes
